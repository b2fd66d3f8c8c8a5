"""What the kernel probes (scripts/kdist_probe.py, scripts/k6k10_probe.py)
share: a CUDA source of the checkout, patched, built into a library of its
own, and the kernel wrappers' launches routed to such a library."""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path


def build_aside(build, src_dir: Path, name: str,
                patches: dict | None = None) -> ctypes.CDLL:
    """Compile src_dir/name with the checkout's nvcc flags (`build` is its
    kernels/_build module) into a library in a temporary directory under
    its _build/, after replacing in each file of `patches` each (old, new)
    pair, whose old text must occur once. The library's `nvcc_log` holds
    the compiler's report."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, tmp / f.name)
    for fname, forms in (patches or {}).items():
        src = (tmp / fname).read_text()
        for old, new in forms:
            if src.count(old) != 1:
                raise RuntimeError(f"{fname}: the patch's form occurs "
                                   f"{src.count(old)} times")
            src = src.replace(old, new)
        (tmp / fname).write_text(src)
    lib = tmp / f"lib{Path(name).stem}_aside.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(tmp),
                           "-shared", "-o", str(lib), str(tmp / name)],
                          check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.nvcc_log = proc.stdout + proc.stderr
    return cdll


@contextlib.contextmanager
def library(build, cdll):
    """Route the wrappers' launches (through `build`.load) to `cdll`, a
    build of one source."""
    for fname, argtypes in build.SIGNATURES.items():
        if hasattr(cdll, fname):
            getattr(cdll, fname).argtypes = list(argtypes)
            getattr(cdll, fname).restype = ctypes.c_int
    load = build.load
    build.load = lambda: cdll
    try:
        yield
    finally:
        build.load = load
