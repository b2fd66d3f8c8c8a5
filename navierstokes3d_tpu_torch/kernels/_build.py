"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles the package's own CUDA sources, and nothing else, into ONE
shared library with a plain C interface, loaded with ctypes: one nvcc
process per source, all started together, then one link. The library
lands in the package's `_build/` directory (listed in .gitignore) under a
name keyed by a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import:
the first kernel launch calls `load()`, which builds if needed.

Set-up records (utils/profiling.py setup_span): `load` is
ns3d.setup.kernels, a compile in `build` ns3d.setup.kernels.build (also
counted in `builds` and `build_s`), and the first call in the process of
each C entry point ns3d.setup.launch (`Library`).

Flags: sm_90a (Hopper), and --fmad=false so that `a*b + c` is not
contracted into an FMA — the kernels then round exactly as the JAX
expressions and the plain PyTorch versions do, and K2's two_sum stays an
error-free transform (whether to allow FMAs elsewhere is a later,
measured decision).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..utils.profiling import setup_span

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # pr, pr_out, dpr, rhs, wyp, wym, wzp, wzm, inv_dx2, dtau, decay,
    # zero_grad_x, nx, ny, nz, err_bits (nullable), stream
    "ns3d_poisson_iter": (_P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F,
                          _I, _I, _I, _I, _P, _P),
    # hi, lo, hi_out, lo_out, dpr, rhs, wyp, wym, wzp, wzm, inv_dx2, dtau,
    # decay, zero_grad_x, nx, ny, nz, err_bits (nullable), stream
    "ns3d_poisson_iter_ext": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                              _F, _F, _I, _I, _I, _I, _P, _P),
    # pr, dpr, rhs, pr_out, dpr_out, wyp, wym, wzp, wzm, inv_dx2, dtau,
    # decay, zero_grad_x, nx, ny, nz, s, then the plan: uy, uz, tiles_y,
    # tiles_z, seg; err_bits (nullable), stream
    "ns3d_poisson_iter_sweeps": (*(_P,) * 9, _F, _F, _F, *(_I,) * 10, _P,
                                 _P),
    # pr, scratch, dpr, rhs, wyp, wym, wzp, wzm, inv_dx2, dtau, decay,
    # zero_grad_x, nx, ny, nz, the exit rule: it0, niter, nchk, eps,
    # scale, thresh, big, window; then the plan: blocks, the cut (y parts,
    # z parts), smem bytes; err_bits, checks (nullable), stream
    "ns3d_poisson_iter_resident": (*(_P,) * 8, _F, _F, _F, *(_I,) * 7,
                                   *(_F,) * 4, *(_I,) * 5, _P, _P, _P),
    # hi, lo, hi_scratch, lo_scratch, dpr, rhs, wyp, wym, wzp, wzm,
    # inv_dx2, dtau, decay, zero_grad_x, nx, ny, nz, nit, then the plan:
    # blocks, the cut (y parts, z parts), smem bytes; err_bits, stream
    "ns3d_poisson_iter_resident_ext": (*(_P,) * 10, _F, _F, _F,
                                       *(_I,) * 9, _P, _P),
    # pr, dpr, rhs, pr_out, dpr_out, xlo (nullable), xhi (nullable),
    # inv_dx2, inv_dy2, inv_dz2, dtau, decay, z_lo_add, z_hi_add,
    # zero_grad_x, nx, ny, nz, then the plan: tiles_y, tiles_z; stream
    "ns3d_poisson_iter_bc": (*(_P,) * 7, *(_F,) * 7, *(_I,) * 6, _P),
    # pr, pr_lo (nullable), pr_hi (nullable), dpr, rhs, pr_out, dpr_out,
    # xlo (nullable), xhi (nullable), inv_dx2, inv_dy2, inv_dz2, dtau,
    # decay, z_lo_add, z_hi_add, zero_grad_x, x_off, nx, bx, ny, nz, then
    # the plan: tiles_y, tiles_z; err_bits (nullable), stream
    "ns3d_poisson_iter_bc_dist": (*(_P,) * 9, *(_F,) * 7, *(_I,) * 8, _P,
                                  _P),
    # hi, hi_lo, hi_hi, lo, lo_lo, lo_hi (halo planes nullable), dpr, rhs,
    # hi_out, lo_out, dpr_out, xlo, xhi (nullable), inv_dx2, inv_dy2,
    # inv_dz2, dtau, decay, zlo_hi, zhi_hi, zlo_lo, zhi_lo, zero_grad_x,
    # x_off, nx, bx, ny, nz, then the plan: tiles_y, tiles_z; err_bits
    # (nullable), stream
    "ns3d_poisson_iter_ext_bc_dist": (*(_P,) * 13, *(_F,) * 9, *(_I,) * 8,
                                      _P, _P),
    # words (1 or 2), hi, lo (null for 1), rhs_hi, rhs_lo, their interior
    # strides (hi's x and y, lo's x and y), r (nullable for 2), the quad
    # rows qx, qy, qz, nx, ny, nz, err_bits, stream
    "ns3d_comp_residual": (_I, *(_P,) * 4, *(_I,) * 4, *(_P,) * 4,
                           *(_I,) * 3, _P, _P),
    # vx, vy, vz, mask_vx, mask_vy, mask_vz, vx_out, vy_out, vz_out,
    # divv, dx, dy, dz, mu, two_mu, three, dt_rho, rho_g, nx, ny, nz,
    # then the plan: tiles_y, tiles_z, seg; stream
    "ns3d_predict": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F,
                     _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P),
    # vx, vy, vz, pr, mask_vx, mask_vy, mask_vz, vx_out, vy_out, vz_out,
    # dx, dy, dz, minus_dt_rho, variant, vin, nx, ny, nz, stream
    "ns3d_correct": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F,
                     _F, _I, _F, _I, _I, _I, _P),
    # branch mask, a_vx, a_vy, a_vz, a_c, out_vx, out_vy, out_vz, out_c
    # (null outside the mask), a host array of 12 velocity pointers (K5:
    # the post-BC vx, vy, vz first; K6: each branch's three precomputed
    # advecting velocities, null outside the mask), n_clamped, dt, dx, dy,
    # dz, k, nx, ny, nz, pre (0: K5, 1: K6), stream
    "ns3d_advect": (ctypes.c_uint, *(_P,) * 10, _F, _F, _F, _F, _I, _I,
                    _I, _I, _I, _P),
}

# nvcc builds of the library in this process, and their seconds
builds = 0
build_s = 0.0


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put "
                           "nvcc on PATH) to build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@dataclasses.dataclass
class BuildResult:
    path: Path           # the keyed library
    compiled: bool       # False when an up-to-date library existed
    seconds: float       # nvcc wall time (0 when not compiled)
    log: str             # nvcc output: the per-kernel register report


def build() -> BuildResult:
    """Compile csrc/*.cu into the keyed library unless it exists: one nvcc
    per source in parallel into a private temporary directory, then one
    link, written under a temporary name and renamed, so a concurrent or
    interrupted build never leaves a partial file."""
    global builds, build_s
    key = build_key()
    lib = BUILD_DIR / f"libns3d_kernels_{key}.so"
    if lib.exists():
        return BuildResult(lib, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with setup_span("ns3d.setup.kernels.build"), \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", obj,
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc(), *ARCH, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(so, lib)
    seconds = time.perf_counter() - t0
    builds += 1
    build_s += seconds
    return BuildResult(lib, True, seconds, log + proc.stdout + proc.stderr)


class Library:
    """The bound kernel library: each C entry point of SIGNATURES an
    attribute, any other name the CDLL's. An entry point's first call in
    the process runs inside an ns3d.setup.launch span (`entry` its name),
    which then replaces the attribute with the ctypes function itself, so
    later launches pay nothing for it."""

    def __init__(self, cdll: ctypes.CDLL):
        self._cdll = cdll
        for name in SIGNATURES:
            setattr(self, name, self._first_call(name, getattr(cdll, name)))

    def _first_call(self, name: str, fn):
        def call(*args):
            setattr(self, name, fn)
            with setup_span("ns3d.setup.launch", entry=name):
                return fn(*args)
        return call

    def __getattr__(self, name: str):
        return getattr(self._cdll, name)


@functools.cache
def load() -> Library:
    """Build (if needed) and bind the kernel library, once per process."""
    with setup_span("ns3d.setup.kernels"):
        cdll = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return Library(cdll)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (the launch plans' wave size)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Validate a kernel operand before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")
