"""K3 (predict) and K5 (advect) on one NVIDIA GPU: each held bitwise
against its plain version, then timed, with the variants that isolate
what bounds K5.

    python3 scripts/k35_probe.py [--repo PATH] [--nx 255 511] [--reps 20]
        [--sass] [--out FILE]

On the gpu preset's grid at each --nx with seeded velocities and the
preset's cylinder masks: K3 (outputs NaN-filled before the launch; all
four bitwise equal to `predict_plain`, with the gpu preset's constants
and with a nonzero g_eff); K5's four branches through `advect` and
through four `advect_branch` launches at velocity scales 0 (every
departure point on its own cell: coalesced gathers), 0.5 (the main
path's sub-cell displacements) and 2.5 (clamped points), each field
bitwise equal to `advect_branch_plain` with the clamp counts equal. Then
CUDA-event times after warm-up, in the order K3, K5 (one launch), K5
(four launches), and where the checkout's K5 computes t with trunc, a
copy of csrc/advect.cu with the fmodf form of t built aside, then the
same again. --repo times another checkout's package (one whose
wrappers take the same arguments, such as the parent commit's) in this
process. Prints the card's name and power limit, the build's register
and spill lines, with --sass the SASS instruction counts of K3 and K5
(cuobjdump), and as the last line one JSON object of the results.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
ap.add_argument("--nx", type=int, nargs="+", default=[255, 511])
ap.add_argument("--reps", type=int, default=20)
ap.add_argument("--sass", action="store_true")
ap.add_argument("--out", default=None, help="also write the SASS here")
ARGS = ap.parse_args()
sys.path.insert(0, str(Path(ARGS.repo).resolve()))

import navierstokes3d_tpu_torch as nt  # noqa: E402
from navierstokes3d_tpu_torch.kernels import _build  # noqa: E402
from navierstokes3d_tpu_torch.kernels import advect as ka  # noqa: E402
from navierstokes3d_tpu_torch.kernels import fused_step as kf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
SCALES = (0.0, 0.5, 2.5)
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)([^;]*);")


def events_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


@contextlib.contextmanager
def nan_outputs():
    """New tensors from torch.empty / empty_like start as NaN, so an output
    cell a kernel leaves unwritten shows."""
    empty, empty_like = torch.empty, torch.empty_like

    def nan_empty(*a, **kw):
        t = empty(*a, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    def nan_empty_like(*a, **kw):
        t = empty_like(*a, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t
    torch.empty, torch.empty_like = nan_empty, nan_empty_like
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def bitwise(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def sass_counts(lib: Path) -> dict:
    """Per K3/K5/K6 function: its SASS instructions, its divisions (FCHK),
    and for K3 its plane loop (from the loop's first barrier to the branch
    back above it) with the loop's most frequent opcodes."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    if ARGS.out:
        Path(ARGS.out).write_text(sass)
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        if not any(k in name for k in ("predict", "advect")):
            continue
        ins = []
        for addr, op, rest in SASS_LINE.findall(fn):
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            ins.append((int(addr, 16), op.split(".")[0],
                        int(target.group(1), 16) if target else None))
        ops = collections.Counter(op for _, op, _ in ins)
        row = dict(instructions=len(ins), divisions=ops["FCHK"],
                   top=dict(ops.most_common(10)))
        bars = [i for i, (_, op, _) in enumerate(ins) if op == "BAR"]
        if "predict" in name and bars:
            back = [i for i, (_, op, tgt) in enumerate(ins)
                    if op == "BRA" and tgt is not None and tgt <= ins[bars[0]][0]]
            if back:
                loop = collections.Counter(op for _, op, _ in
                                           ins[bars[0]:max(back) + 1])
                row["plane_loop"] = sum(loop.values())
                row["plane_loop_divisions"] = loop["FCHK"]
                row["plane_loop_top"] = dict(loop.most_common(10))
        short = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_\d+(\w+?)E.*", r"\1", name)
        out[short] = row
        print(f"[sass] {name[:90]}: {row}")
    return out


# K5's fraction as the kernel computes it, and the fmodf form it replaced
TRUNC_FORM = "(dl - truncf(dl))"
FMOD_FORM = "fmodf(dl, 1.0f)"


def fmod_library() -> ctypes.CDLL | None:
    """A copy of csrc/advect.cu with t from fmodf instead of trunc, built
    into a library of its own; None where the checkout's source has no
    trunc form (an older kernel that computes t with fmodf)."""
    src = (_build.SRC_DIR / "advect.cu").read_text()
    if src.count(TRUNC_FORM) != 1:
        return None
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    patched, lib = tmp / "advect_fmod.cu", tmp / "libk5_fmod.so"
    patched.write_text(src.replace(TRUNC_FORM, FMOD_FORM))
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.SRC_DIR), "-shared", "-o", str(lib),
                    str(patched)], check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.ns3d_advect.argtypes = list(_build.SIGNATURES["ns3d_advect"])
    cdll.ns3d_advect.restype = ctypes.c_int
    return cdll


def probe(nx: int, fmod_lib) -> dict:
    gpu = nt.ChorinSolver(nt.preset_gpu(nx=nx, compat=False, dtype="float32"),
                          device="cuda")
    multi = nt.ChorinSolver(nt.preset_multi(nx=nx, compat=False,
                                            dtype="float32"), device="cuda")
    g, k, w = gpu.grid, gpu._consts, gpu.advect_k
    rng = np.random.default_rng(2029)

    def seeded(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                            device="cuda")
    vx = seeded(g.nx + 1, g.ny, g.nz, scale=0.5) + 1.0
    vy = seeded(g.nx, g.ny + 1, g.nz, scale=0.3)
    vz = seeded(g.nx, g.ny, g.nz + 1, scale=0.3)
    c = torch.tensor(rng.uniform(size=(g.nx, g.ny, g.nz)).astype(np.float32),
                     device="cuda")
    res = {"shape": [g.nx, g.ny, g.nz]}
    # K3, bitwise, under both presets' constants and masks and a nonzero
    # g_eff
    kg = k.__class__(**{**k.__dict__, "g_eff": gpu.cfg.physics.g or 9.81})
    for label, (masks, kk) in {"gpu": (gpu.masks, k),
                               "multi": (multi.masks, multi._consts),
                               "g_eff": (gpu.masks, kg)}.items():
        with nan_outputs():
            a = kf.predict(vx, vy, vz, masks, kk)
        b = kf.predict_plain(vx, vy, vz, masks, kk)
        torch.cuda.synchronize()
        if not all(bitwise(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"K3 at {nx} ({label}) differs from its plain "
                               "version")
        del a, b
    print(f"[k3] {nx}: vx*, vy*, vz* and divv bitwise equal to the plain "
          "version (gpu, multi, g_eff)", flush=True)
    # K5 at three velocity scales, bitwise and equal clamp counts
    clamped = {}
    for scale in SCALES:
        f = (vx * scale, vy * scale, vz * scale, c)
        with nan_outputs():
            a = ka.advect(*f, k, w)
        n4 = torch.zeros((1,), dtype=torch.int32, device="cuda")
        for name, fld, out in zip(ka.adv.BRANCHES, f, a[:4]):
            with nan_outputs():
                one = ka.advect_branch(name, fld, *f[:3], k, w, n4)
            ref, _ = ka.advect_branch_plain(name, fld, *f[:3], k, w)
            torch.cuda.synchronize()
            if not (bitwise(out, ref) and bitwise(one, ref)):
                raise RuntimeError(f"K5 {name} at {nx} (scale {scale}) "
                                   "differs from its plain version")
            del one, ref
        b = ka.advect(*f, k, w, plain=True)
        if not int(a[4].item()) == int(b[4].item()) == int(n4.item()):
            raise RuntimeError(f"K5 at {nx} (scale {scale}): clamp counts "
                               f"{int(a[4].item())}, {int(n4.item())}, plain "
                               f"{int(b[4].item())}")
        clamped[scale] = int(b[4].item())
        del a, b, f
    print(f"[k5] {nx}: four fields bitwise equal to the plain version, "
          f"clamp counts equal {clamped}", flush=True)
    res["clamped"] = clamped
    # times: K3; K5 by one launch and by four, at each scale; the fmodf form
    mask_bytes = sum(m.numel() for m in (gpu.masks.mask_vx, gpu.masks.mask_vy,
                                         gpu.masks.mask_vz))
    fields = 4 * (vx.numel() + vy.numel() + vz.numel()) + 4 * c.numel()
    res["k3_bound_ms"] = (2 * fields - 4 * c.numel() + mask_bytes
                          ) / HBM_BYTES_PER_S * 1e3
    res["k5_fused_bound_ms"] = 2 * fields / HBM_BYTES_PER_S * 1e3
    res["k5_branch_bounds_ms"] = (
        4 * (2 * vx.numel() + vy.numel() + vz.numel())
        + 4 * (vx.numel() + 2 * vy.numel() + vz.numel())
        + 4 * (vx.numel() + vy.numel() + 2 * vz.numel())
        + fields + 4 * c.numel()) / HBM_BYTES_PER_S * 1e3

    def k5_fmod(f):
        outs = [torch.empty_like(t) for t in f]
        n = torch.zeros((1,), dtype=torch.int32, device="cuda")
        f32 = lambda x: ctypes.c_float(float(np.float32(x)))  # noqa: E731
        rc = fmod_lib.ns3d_advect(
            15, *(t.data_ptr() for t in f), *(o.data_ptr() for o in outs),
            *(t.data_ptr() for t in f[:3]), n.data_ptr(), f32(k.dt),
            f32(k.dx), f32(k.dy), f32(k.dz), w, g.nx, g.ny, g.nz, 0,
            _build.stream_of(vx))
        _build.check(rc, "advect (fmodf form)")
        return outs
    for rnd in range(2):
        t = res.setdefault("runs", [])
        row = {"k3_ms": events_ms(lambda: kf.predict(vx, vy, vz, gpu.masks, k),
                                  ARGS.reps)}
        for scale in SCALES:
            f = (vx * scale, vy * scale, vz * scale, c)
            row[f"k5_one_launch_ms_{scale}"] = events_ms(
                lambda: ka.advect(*f, k, w), ARGS.reps)
            row[f"k5_four_launches_ms_{scale}"] = events_ms(
                lambda: [ka.advect_branch(n, a, *f[:3], k, w)
                         for n, a in zip(ka.adv.BRANCHES, f)], ARGS.reps)
            if fmod_lib is not None:
                if rnd == 0 and scale == SCALES[1]:
                    a, b = k5_fmod(f), ka.advect(*f, k, w)
                    torch.cuda.synchronize()
                    if not all(bitwise(x, y) for x, y in zip(a, b)):
                        raise RuntimeError("K5's fmodf form differs")
                row[f"k5_fmod_ms_{scale}"] = events_ms(lambda: k5_fmod(f),
                                                       ARGS.reps)
            del f
        t.append(row)
        print(f"[time] {nx} run {rnd + 1}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in row.items()), flush=True)
    res["best"] = {key: min(r[key] for r in res["runs"])
                   for key in res["runs"][0]}
    b = res["best"]
    print(f"[k3] {nx}: {b['k3_ms']:.4f} ms, {100 * res['k3_bound_ms'] / b['k3_ms']:.1f}% "
          f"of the {res['k3_bound_ms']:.4f} ms bound")
    s = f"k5_one_launch_ms_{SCALES[1]}"
    print(f"[k5] {nx}: four branches in one launch {b[s]:.4f} ms, "
          f"{100 * res['k5_branch_bounds_ms'] / b[s]:.1f}% of the four "
          f"per-branch bounds ({res['k5_branch_bounds_ms']:.4f} ms), "
          f"{100 * res['k5_fused_bound_ms'] / b[s]:.1f}% of the one-launch "
          f"bound ({res['k5_fused_bound_ms']:.4f} ms)")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("k35_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"[repo] {nt.__file__}")
    built = _build.build()
    entry = ""
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif ("predict" in entry or "advect" in entry) and (
                "registers" in line or "spill" in line):
            print(f"[build] {entry.split()[-3][:70]} {line.strip()}")
    out = {"device": smi, "repo": str(Path(ARGS.repo).resolve())}
    if ARGS.sass:
        out["sass"] = sass_counts(built.path)
    fmod_lib = fmod_library()
    for nx in ARGS.nx:
        out[str(nx)] = probe(nx, fmod_lib)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
