"""K8 (s folded Poisson iterations per launch) on one NVIDIA GPU: the
wrapper's plan and any others, each held bitwise against s K1 launches,
then timed against K1 in the same process.

    python3 scripts/k8_probe.py [--nx 511] [--s 2 3] [--reps 20]
        [--plans UY,UZ,SEG ...] [--sass] [--cut]

On the gpu preset's grid at --nx (511: 511x307x307, the wide grid) with
its operator and seeded inputs: K1 per launch, then K8 at each depth under
`sweep_plan` and under each --plans entry (tile rows and lanes, x
segment), by CUDA events over --reps launches after warm-up, in the
order K1, K8..., K8..., K1. Prints the card's name and power limit, K8's
register and spill report from the build at each depth it instantiates
(s = 2, 3, 4), and per plan: ms per launch, ms per iteration over K1's,
the share of the bytes bound (5 x 4 B per cell over 3.35 TB/s), and the
plan; the last line is one JSON object of them. With --sass, also the
instructions of K8's plane loop at each depth: a thread's per plane and
per cell-level (its run of SWEEP_RUN cells at s levels), beside the float
arithmetic among them (FADD, FMUL, FFMA) and the most frequent opcodes.
With --cut, also K8 cut apart at the first depth (copies built aside,
their results not K8's): without its copies, without its writes out,
without both, and without its arithmetic; and scripts/copy_ceiling.cu
over the same bytes (half read, half written): what each part costs.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import navierstokes3d_tpu_torch as nt  # noqa: E402
from navierstokes3d_tpu_torch.kernels import _build  # noqa: E402
from navierstokes3d_tpu_torch.kernels import poisson as kp  # noqa: E402
from probe_lib import build_aside, library  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


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


def bitwise_k8(pr, dpr, rhs, op, plan) -> None:
    """K8 under `plan` against s K1 launches, NaN-filled outputs, with the
    check value; raises on any difference."""
    s = plan.s
    po, do = (torch.full_like(pr, float("nan")) for _ in range(2))
    ek = kp.launch_sweeps(pr, dpr, rhs, po, do, op, plan, True)
    p, d, e1 = pr.clone(), dpr.clone(), None
    for j in range(s):
        q = torch.empty_like(pr)
        e1 = kp.poisson_iter(p, q, d, rhs, op, j == s - 1)
        p = q
    torch.cuda.synchronize()
    if not (torch.equal(po.view(torch.int32), p.view(torch.int32))
            and torch.equal(do.view(torch.int32), d.view(torch.int32))
            and float(ek) == float(e1)):
        raise RuntimeError(f"K8 under {plan} differs from {s} K1 launches")


def sass_counts(lib: Path) -> dict:
    """Per K8 instantiation: its SASS instructions and those of its plane
    loop (from the loop's block barrier to the branch back above it)."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return print_sass_counts(sass)


FLOAT_ARITH = ("FADD", "FMUL", "FFMA")


def print_sass_counts(sass: str) -> dict:
    """Print and return, per depth s, the plane loop's instructions a
    thread and plane (the loop's length over its block barriers, one a
    plane), a cell-level (over SWEEP_RUN x s), the float arithmetic among
    them and the loop's most frequent opcodes."""
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)([^;]*);")
    rows = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        depth = re.search(r"poisson_sweeps_kernelILi(\d)E", name)
        if depth is None:
            continue
        s = int(depth.group(1))
        ins = []
        for addr, op, rest in line.findall(fn):
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            ins.append((int(addr, 16), op.split(".")[0],
                        int(target.group(1), 16) if target else None))
        bar = next(i for i, (_, op, _) in enumerate(ins) if op == "BAR")
        end = max(i for i, (_, op, tgt) in enumerate(ins)
                  if op == "BRA" and tgt is not None and tgt <= ins[bar][0])
        loop = collections.Counter(op for _, op, _ in ins[bar:end + 1])
        planes = loop["BAR"]
        per_plane = (end + 1 - bar) / planes
        flops = sum(loop[op] for op in FLOAT_ARITH) / planes
        cell_levels = kp.SWEEP_RUN * s
        rows[s] = dict(instructions=len(ins), plane_loop=end + 1 - bar,
                       planes_a_pass=planes, per_plane=per_plane,
                       per_cell_level=per_plane / cell_levels,
                       float_per_plane=flops,
                       float_per_cell_level=flops / cell_levels)
        print(f"[sass] K8 s={s}: {len(ins)} instructions; plane loop "
              f"{end + 1 - bar} for {planes} plane(s): {per_plane:.0f} a "
              f"thread and plane, {per_plane / cell_levels:.1f} a "
              f"cell-level ({kp.SWEEP_RUN} cells x {s} levels); float "
              f"arithmetic {flops:.0f} a plane, "
              f"{flops / cell_levels:.1f} a cell-level; "
              f"{dict(loop.most_common(14))}")
    return rows


def registers(log: str) -> dict:
    """ptxas's register and spill report for K8, per depth s."""
    out, depth = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"poisson_sweeps_kernelILi(\d)E", line)
            depth = int(m.group(1)) if m else None
        elif depth is not None and ("registers" in line or "spill" in line):
            out.setdefault(depth, []).append(line.split(":", 1)[-1].strip())
    return out


# K8 cut apart (--cut): each a list of (old, new) replacements in
# csrc/poisson.cu, whose old text must occur once
CUT_COPIES = ("  auto load = [&](int x, int slot) {\n",
              "  auto load = [&](int x, int slot) {\n    return;\n")
CUT_WRITES = ("    if (xs < xb || xs >= xe) return;\n", "    return;\n")
CUT_FORMS = {
    "no copies": [CUT_COPIES],
    "no writes out": [CUT_WRITES],
    "no copies, no writes out": [CUT_COPIES, CUT_WRITES],
    "no arithmetic": [("    for (int j = 1; j <= S; ++j) {\n"
                       "      const int x = t - j;",
                       "    for (int j = 1; j <= 0; ++j) {\n"
                       "      const int x = t - j;")],
}


def cut_apart(pr, dpr, rhs, op, plan, reps: int) -> dict:
    """K8 under `plan` with parts of its work cut out (CUT_FORMS), each
    built aside, and the copy ceiling of its bytes; ms per launch."""
    here = Path(__file__).resolve().parent
    out = {}
    po, do = torch.empty_like(pr), torch.empty_like(pr)
    for label, patch in CUT_FORMS.items():
        lib = build_aside(_build, _build.SRC_DIR, "poisson.cu",
                          {"poisson.cu": patch})
        with library(_build, lib):
            out[label] = min(events_ms(lambda: kp.launch_sweeps(
                pr, dpr, rhs, po, do, op, plan, False), reps)
                for _ in range(2))
        print(f"[k8 cut] s={plan.s} {label}: {out[label]:.4f} ms",
              flush=True)
    copy = build_aside(_build, here, "copy_ceiling.cu")
    copy.ns3d_copy_float4.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_long, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    nbytes = 5 * 4 * pr.numel()
    src = torch.empty(nbytes // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    stream = torch.cuda.current_stream().cuda_stream
    out["copy ceiling"] = min(events_ms(lambda: copy.ns3d_copy_float4(
        src.data_ptr(), dst.data_ptr(), src.numel() // 4, 4 * 132, 512,
        stream), reps) for _ in range(2))
    print(f"[k8 cut] copy of the same {nbytes / 1e6:.1f} MB (half read, "
          f"half written): {out['copy ceiling']:.4f} ms", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=511)
    ap.add_argument("--s", type=int, nargs="+", default=[3, 2])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plans", nargs="*", default=[],
                    help="UY,UZ,SEG of extra plans to time")
    ap.add_argument("--sass", action="store_true",
                    help="print K8's instruction counts (cuobjdump -sass)")
    ap.add_argument("--cut", action="store_true",
                    help="time K8 cut apart and the copy ceiling")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    res = _build.build()
    regs = registers(res.log)
    for s in sorted(regs):
        print(f"[build] K8 s={s}: {'; '.join(regs[s])}")
    sass = sass_counts(res.path) if args.sass else {}
    solver = nt.ChorinSolver(nt.preset_gpu(nx=args.nx, compat=False,
                                           dtype="float32"), device="cuda")
    g, op = solver.grid, solver._op
    shape = (g.nx, g.ny, g.nz)
    rng = np.random.default_rng(2026)

    def seeded(scale):
        return torch.tensor(rng.normal(size=shape).astype(np.float32)
                            * scale, device="cuda")
    pr = solver.set_bc_pr(seeded(50.0))
    rhs = seeded(1e5)
    dpr = torch.zeros_like(pr)
    dpr[1:-1, 1:-1, 1:-1] = seeded(1e3)[1:-1, 1:-1, 1:-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound_ms = 5 * 4 * pr.numel() / HBM_BYTES_PER_S * 1e3
    plans = []
    for s in args.s:
        plans.append(("sweep_plan", kp.sweep_plan(shape, s, sms)))
        for spec in args.plans:
            uy, uz, seg = map(int, spec.split(","))
            plans.append((spec, kp.SweepPlan(
                s, uy, uz, -(-g.ny // uy), -(-g.nz // uz), seg,
                -(-g.nx // seg))))
    for _, plan in plans:
        bitwise_k8(pr, dpr, rhs, op, plan)
    print(f"[k8] {len(plans)} plans bitwise equal to s K1 launches, check "
          f"value equal, at {shape[0]}x{shape[1]}x{shape[2]}")
    pa, da = torch.empty_like(pr), dpr.clone()
    po, do = torch.empty_like(pr), torch.empty_like(pr)

    def k1():
        kp.poisson_iter(pr, pa, da, rhs, op, False)
    k1_ms = [events_ms(k1, args.reps)]
    rows = []
    for label, plan in plans:
        ms = [events_ms(lambda: kp.launch_sweeps(
            pr, dpr, rhs, po, do, op, plan, False), args.reps)
            for _ in range(2)]
        rows.append(dict(label=label, s=plan.s, ms=min(ms), ms_both=ms,
                         plan=plan.__dict__, blocks=plan.blocks,
                         smem=plan.smem_bytes))
    k1_ms.append(events_ms(k1, args.reps))
    k1m = min(k1_ms)
    print(f"[k8] K1 {k1m:.4f} ms per launch (runs {k1_ms}); bytes bound "
          f"{bound_ms:.4f} ms ({smi})")
    for r in rows:
        r["per_iteration_over_k1"] = r["ms"] / r["s"] / k1m
        r["bound_share"] = bound_ms / r["ms"]
        print(f"[k8] s={r['s']} {r['label']}: {r['ms']:.4f} ms "
              f"({r['ms_both']}), {r['ms'] / r['s']:.4f} ms per iteration = "
              f"{r['per_iteration_over_k1']:.3f} x K1, "
              f"{100 * r['bound_share']:.1f}% of the bound; {r['blocks']} "
              f"blocks, {r['smem']} B shared; {r['plan']}")
    cut = (cut_apart(pr, dpr, rhs, op, plans[0][1], args.reps)
           if args.cut else {})
    print(json.dumps({"device": smi, "shape": shape, "k1_ms": k1m,
                      "bound_ms": bound_ms, "k8": rows, "ptxas": regs,
                      "sass": sass, "cut": cut}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
