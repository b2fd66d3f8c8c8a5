"""K8 (s folded Poisson iterations per launch) on one NVIDIA GPU: the
wrapper's plan and any others, each held bitwise against s K1 launches,
then timed against K1 in the same process.

    python3 scripts/k8_probe.py [--nx 511] [--s 2 3] [--reps 20]
        [--plans UY,UZ,SEG ...] [--sass]

On the gpu preset's grid at --nx (511: 511x307x307, the wide grid) with
its operator and seeded inputs: K1 per launch, then K8 at each depth under
`sweep_plan` and under each --plans entry (tile rows and lanes, x
segment), by CUDA events over --reps launches after warm-up, in the
order K1, K8..., K8..., K1. Prints the card's name and power limit, K8's
register and spill report from the build, and per plan: ms per launch,
ms per iteration over K1's, the share of the bytes bound (5 x 4 B per cell
over 3.35 TB/s), and the plan; the last line is one JSON object of them.
With --sass, also the instruction counts of K8's plane loop.
"""

from __future__ import annotations

import argparse
import collections
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


def sass_counts(lib: Path) -> None:
    """Per K8 instantiation: its SASS instructions, those of its plane
    loop (from the loop's block barrier to the branch back above it) and
    that loop's most frequent opcodes."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    print_sass_counts(sass)


def print_sass_counts(sass: str) -> None:
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)([^;]*);")
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        if "poisson_sweeps_kernel" not in name:
            continue
        ins = []
        for addr, op, rest in line.findall(fn):
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            ins.append((int(addr, 16), op.split(".")[0],
                        int(target.group(1), 16) if target else None))
        bar = next(i for i, (_, op, _) in enumerate(ins) if op == "BAR")
        end = max(i for i, (_, op, tgt) in enumerate(ins)
                  if op == "BRA" and tgt is not None and tgt <= ins[bar][0])
        loop = collections.Counter(op for _, op, _ in ins[bar:end + 1])
        depth = re.search(r"kernelILi(\d)E", name)
        print(f"[sass] K8 s={depth.group(1) if depth else '?'}: {len(ins)} "
              f"instructions, plane loop {end + 1 - bar}: "
              f"{dict(loop.most_common(12))}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=511)
    ap.add_argument("--s", type=int, nargs="+", default=[3, 2])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plans", nargs="*", default=[],
                    help="UY,UZ,SEG of extra plans to time")
    ap.add_argument("--sass", action="store_true",
                    help="print K8's instruction counts (cuobjdump -sass)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    res = _build.build()
    entry = ""
    for line in res.log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "sweeps" in entry and ("registers" in line or "spill" in line):
            print(f"[build] {entry.split()[-3]} {line.strip()}")
    if args.sass:
        sass_counts(res.path)
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
    print(json.dumps({"device": smi, "shape": shape, "k1_ms": k1m,
                      "bound_ms": bound_ms, "k8": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
