"""K12 on one NVIDIA GPU: nit of K2's (hi, lo) iterations in one resident
launch, against nit K2 launches.

    python3 scripts/k12_probe.py [--reps 5] [--rounds 2] [--forms]

On seeded inputs (chip_smoke.py's resident_inputs for hi, dpr and rhs; lo
randn x 2**-24), with the multi preset's operator, at 63x38x38 (nit 37)
and 255x153x153 (nit 152):
  1. K12 under resident_plan's plan, held bitwise against nit K2 launches
     and against its plain version first; its device time at nit and at
     nit 1 and the time per added iteration; the nit K2 launches' device
     time; K12's bound (20 B a cell and iteration at the HBM rate) and its
     share of it; a `digest` of hi, lo, dpr and the check value (two
     checkouts' digests are equal when their launches are bitwise equal);
  2. with --forms, at 255: copies of csrc/poisson.cu whose K12 takes 512,
     768 or 1024 threads a block (kResidentExtThreads) and issues the
     loads of 1, 2 or 3 planes before their arithmetic
     (kResidentExtUnroll), built aside in parallel (each build's
     registers and spills printed), each held bitwise against the
     checkout's K12, then timed: the table the checkout's form was chosen
     from.
Times are device times from torch.profiler (chip_smoke.py's device_ms: a
spin kernel opens each traced window; the best of --rounds rounds).
Prints the card's name and power limit, and as the last line one JSON
object of the results.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import chip_smoke as cs  # noqa: E402  (package, timers, inputs)
from probe_lib import build_aside, library  # noqa: E402

nt, kp, _build = cs.nt, cs.k_poisson, cs._build
GRIDS = ((63, 37), (255, 152))
THREADS = r"constexpr int kResidentExtThreads = (\d+);"
UNROLL = r"constexpr int kResidentExtUnroll = (\d+);"
FORMS = [(t, u) for t in (1024, 768, 512) for u in (1, 2, 3)]
KERNEL = "poisson_resident_ext"


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--forms", action="store_true",
                    help="time the threads-by-batch forms of K12 at 255")
    return ap.parse_args()


ARGS = parse_args()


def best(fn, kernel: str, per_call: int = 1) -> tuple[float, list]:
    """The best of ARGS.rounds device times of one call of fn (per_call
    launches of `kernel` a call)."""
    runs = [per_call * cs.device_ms(fn, ARGS.reps, kernel)
            for _ in range(ARGS.rounds)]
    return min(runs), runs


def inputs(g):
    hi, dpr, rhs = cs.resident_inputs(g)
    rng = np.random.RandomState(1)
    lo = torch.tensor(rng.randn(*hi.shape).astype(np.float32) * 2.0 ** -24,
                      device="cuda")
    return hi, lo, dpr, rhs


def registers(log: str) -> str:
    """ptxas's registers and spills line for K12 in a build's log."""
    entry, out = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif KERNEL in entry and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return "; ".join(out)


def run_k12(hi, lo, dpr, rhs, op, nit, scratch):
    return kp.poisson_iter_resident_ext(hi, lo, dpr, rhs, op, nit, *scratch)


def probe_grid(nx: int, nit: int, smi: str) -> dict:
    s = nt.ChorinSolver(nt.preset_multi(nx=nx, compat=False,
                                        dtype="float32"), device="cuda")
    g, op = s.grid, s._op
    hi0, lo0, dpr0, rhs = inputs(g)
    h, l, d = hi0.clone(), lo0.clone(), dpr0.clone()
    scratch = tuple(torch.full_like(hi0, float("nan")) for _ in range(2))
    e = run_k12(h, l, d, rhs, op, nit, scratch)
    q = (hi0.clone(), lo0.clone(), torch.empty_like(hi0),
         torch.empty_like(lo0))
    dq = dpr0.clone()
    for j in range(nit):
        e2 = kp.poisson_iter_ext(*q, dq, rhs, op, j == nit - 1)
        q = (q[2], q[3], q[0], q[1])
    hp, lp, dp = hi0.clone(), lo0.clone(), dpr0.clone()
    ep = kp.poisson_iter_resident_ext_plain(hp, lp, dp, rhs, op, nit)
    torch.cuda.synchronize()
    cs.require(cs.bitwise(h, q[0]) and cs.bitwise(l, q[1])
               and cs.bitwise(d, dq) and float(e) == float(e2),
               f"K12 at {nx} differs from {nit} K2 launches")
    cs.require(cs.bitwise(h, hp) and cs.bitwise(l, lp) and cs.bitwise(d, dp)
               and float(e) == float(ep),
               f"K12 at {nx} differs from its plain version")
    digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in (h, l, d))
        + np.float32(float(e)).tobytes()).hexdigest()
    want = (h.clone(), l.clone(), d.clone(), float(e))
    # the K2 chain's own state (sharing dpr with K12's would mix two
    # iterations)
    bufs = [hi0.clone(), lo0.clone(), torch.empty_like(hi0),
            torch.empty_like(lo0)]
    dk = dpr0.clone()

    def k2_chain():
        for j in range(nit):
            a, b = (0, 2) if j % 2 == 0 else (2, 0)
            kp.poisson_iter_ext(bufs[a], bufs[a + 1], bufs[b], bufs[b + 1],
                                dk, rhs, op, j == nit - 1)
    ms, runs = best(lambda: run_k12(h, l, d, rhs, op, nit, scratch), KERNEL)
    ms1, _ = best(lambda: run_k12(h, l, d, rhs, op, 1, scratch), KERNEL)
    k2_ms, k2_runs = best(k2_chain, "poisson_iter_ext_kernel", nit)
    cells = hi0.numel()
    bound_ms = nit * 20 * cells / cs.HBM_BYTES_PER_S * 1e3
    r = dict(nit=nit, plan=str(s._resident_plan), digest=digest, ms=ms,
             runs=runs, ms_nit1=ms1,
             us_per_iteration=(ms - ms1) / (nit - 1) * 1e3,
             k2_launches_ms=k2_ms, k2_runs=k2_runs, bound_ms=bound_ms,
             share_of_bound=bound_ms / ms,
             gain_over_k2=1.0 - ms / k2_ms)
    print(f"[K12] {nx}x{g.ny}x{g.nz}, nit {nit}: {ms:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in runs)}), nit 1 {ms1:.4f} ms, "
          f"{r['us_per_iteration']:.2f} us per added iteration; {nit} K2 "
          f"launches {k2_ms:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in k2_runs)}); K12 "
          f"{100 * r['gain_over_k2']:.1f}% below them; bound {bound_ms:.4f}"
          f" ms (20 B a cell and iteration), K12 at "
          f"{100 * r['share_of_bound']:.1f}% of it; hi, lo, dpr and the "
          f"check value bitwise equal to {nit} K2 launches and the plain "
          f"version; digest {digest[:16]} ({s._resident_plan}; {smi})",
          flush=True)
    if ARGS.forms and nx > 100:
        r["forms"] = forms(h, l, d, hi0, lo0, dpr0, rhs, op, nit, scratch,
                           want)
    del s
    torch.cuda.empty_cache()
    return r


def forms(h, l, d, hi0, lo0, dpr0, rhs, op, nit, scratch, want) -> dict:
    """Step 2: K12 built aside in each form of FORMS, held bitwise
    against the checkout's K12 from the seeded inputs, then timed."""
    src = (_build.SRC_DIR / "poisson.cu").read_text()
    mt, mu = re.search(THREADS, src), re.search(UNROLL, src)
    cs.require(mt is not None and mu is not None,
               "poisson.cu: no K12 form constants")

    def build(form):
        t, u = form
        patch = ((mt.group(0), mt.group(0).replace(mt.group(1), str(t))),
                 (mu.group(0), mu.group(0).replace(mu.group(1), str(u))))
        return build_aside(_build, _build.SRC_DIR, "poisson.cu",
                           {"poisson.cu": patch})
    with concurrent.futures.ThreadPoolExecutor(len(FORMS)) as pool:
        libs = dict(zip(FORMS, pool.map(build, FORMS)))
    rows = {}
    for (t, u), lib in libs.items():
        regs = registers(lib.nvcc_log)
        with library(_build, lib):
            q, lq, dq = hi0.clone(), lo0.clone(), dpr0.clone()
            e = float(run_k12(q, lq, dq, rhs, op, nit, scratch))
            same = (cs.bitwise(q, want[0]) and cs.bitwise(lq, want[1])
                    and cs.bitwise(dq, want[2]) and e == want[3])
            ms, runs = best(lambda: run_k12(h, l, d, rhs, op, nit, scratch),
                            KERNEL)
        label = f"{t} threads, {u} planes a batch"
        rows[label] = dict(ms=ms, runs=runs, bitwise=same, ptxas=regs)
        print(f"[K12 form] {label}: {ms:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs)}), bitwise equal to "
              f"the checkout's: {same}; ptxas: {regs}", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("k12_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    built = _build.build()
    print(f"[build] ptxas for K12: {registers(built.log)}")
    _build.load()
    out = {"device": smi}
    for nx, nit in GRIDS:
        out[f"{nx}, nit {nit}"] = probe_grid(nx, nit, smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
