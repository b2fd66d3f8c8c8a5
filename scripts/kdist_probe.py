"""K7-dist and K2-dist, the distributed solve's per-shard Poisson kernels,
on one NVIDIA GPU: where their time goes against their bound.

    python3 scripts/kdist_probe.py [--repo PATH] [--reps 50] [--rounds 2]
        [--sass]

On the multi preset's 255x153x153 grid split over three x-shards (bx =
85), with chip_smoke.py's seeded fields and its multi BC operators:
  1. shard or halo code: K7-dist on the middle shard (x_off = 85), on the
     first and last, and on the whole grid at x_off = 0 with no halo planes;
     K7 on the whole grid; K2-dist likewise and K2 (folded) on the whole
     grid. Each is first held bitwise against its plain version (NaN-filled
     outputs, the check value with it), then timed.
  2. the ceiling: scripts/copy_ceiling.cu, a grid-stride float4 copy built
     with the port's nvcc flags, over the bytes each kernel's bound counts
     (half read, half written), at several grid sizes; the fastest is
     printed beside the bound.
  3. the ring path: where the checkout's kernels recompute a ring cell's
     source update (the earlier form), a copy of csrc/poisson.cu whose ring
     branches store a constant instead, built aside and timed only (its
     outputs are wrong by design and never kept).
  4. with --sass, the SASS counts of the checkout's kernels through
     chip_smoke.py's SYMBOLS (cuobjdump).
  5. cold: the middle shard's kernels, K7 and the copies again with the
     50 MB L2 flushed before each launch (a 128 MB fill, not counted), as
     the distributed loop finds it: between a shard's launches the other
     shards move 80-110 MB.
Times are device times from torch.profiler (the kernel's own duration,
the mean over --reps launches; the best of --rounds rounds), as
chip_smoke.py times the dist kernels. --repo runs another checkout's
package, kernels and chip_smoke.py (such as the parent commit's, unpacked
with `git archive` into chip_archive/): run parent, change, change, parent
in one call to compare them on one card. Prints the card's name and power
limit, the build's register and spill lines of the Poisson kernels, and
as the last line one JSON object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--repo", default=str(HERE.parent))
ap.add_argument("--reps", type=int, default=50)
ap.add_argument("--rounds", type=int, default=2)
ap.add_argument("--sass", action="store_true")
ARGS = ap.parse_args()
REPO = Path(ARGS.repo).resolve()
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the checkout's: package, timers, tables)
from probe_lib import build_aside, library  # noqa: E402

nt, kp, _build = cs.nt, cs.k_poisson, cs._build
# thread-block configurations of the copy: threads per block, blocks per SM
COPY_GRIDS = ((256, 1), (256, 2), (256, 4), (256, 8), (1024, 1), (1024, 2))
# the cases also timed cold
COLD = ("K7-dist shard x_off 85", "K2-dist shard x_off 85", "K7 whole grid",
        "K7-dist whole grid")
# the earlier kernels' ring branches: a ring thread recomputes its clamped
# source's update (K7-dist and K7, then K2-dist), replaced by a constant
RING_FORMS = (
    ("        v = dist_update<kHalo>(pr, dpr, rhs, sl, cy, cz, sh, k, &d, "
     "&resid);\n", "        v = 1.0f;\n"),
    ("        dist_update_ext(hi, lo, dpr, rhs, sl, cy, cz, sh, k, &h, &l, "
     "&d,\n                        &resid);\n",
     "        h = 1.0f;\n        l = 0.0f;\n"),
)


def device_ms(fn, reps: int) -> tuple[str, float]:
    """(name, mean device ms per launch) of the one kernel fn launches,
    over reps calls traced with torch.profiler after a warm-up; memsets
    and fills (the check word) are not counted."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and ("poisson" in e.name or "copy" in e.name)):
                durs.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if len(durs) == 1:
            name, d = next(iter(durs.items()))
            if len(d) >= reps // 2:
                return name, sum(d) / len(d) / 1e3
        print(f"[trace] {({k: len(v) for k, v in durs.items()})}: tracing "
              "again")
    raise RuntimeError(f"kdist_probe: traced {durs.keys()}")


def nan_like(t, n):
    return [torch.full_like(t, float("nan")) for _ in range(n)]


def bitwise(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def cases(fields, ops, folded_op) -> dict:
    """name -> (kernel call, plain call or None, number of outputs, the
    inputs and the outputs updated in place its bound counts): each call
    takes (outputs, check)."""
    pr, lo, dpr, rhs = fields
    nx = pr.shape[0]
    bx = nx // 3
    op7, op2 = ops[("K7", "multi")], ops[("K2", "multi")]
    out = {}

    def planes(x_off, n):
        return [t for t, held in ((op7.xlo, x_off == 0),
                                  (op7.xhi, x_off + n == nx))
                if t is not None and held]

    def halo(t, x_off, n):
        return (t[x_off - 1] if x_off > 0 else None,
                t[x_off + n] if x_off + n < nx else None)
    for x_off, n, label in ((bx, bx, "shard x_off 85"),
                            (0, bx, "shard x_off 0"),
                            (2 * bx, bx, "shard x_off 170"),
                            (0, nx, "whole grid")):
        sl = slice(x_off, x_off + n)
        ins = (pr[sl], dpr[sl], rhs[sl])
        h = halo(pr, x_off, n)

        def k7(o, c, ins=ins, h=h, x_off=x_off):
            return kp.poisson_iter_bc_dist(*ins, *o, *h, x_off, op7, c)

        def k7p(o, c, ins=ins, h=h, x_off=x_off):
            return kp.poisson_iter_bc_dist_plain(*ins, *o, *h, x_off, op7, c)
        out[f"K7-dist {label}"] = (k7, k7p, 2, (*ins, *(t for t in h if t
                                                        is not None),
                                                *planes(x_off, n)), ())
        ins2 = (pr[sl], lo[sl], dpr[sl], rhs[sl])
        h2 = (*h, *halo(lo, x_off, n))

        def k2(o, c, ins=ins2, h=h2, x_off=x_off):
            return kp.poisson_iter_ext_bc_dist(*ins, *o, *h, x_off, op2, c)

        def k2p(o, c, ins=ins2, h=h2, x_off=x_off):
            return kp.poisson_iter_ext_bc_dist_plain(*ins, *o, *h, x_off,
                                                     op2, c)
        out[f"K2-dist {label}"] = (k2, k2p, 3, (*ins2, *(t for t in h2 if t
                                                         is not None),
                                                *planes(x_off, n)), ())
    out["K7 whole grid"] = (
        lambda o, c: kp.poisson_iter_bc(pr, dpr, rhs, *o, op7),
        lambda o, c: kp.poisson_iter_bc_plain(pr, dpr, rhs, *o, op7), 2,
        (pr, dpr, rhs, op7.xhi), ())
    d2 = dpr.clone()   # K2 updates dpr in place
    out["K2 whole grid"] = (
        lambda o, c: kp.poisson_iter_ext(pr, lo, o[0], o[1], d2, rhs,
                                         folded_op, c),
        None, 2, (pr, lo, d2, rhs), (d2,))
    return out


def check_bitwise(name, fn, plain, nout, like) -> None:
    for check in (False, True):
        a, b = nan_like(like, nout), nan_like(like, nout)
        ea, eb = fn(a, check), plain(b, check)
        torch.cuda.synchronize()
        if not all(bitwise(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"{name} differs from its plain version")
        if check and ea is not None and float(ea) != float(eb):
            raise RuntimeError(f"{name}: check value {float(ea)} against "
                               f"{float(eb)}")


def copy_ceiling(copy_lib, nbytes: int, flush=None) -> dict:
    """The fastest grid-stride float4 copy of nbytes/2 bytes (read) into
    as many (written), over COPY_GRIDS; with `flush`, each launch after a
    fill of it."""
    n4 = nbytes // 2 // 16
    src = torch.rand(4 * n4, device="cuda")
    dst = torch.empty_like(src)
    sms = _build.sm_count(src.device)
    fn = copy_lib.ns3d_copy_float4
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    best = None
    for threads, per_sm in COPY_GRIDS:
        def run():
            if flush is not None:
                flush.zero_()
            rc = fn(src.data_ptr(), dst.data_ptr(), n4, per_sm * sms, threads,
                    _build.stream_of(src))
            _build.check(rc, "copy_float4")
        _, ms = device_ms(run, ARGS.reps)
        if best is None or ms < best["ms"]:
            best = dict(ms=ms, threads=threads, blocks=per_sm * sms)
    if not torch.equal(src, dst):
        raise RuntimeError("copy_float4 copied wrongly")
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("kdist_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    print(f"[repo] {REPO}")
    built = _build.build()
    entry = ""
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "poisson" in entry and ("registers" in line or "spill" in line):
            print(f"[build] {entry[:60]} {line.strip()}")
    _build.load()
    out = {"device": smi, "repo": str(REPO)}
    if ARGS.sass:
        out["sass"] = cs.sass_counts(built.path)
    rng = np.random.default_rng(2027)
    g = nt.make_grid(nt.preset_multi(nx=cs.NX))
    shape = g.shape_c
    fields = (cs.seeded(rng, *shape, scale=50.0),
              cs.seeded(rng, *shape, scale=50.0 * 2.0 ** -24),
              cs.interior_seeded(rng, shape, 1e3),
              cs.seeded(rng, *shape, scale=1e5))
    multi = nt.ChorinSolver(nt.preset_multi(nx=cs.NX, compat=False,
                                            dtype="float32"), device="cuda")
    table = cases(fields, cs.dist_operators(), multi._op)
    outs, bounds = {}, {}
    for name, (fn, plain, nout, ins, inplace) in table.items():
        like = ins[0]
        if plain is not None:
            check_bitwise(name, fn, plain, nout, like)
        outs[name] = nan_like(like, nout)
        kind = name.split()[0]
        bname = {"K7-dist": cs.K7D_NAME, "K2-dist": cs.K2D_NAME,
                 "K7": cs.K7_NAME, "K2": cs.K2_NAME}[kind]
        bounds[name] = cs.bound(bname, ins, [*outs[name], *inplace],
                                like.numel())
    print("[bitwise] every dist case, K7 and K2-dist's whole grid equal to "
          "their plain versions, with the check value", flush=True)
    copy_lib = build_aside(_build, HERE, "copy_ceiling.cu")
    ring = None
    src = (_build.SRC_DIR / "poisson.cu").read_text()
    if all(src.count(old) == 1 for old, _ in RING_FORMS):
        ring = build_aside(_build, _build.SRC_DIR, "poisson.cu",
                           {"poisson.cu": RING_FORMS})
    flush = torch.empty(2 ** 25, device="cuda")
    rows = {name: {"runs": [], "ring_const_runs": []} for name in table}
    for rnd in range(ARGS.rounds):
        for name, (fn, *_) in table.items():
            o = outs[name]
            kname, ms = device_ms(lambda: fn(o, False), ARGS.reps)
            rows[name]["kernel"] = kname.split("(")[0]
            rows[name]["runs"].append(ms)
            if rnd == 0:
                _, ms_chk = device_ms(lambda: fn(o, True), ARGS.reps // 2)
                rows[name]["check_ms"] = ms_chk
            if rnd == 0 and name in COLD:
                _, rows[name]["cold_ms"] = device_ms(
                    lambda: (flush.zero_(), fn(o, False)), ARGS.reps // 2)
            if ring is not None and not name.startswith("K2 "):
                with library(_build, ring):
                    _, ms = device_ms(lambda: fn(o, False), ARGS.reps)
                rows[name]["ring_const_runs"].append(ms)
    ceilings = {}
    for name, r in rows.items():
        nbytes = bounds[name]["bytes"]
        if nbytes not in ceilings:
            ceilings[nbytes] = copy_ceiling(copy_lib, nbytes)
        if name in COLD:
            r["copy_cold"] = copy_ceiling(copy_lib, nbytes, flush)
        r.update(bounds[name])
        r["ms"] = min(r["runs"])
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["copy"] = ceilings[nbytes]
        r["copy_share_of_bound"] = r["bound_ms"] / r["copy"]["ms"]
        if r["ring_const_runs"]:
            r["ring_const_ms"] = min(r["ring_const_runs"])
        ring_txt = (f"; ring branch a constant {r['ring_const_ms']:.4f} ms"
                    if "ring_const_ms" in r else "")
        if "cold_ms" in r:
            ring_txt += (f"; cold L2: {r['cold_ms']:.4f} ms "
                         f"({100 * r['bound_ms'] / r['cold_ms']:.1f}%), copy "
                         f"{r['copy_cold']['ms']:.4f} ms")
        print(f"[time] {name}: {r['ms']:.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in r['runs'])}; check iteration "
              f"{r['check_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
              f"({r['bytes'] / 1e6:.1f} MB), {100 * r['share_of_bound']:.1f}% "
              f"of it; copy of the same bytes {r['copy']['ms']:.4f} ms "
              f"({100 * r['copy_share_of_bound']:.1f}% of the bound, "
              f"{r['copy']['blocks']} x {r['copy']['threads']}){ring_txt}; "
              f"{r['kernel']} ({smi})", flush=True)
    out["cases"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
