"""K6 and K10 on one NVIDIA GPU: where their time goes against their bound.

    python3 scripts/k6k10_probe.py [--repo PATH] [--reps 20] [--rounds 2]
        [--sass] [--only k6 sync k10]

K6 (the unchained step's advection) at 255x153x153 on chip_smoke.py's
unchained-phase velocities:
  1. the four branches: the checkout's K6 for all four (one launch where
     its wrapper takes several branches, else four one-branch launches),
     first held bitwise against its plain version, then timed beside K5's
     one launch on the same velocities;
  2. issue only: a copy of csrc/advect.cu whose gathers read a constant,
     built aside and timed only (its outputs are wrong by design);
  3. bytes only: scripts/copy_ceiling.cu over the bytes of one branch
     (119.9 MB) and of the four (479.6 MB).
K10 (nit folded Poisson iterations in one launch) on chip_smoke.py's
resident_inputs, at 63x38x38 with nit 37 and at 255x153x153 with nit 152:
  4. the launch at nit and at nit 1 (held bitwise against nit K1 launches
     first), the time per added iteration, and the nit K1 launches; at
     255 a copy of pr into a buffer as large (warm in L2) and from it the
     grid form's ceiling as designed (`design_bound`);
  5. empty barrier loops (scripts/sync_probe.cu): a grid barrier over one
     1024-thread block per SM and over eight 256-thread blocks per SM, a
     cluster barrier in one cluster of 8 and of 16 blocks of 1024 threads;
  6. at 255, where the checkout's K10 moves dpr through device memory
     every iteration, a copy of csrc/poisson.cu whose K10 neither reads nor
     writes dpr (timed only): what holding dpr on chip can buy;
  7. at 255, where the checkout's grid form streams columns along x,
     that form under other cuts of y (GRID_FORCED_Y), and copies of
     csrc/poisson.cu whose grid form issues the loads of fewer and of more
     cells (the tile-walking form) or planes (the x-streamed form) per
     thread before their arithmetic than the checkout's kResidentUnroll;
     each held bitwise against the checkout's K10 first;
  8. at 255, where the checkout's grid form walks K1's tiles (the
     earlier form), copies of csrc/poisson.cu whose grid form (timed
     only: the results are wrong by design) takes a cell's x neighbours
     from its own value (no x-neighbour loads), or takes constant weights
     and a linear cell index in place of the tile cursor (no weight
     loads, no cursor, no padded slots), or both: how much of an
     iteration each explains.
At both grids the JSON holds a digest of K10's pr, dpr and check value
from the seeded inputs (`digest`): two checkouts' digests are equal when
their launches are bitwise equal.
--only runs the named parts (K6: 1-3, sync: 5, K10: 4, 6-8); --no-aside
builds no patched copy (K10's 4 and the forced plans of 7 alone). With
--sass, the SASS counts of the checkout's kernels through
chip_smoke.py's SYMBOLS (cuobjdump). Times are device times from
torch.profiler (the sum of the kernel's launches per call, a spin kernel
opening each traced window; the best of --rounds rounds). --repo runs
another checkout's package, kernels and chip_smoke.py (such as the parent
commit's, unpacked with `git archive` into chip_archive/): run parent,
change, change, parent in one call to compare them on one card. Prints
the card's name and power limit, and as the last line one JSON object of
the results.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import hashlib
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--repo", default=str(HERE.parent))
ap.add_argument("--reps", type=int, default=20)
ap.add_argument("--rounds", type=int, default=2)
ap.add_argument("--sass", action="store_true")
ap.add_argument("--only", choices=("k6", "sync", "k10"), nargs="+",
                default=("k6", "sync", "k10"))
ap.add_argument("--no-aside", action="store_true",
                help="build no patched copy (K10's steps 6 and 8 and the "
                     "load batches of step 7)")
ARGS = ap.parse_args()
REPO = Path(ARGS.repo).resolve()
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the checkout's: package, timers, tables)
from probe_lib import build_aside, library  # noqa: E402

nt, ka, kp, _build = cs.nt, cs.k_advect, cs.k_poisson, cs._build
BRANCHES = ("vx", "vy", "vz", "c")
# the gathers of the select-shift sum, replaced by a constant
GATHER_FORM = (("acc = acc + (wx.w[io] * wyz) * a.p[ox[io] + row];",
                "acc = acc + (wx.w[io] * wyz) * 1.0f;"),)
# the parent's K10 body: dpr read and written in device memory every
# iteration, replaced by a constant and no store
DPR_FORM = (("        const float d = dpr[i] * decay + dtau * resid;\n"
             "        dpr[i] = d;\n        q[i] = pc + dtau * d;\n",
             "        const float d = 0.5f * decay + dtau * resid;\n"
             "        q[i] = pc + dtau * d;\n"),
            ("        dpr[i] = 0.0f;\n        q[i] = pc + dtau * 0.0f;\n",
             "        q[i] = pc + dtau * 0.0f;\n"))
# empty barrier loops: (label, kind, blocks per SM or cluster size,
# threads, dynamic shared memory bytes)
SYNC_CASES = (("grid, 1 x 1024 threads per SM", "grid", 1, 1024, 0),
              ("grid, 8 x 256 threads per SM", "grid", 8, 256, 0),
              ("cluster of 8 x 1024 threads", "cluster", 8, 1024, 185 * 1024),
              ("cluster of 16 x 1024 threads", "cluster", 16, 1024,
               93 * 1024))
SYNC_N = 1000
# the grid form's cells (tile-walking) or planes (x-streamed) per thread
# whose loads are issued together
UNROLL = r"constexpr int kResidentUnroll = (\d+);"
# other cuts of y for the x-streamed grid form (its z rows are a warp's
# 32 lanes): regions of more rows on fewer blocks
GRID_FORCED_Y = (13, 20, 22)
# the tile-walking grid form (the earlier design) with parts of an
# iteration cut out (timed only): the x neighbours' loads (each replaced
# by the cell's own value); the weight loads and the tile cursor (constant
# weights, and cell k * 256 + the thread's slot of the flat field for tile
# k: no cursor steps, no padded slots, loads aligned to the tile)
X_CUT = (("          nb[u][0] = p[i + nyz];\n"
          "          nb[u][1] = p[i - nyz];\n",
          "          nb[u][0] = pc[u];\n          nb[u][1] = pc[u];\n"),)
CURSOR_CUT = (
    ("        const int y = t.yt * ns3d::kBlockY + row;\n"
     "        const int z = t.zt * ns3d::kBlockX + lane;\n"
     "        on[u] = k < own.size && y < ny && z < nz;\n"
     "        in[u] = on[u] && interior(t.x, y, z, nx, ny, nz);\n"
     "        drop[u] = zero_grad_x && t.x == 1;\n"
     "        const int i = on[u] ? t.x * nyz + y * nz + z : 0;\n",
     "        const int y = 1, z = 1;\n"
     "        const int lin = (own.start + k) * ns3d::kBlockThreads +\n"
     "                        row * ns3d::kBlockX + lane;\n"
     "        on[u] = k < own.size && lin < nx * nyz;\n"
     "        in[u] = on[u] && lin >= nyz && lin < (nx - 1) * nyz;\n"
     "        drop[u] = false;\n"
     "        const int i = on[u] ? lin : 0;\n"),
    ("        t.step(kQuarters, tiles_z, tiles_y);\n      }\n#pragma unroll",
     "      }\n#pragma unroll"),
    ("w.yp[yy[u]], w.ym[yy[u]], w.zp[zz[u]],\n              w.zm[zz[u]])",
     "0.25f, 0.25f, 0.25f, 0.25f)"))
GRID_CUTS = (("x neighbours from pc", X_CUT),
             ("weights and cursor constant", CURSOR_CUT),
             ("both cuts", X_CUT + CURSOR_CUT))
RESIDENT = ((63, 37), (255, 152))


def device_ms(fn, reps: int, pattern: str, per_call: int = 1) -> float:
    """Device ms per call of fn: the summed durations of the kernels whose
    name contains `pattern` (per_call of them per call), over reps calls
    traced with torch.profiler after a warm-up, a spin kernel opening the
    window: the mean launch of those traced times per_call (the tracer
    may drop a launch at the window's edge; at least half of them must be
    kept, else the window is traced again, and after five it raises)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(2_000_000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and pattern in e.name]
        if len(durs) >= reps * per_call // 2:
            return sum(durs) / len(durs) * per_call / 1e3
        print(f"[trace] {len(durs)} launches of {pattern}, expected "
              f"{reps * per_call}: tracing again")
    raise RuntimeError(f"five traced windows held too few launches of "
                       f"{pattern}")


def best(fn, pattern: str, per_call: int = 1, reps: int | None = None
         ) -> tuple[float, list]:
    runs = [device_ms(fn, reps or ARGS.reps, pattern, per_call)
            for _ in range(ARGS.rounds)]
    return min(runs), runs


def aside(src_dir: Path, name: str, patches=None) -> ctypes.CDLL:
    """probe_lib.build_aside with the checkout's _build, reporting the
    registers and spills of K6 and K10 there."""
    lib = build_aside(_build, src_dir, name, patches)
    report(lib.nvcc_log, f"{name} aside")
    return lib


def report(log: str, label: str) -> None:
    """Print the registers and spills ptxas reports for K6 and K10."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("advect_pre" in entry or "resident" in entry) and (
                "registers" in line or "spill" in line):
            print(f"[build {label}] {entry[30:90]} {line.strip()}")


def k6_four(fields, vels, k, w):
    """The checkout's K6 over the four branches: one launch where its
    wrapper takes several branches (`advect_pre`), else four."""
    if hasattr(ka, "advect_pre"):
        return list(ka.advect_pre(dict(zip(BRANCHES, fields)), vels, k,
                                  w).values())
    return [ka.advect_branch_pre(name, a, *vels[name], k, w)
            for name, a in zip(BRANCHES, fields)]


def probe_k6(out: dict) -> None:
    solver = nt.ChorinSolver(nt.preset_gpu(nx=cs.NX, compat=False,
                                           dtype="float32"), device="cuda",
                             fused_step=False)
    rng = np.random.default_rng(2028)
    g, k, w = solver.grid, solver._consts, solver.advect_k
    nx, ny, nz = g.nx, g.ny, g.nz
    vx = cs.seeded(rng, nx + 1, ny, nz, scale=0.5) + 1.0
    vy = cs.seeded(rng, nx, ny + 1, nz, scale=0.3)
    vz = cs.seeded(rng, nx, ny, nz + 1, scale=0.3)
    c = torch.tensor(rng.uniform(size=(nx, ny, nz)).astype(np.float32),
                     device="cuda")
    fields = (vx, vy, vz, c)
    vels = {name: ka.pre_velocities(name, vx, vy, vz) for name in BRANCHES}
    got = k6_four(fields, vels, k, w)
    for name, a, o in zip(BRANCHES, fields, got):
        ref, _ = ka.advect_branch_pre_plain(name, a, *vels[name], k, w)
        if not cs.bitwise(o, ref):
            raise RuntimeError(f"K6 {name} differs from its plain version")
    del got
    one_launch = hasattr(ka, "advect_pre")
    n = 1 if one_launch else 4
    ms, runs = best(lambda: k6_four(fields, vels, k, w), "advect_pre", n)
    k5, k5_runs = best(lambda: ka.advect(*fields, k, w), "advect_kernel")
    gather = aside(_build.SRC_DIR, "advect.cu", {"advect.cu": GATHER_FORM})
    with library(_build, gather):
        const_ms, const_runs = best(lambda: k6_four(fields, vels, k, w),
                                    "advect_pre", n)
    one = sum(t.numel() * 4 for t in (c, *vels["c"], c))
    four = sum(t.numel() * 4 * 2 + sum(v.numel() * 4 for v in vels[name])
               for name, t in zip(BRANCHES, fields))
    r = dict(launches=n, ms=ms, runs=runs, k5_ms=k5, k5_runs=k5_runs,
             gathers_const_ms=const_ms, gathers_const_runs=const_runs,
             bytes_one_branch=one, bytes_four=four,
             bound_four_ms=four / cs.HBM_BYTES_PER_S * 1e3,
             copy_one_branch_ms=copy_ms(one), copy_four_ms=copy_ms(four))
    print(f"[K6] four branches in {n} launch(es): {ms:.4f} ms (runs "
          f"{', '.join(f'{v:.4f}' for v in runs)}), bound "
          f"{r['bound_four_ms']:.4f} ms ({four / 1e6:.1f} MB), "
          f"{100 * r['bound_four_ms'] / ms:.1f}% of it; gathers a constant "
          f"{const_ms:.4f} ms; copy of one branch's {one / 1e6:.1f} MB "
          f"{r['copy_one_branch_ms']:.4f} ms, of the four's "
          f"{r['copy_four_ms']:.4f} ms; K5's one launch {k5:.4f} ms "
          f"({out['device']})", flush=True)
    out["K6"] = r


def copy_ms(nbytes: int) -> float:
    """The fastest grid-stride float4 copy of nbytes / 2 bytes into as many
    (chip_smoke.py's copy_library and COPY_GRIDS), timed as the kernels
    here are."""
    n4 = nbytes // 32
    src = torch.rand(4 * n4, device="cuda")
    dst = torch.empty_like(src)
    sms = _build.sm_count(src.device)
    fn = cs.copy_library().ns3d_copy_float4

    def run(threads, per_sm):
        _build.check(fn(src.data_ptr(), dst.data_ptr(), n4, per_sm * sms,
                        threads, _build.stream_of(src)), "copy_float4")
    try:
        ms = min(best(lambda: run(*grid), "copy_float4")[0]
                 for grid in cs.COPY_GRIDS)
    except RuntimeError as e:
        # one launch a call: queued behind a spin, the events time it
        ms = min(cs.queued_ms(lambda: run(*grid), ARGS.reps)
                 for grid in cs.COPY_GRIDS)
        print(f"[trace] {e}: the copy of {nbytes / 1e6:.1f} MB timed by CUDA "
              f"events behind a spin kernel, {ms:.4f} ms", flush=True)
    if not torch.equal(src, dst):
        raise RuntimeError("copy_float4 copied wrongly")
    return ms


@functools.cache
def sync_library() -> ctypes.CDLL:
    lib = aside(HERE, "sync_probe.cu")
    for fname, n in (("ns3d_grid_sync_loop", 3), ("ns3d_cluster_sync_loop",
                                                  4)):
        getattr(lib, fname).argtypes = ([ctypes.c_int] * n
                                        + [ctypes.c_void_p] * 2)
        getattr(lib, fname).restype = ctypes.c_int
    return lib


def probe_sync(out: dict) -> None:
    lib = sync_library()
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = _build.stream_of(sink)
    sms = _build.sm_count(sink.device)
    rows = {}
    for label, kind, per, threads, smem in SYNC_CASES:
        def run(n):
            if kind == "grid":
                rc = lib.ns3d_grid_sync_loop(n, per * sms, threads,
                                             sink.data_ptr(), stream)
            else:
                rc = lib.ns3d_cluster_sync_loop(n, per, threads, smem,
                                                sink.data_ptr(), stream)
            _build.check(rc, f"sync loop ({label})")
        t1, _ = best(lambda: run(1), "sync_loop")
        tn, _ = best(lambda: run(1 + SYNC_N), "sync_loop")
        rows[label] = dict(us_per_barrier=(tn - t1) / SYNC_N * 1e3,
                           one_ms=t1)
        print(f"[sync] {label}: {rows[label]['us_per_barrier']:.3f} us per "
              f"barrier (a launch of one: {t1 * 1e3:.2f} us; "
              f"{out['device']})", flush=True)
    out["sync"] = rows


def probe_k10(out: dict) -> None:
    rows = {}
    dpr_lib = None
    src = (_build.SRC_DIR / "poisson.cu").read_text()
    if all(src.count(old) == 1 for old, _ in DPR_FORM):
        dpr_lib = aside(_build.SRC_DIR, "poisson.cu",
                        {"poisson.cu": DPR_FORM})
    for nx, nit in RESIDENT:
        s = nt.ChorinSolver(nt.preset_gpu(nx=nx, compat=False,
                                          dtype="float32"), device="cuda")
        op = s._op
        pr0, dpr0, rhs = cs.resident_inputs(s.grid)
        p, d = pr0.clone(), dpr0.clone()
        scratch = torch.full_like(p, float("nan"))
        e = kp.poisson_iter_resident(p, d, rhs, op, nit, scratch)
        q, dq = pr0.clone(), dpr0.clone()
        for j in range(nit):
            o = torch.empty_like(q)
            e1 = kp.poisson_iter(q, o, dq, rhs, op, j == nit - 1)
            q = o
        torch.cuda.synchronize()
        if not (cs.bitwise(p, q) and cs.bitwise(d, dq)
                and float(e) == float(e1)):
            raise RuntimeError(f"K10 at {nx} differs from {nit} K1 launches")
        digest = hashlib.sha256(p.cpu().numpy().tobytes()
                                + d.cpu().numpy().tobytes()
                                + np.float32(float(e)).tobytes()).hexdigest()
        del q, dq
        # the K1 chain's own state (sharing dpr with K10's would mix two
        # iterations and blow up)
        bufs = [pr0.clone(), torch.empty_like(pr0)]
        dk = dpr0.clone()

        def k1_chain():
            for j in range(nit):
                kp.poisson_iter(bufs[j % 2], bufs[(j + 1) % 2], dk, rhs, op,
                                j == nit - 1)

        def k10(n=nit):
            kp.poisson_iter_resident(p, d, rhs, op, n, scratch)
        reps = ARGS.reps if nx < 100 else max(3, ARGS.reps // 4)
        ms, runs = best(k10, "poisson_resident", reps=reps)
        ms1, _ = best(lambda: k10(1), "poisson_resident", reps=reps)
        k1_ms, _ = best(k1_chain, "poisson_iter_kernel", nit, reps=reps)
        r = dict(nit=nit, plan=str(s._resident_plan), digest=digest, ms=ms,
                 runs=runs, ms_nit1=ms1,
                 us_per_iteration=(ms - ms1) / (nit - 1) * 1e3,
                 k1_launches_ms=k1_ms)
        if dpr_lib is not None and nx > 100 and not ARGS.no_aside:
            with library(_build, dpr_lib):
                r["dpr_const_ms"], _ = best(k10, "poisson_resident",
                                            reps=reps)
        if hasattr(kp, "launch_resident"):
            variants(r, nx, nit, s._resident_plan, op, pr0, dpr0, p, d, rhs,
                     scratch, reps)
        if nx > 100 and not ARGS.no_aside:
            grid_cuts(r, nx, nit, op, p, d, rhs, scratch, reps)
        rows[f"{nx}, nit {nit}"] = r
        if nx > 100:
            # the pr pair's traffic through L2: a copy of pr into a buffer
            # as large, warm (its 2 x 23.9 MB at 255 fit the 50 MB L2)
            r["pr_pair_bytes"] = 2 * p.numel() * 4
            r["pr_pair_copy_ms"] = copy_ms(r["pr_pair_bytes"])
            design_bound(r, p.numel(), nit)
        extra = (f"; dpr a constant {r['dpr_const_ms']:.4f} ms"
                 if "dpr_const_ms" in r else "")
        if "design_bound_ms" in r:
            extra += (f"; a copy of pr into its pair {r['pr_pair_copy_ms']:.4f}"
                      f" ms ({r['l2_rate'] / 1e12:.3f} TB/s); the design's "
                      f"ceiling {r['design_bound_ms']:.4f} ms, kernel at "
                      f"{100 * r['design_bound_ms'] / ms:.1f}% of it")
        print(f"[K10] {nx}x{s.grid.ny}x{s.grid.nz}, nit {nit}: {ms:.4f} ms "
              f"(runs {', '.join(f'{v:.4f}' for v in runs)}), nit 1 "
              f"{ms1:.4f} ms, {r['us_per_iteration']:.2f} us per added "
              f"iteration; {nit} K1 launches {k1_ms:.4f} ms{extra} "
              f"({s._resident_plan}; {out['device']})", flush=True)
        del s, p, d, scratch, bufs
        torch.cuda.empty_cache()
    out["K10"] = rows


def design_bound(r: dict, cells: int, nit: int) -> None:
    """The grid form's ceiling as it is designed: dpr in shared memory,
    pr ping-ponging through L2, rhs from HBM. Each iteration reads rhs
    from HBM (4 B a cell at cs.HBM_BYTES_PER_S) and moves pr in, rhs in
    and pr out through L2 (12 B a cell at the rate of the warm copy of pr
    into its pair); the ceiling is nit times the larger."""
    r["l2_rate"] = r["pr_pair_bytes"] / (r["pr_pair_copy_ms"] / 1e3)
    hbm = 4 * cells / cs.HBM_BYTES_PER_S
    l2 = 12 * cells / r["l2_rate"]
    r["design_bound_ms"] = nit * max(hbm, l2) * 1e3
    r["design_bound_by"] = "HBM (rhs)" if hbm >= l2 else "L2 (pr, rhs)"


def variants(r, nx, nit, plan, op, p0, d0, p, d, rhs, scratch,
             reps) -> None:
    """Step 7 under the checkout's plan (its solver's `_resident_plan`):
    at 255 the grid form under other cuts of y and with the loads of
    fewer and more cells or planes per thread; each first bitwise against
    the checkout's K10 from the seeded inputs (p0, d0), then timed on (p,
    d)."""
    if nx < 100:
        return
    want_p, want_d = p0.clone(), d0.clone()
    want_e = float(kp.poisson_iter_resident(want_p, want_d, rhs, op, nit,
                                            scratch))

    def held(label, run):
        q, dq = p0.clone(), d0.clone()
        e = float(run(q, dq))
        if not (cs.bitwise(q, want_p) and cs.bitwise(dq, want_d)
                and e == want_e):
            bad = [(name, int((a != b).sum()), float((a - b).abs().max()))
                   for name, a, b in (("pr", q, want_p), ("dpr", dq, want_d))]
            raise RuntimeError(f"K10 {label} differs from the checkout's: "
                               f"{bad}, check value {e} against {want_e}")
        ms, _ = best(lambda: run(p, d), "poisson_resident", reps=reps)
        r[label] = ms
        print(f"[K10] {nx}, nit {nit}, {label}: {ms:.4f} ms", flush=True)
    if getattr(plan, "cut", (1, 1)) != (1, 1):
        # the x-streamed grid form under other cuts of y
        gz = plan.cut[1]
        for gy in GRID_FORCED_Y:
            cols = -(-p.shape[1] // gy) * kp.RESIDENT_LANES
            smem = max(kp.grid_smem(cols, nx), kp.RESIDENT_SOLO_SMEM)
            if (gy == plan.cut[0] or gy * gz > plan.blocks
                    or smem > kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM):
                continue
            forced = dataclasses.replace(plan, blocks=gy * gz,
                                         per_block=cols, smem_bytes=smem,
                                         cut=(gy, gz))
            held(f"grid form, cut {gy} x {gz} ({cols} columns)",
                 lambda q, dq, f=forced: kp.launch_resident(
                     q, dq, rhs, op, nit, f, scratch))
    if not ARGS.no_aside:
        src = (_build.SRC_DIR / "poisson.cu").read_text()
        m = re.search(UNROLL, src)
        cur = int(m.group(1)) if m else 0
        for u in sorted({cur - 1, cur + 1} - {0} if m else ()):
            lib = aside(_build.SRC_DIR, "poisson.cu", {"poisson.cu": (
                (m.group(0), m.group(0).replace(str(cur), str(u))),)})
            with library(_build, lib):
                held(f"grid form, loads of {u} cells or planes together",
                     lambda q, dq: kp.poisson_iter_resident(
                         q, dq, rhs, op, nit, scratch))


def grid_cuts(r, nx, nit, op, p, d, rhs, scratch, reps) -> None:
    """Step 8: the tile-walking grid form with GRID_CUTS' parts cut out,
    timed only, where the checkout's source has them."""
    src = (_build.SRC_DIR / "poisson.cu").read_text()
    for label, patch in GRID_CUTS:
        if not all(src.count(old) == 1 for old, _ in patch):
            continue
        lib = aside(_build.SRC_DIR, "poisson.cu", {"poisson.cu": patch})
        with library(_build, lib):
            r[label], _ = best(lambda: kp.poisson_iter_resident(
                p, d, rhs, op, nit, scratch), "poisson_resident", reps=reps)
        print(f"[K10] {nx}, nit {nit}, grid form, {label} (timed only): "
              f"{r[label]:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k6k10_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    print(f"[repo] {REPO}")
    built = _build.build()
    report(built.log, "checkout")
    _build.load()
    out = {"device": smi, "repo": str(REPO)}
    if ARGS.sass:
        out["sass"] = cs.sass_counts(built.path)
    for part in ARGS.only:
        {"k6": probe_k6, "sync": probe_sync, "k10": probe_k10}[part](out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
