"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: CUDA must be available; prints the card's name and power limit
  2. build: compiles the port's CUDA kernels from csrc/*.cu (nvcc, one
     process per source), and counts each kernel's SASS instructions
     (cuobjdump): the whole kernel, its IEEE divisions, and K3's and K8's
     plane loop
  3. kernels: each hand-written kernel (K1 poisson_iter with the gpu and
     the multi operator, K2 poisson_iter_ext, K3 predict with both presets'
     masks, K4 correct for both variants, K5 advect, K7 poisson_iter_bc
     with the compat gpu and multi BC specs, K13's two forms with both
     operators on a pressure pair near a solution, bitwise: r, its ring
     and max|r|, the pair form with r and without) against its plain
     PyTorch version on the card, at the main paths' 255x153x153 float32 shapes
     with seeded inputs: max ulp / abs difference (K3 and K5 bitwise with
     NaN-filled outputs, K5's one launch and its one-branch launches, the
     clamp counts equal), kernel and plain times (CUDA events), and each
     kernel's bound (bytes over the HBM rate, flops over the float32 rate,
     the larger; K5's also as the four one-branch launches' bounds)
  4. gpu main path: ChorinSolver(preset_gpu(nx=255, compat=False,
     dtype='float32'), device='cuda') for 4 steps from init_state; every
     solve must converge with finite fields, no advection clamps, the JAX
     package's exact iteration counts and a stored-state residual below
     eps_it
  5. multi main path: ChorinSolver(preset_multi(nx=255, ...)) for 4 steps
     and preset_multi(nx=63, ...) (the reference's own invocation) for 8;
     every solve converges, every stored pair of the nx=255 run meets
     eps_it (the nx=63 ones are reported), and the nx=63 iteration counts
     are held against the JAX package's
  Each main path runs with the launch counts set to 0 just before it and
  read just after: every kernel of the path (K10, one launch a folded
  loop, its exits decided on the card; K12, the extended phase's
  bodies, one launch per check interval, on both multi runs, its
  launches and iterations printed) must have launched and no plain
  version may have run. Then one more step of
  the gpu and the nx=255 multi path is traced with torch.profiler: device
  time per kernel and the device's idle share.
  6. compat paths: preset_gpu(nx=255, dtype='float32') and
     preset_multi(nx=255, dtype='float32') with compat on (the reference's
     own semantics: K7 under the reference's chunk loop, torch ops for the
     rest of the step, gather advection), 4 steps each from init_state,
     with the launch counts set to 0 just before each and read just after:
     K7 must have launched, no other kernel and no plain version; every
     field finite. Step 1 of each runs again with use_pallas=False (the
     plain versions): equal iteration counts, pr within MAX_ULP. (Should a
     path turn non-finite, the plain run must turn non-finite at the same
     step with the same counts: the reference's documented gpu blow-up.)
     Then one more step of each is traced with torch.profiler.
  7. golden: preset_multi(nx=63, nt=3) with its defaults (compat,
     float64, torch ops only) on the card: iterations [37, 259, 296] and
     the Pr probes of tests/test_golden.py within rtol 3e-3
  8. reference: small grids on the card against the same solver's plain
     path on the CPU (the path the CPU tests hold against the JAX package):
     gpu nx=15, and multi nx=15 at eps_it=1e-9, where the extended
     phase runs (on K12)
  9. wide kernels: at the wide grid's 511x307x307 float32 shapes, K8 at
     s = 2 and 3 with the gpu operator against its plain version and
     against s K1 launches (bitwise, NaN-filled outputs, check value
     equal; its time per iteration over K1's in the same run and its
     launch plan printed), and K1, K3, K4, K5 and K13's two forms against
     their plain versions (K3, K5 and K13 bitwise as in phase 3; the counterparts there of
     the JAX package's lane-tiled K9a, K3t, K4t and K5t); phase 3 holds K8 at
     s = 2 on the 255 gpu and multi operators
 10. wide path: ChorinSolver(preset_gpu(nx=511, compat=False,
     dtype='float32')) for 2 steps from init_state with the sweep plan on
     (its default there: bodies of two K8 launches of s = 3), launch
     counts set to 0 just before and read just after: K8, K1, K3, K4 and
     K5 launched, K10 not (no form fits), no plain version ran; every
     solve converges, stored-state err below eps_it, finite fields; step
     1 again with the plan off must take the same counts and give
     bitwise-equal pr and pr_lo; one more step traced with torch.profiler
 11. dist kernels: K7-dist (the gpu and multi compat BC specs) and K2-dist
     (the split gpu and multi specs) on the shards of 255x153x153 over 3
     (x_off = 0, 85, 170), and K2-dist on the whole grid at x_off = 0 (K2's
     unfolded single-device form), each against its plain version with
     and without the check: every output and the check value bitwise;
     ms per launch (its device time from torch.profiler, and CUDA events
     around launches issued back to back), the plain version's, bytes and
     bound, and beside it the copy ceiling: scripts/copy_ceiling.cu's
     grid-stride float4 copy of as many MB, timed alike
 12. dist path: preset_multi(nx=255, dtype='float32') on a (3,1,1) mesh of
     cuda:0 shards (ChorinSolver.step_shard_map), 4 steps with compat off
     (K2-dist) and 2 with it on (K7-dist), launch counts set to 0 just
     before each run and read just after: its dist kernel the only kernel
     launched, no plain version; every field finite, every compat-off
     solve converged. Step 1's Poisson solve again on a (1,1,1) mesh from
     the same (pr, dprdtau, rhs): equal iterations and err, pr and dprdtau
     bitwise. Then one more step of each traced with torch.profiler: its
     wall, device busy time and idle share
 13. unchained kernels: K6 (advect_pre) at 255x153x153 float32 on
     seeded velocities at two scales (one with clamps): the four branches
     from their torch-op face averages (kernels/advect.py pre_velocities,
     NaN in the pads, which it must not read) in ONE launch (NaN-filled
     outputs) against its plain version and against K5 on the same
     velocities: bitwise, equal clamp counts; ms of the one launch for the
     four branches, the plain version's, MB, the bound and the share
 14. unchained path: ChorinSolver(preset_gpu(nx=255, compat=False,
     dtype='float32'), fused_step=False) for 4 steps from init_state,
     launch counts set to 0 just before and read just after: K6 1
     launch a step, K10 launched, K3, K4 and K5 not, no plain version;
     every solve converges, stored-state err below eps_it, finite fields;
     the counts printed beside phase 4's; one more step traced
 15. dma path: ChorinSolver(preset_gpu(nx=255, ...), poisson_mode='dma')
     for 4 steps from init_state, counts as in 14: K7 the only Poisson
     kernel, K3, K4 and K5 launched, no plain version; each step's
     iterations, err and exit (converged, stalled or the budget; no
     accuracy phase, so a float32 stall is a result); finite fields;
     step 1 again with use_pallas=False: equal counts, pr within MAX_ULP;
     K7 under the split gpu spec against its plain version (the function
     of the dma-mode kernel K11); one more step traced
 16. resident (run after phase 3): K10 (poisson_iter_resident, one
     launch of nit iterations resident on chip: dpr in shared memory,
     x-streamed columns) at
     63x38x38 with nit = 37 and at 255x153x153 with nit = 152, its plan
     required, checked against its rule and printed (the cut of the
     column plane, the column slots a block, the runs of planes a column,
     the shared memory a block: 38 x 2, 32, 32, 118784 B at 63 and 26 x
     5, 192, 5, 195840 B at 255 on 132 SMs), on resident_probe.py's
     seeded inputs (gpu operator): pr, dpr and the check value bitwise
     equal to nit K1 launches and to the plain version; K10's time and
     that of the nit K1 launches (device time from torch.profiler, and
     CUDA events); the design's ceiling (rhs from HBM, 12 B a cell and
     iteration at the rate of a warm copy of pr into a buffer as large)
     beside the JSON line's one-pass bound; at each grid the folded
     loop's K10 launch (poisson_loop_resident, from it0 = 1, the exit
     decisions on the card) over a budget of 6 checks, eps just above
     the third check value and a stall window of 2, against host-driven
     K10 launches of nit = nchk - it % nchk and its plain version: it
     ends partway, pr, dpr, the check values and the checks taken
     bitwise, one launch and no plain call;
     at 63 one Poisson solve (the gpu
     preset's first, K1 over its budget) whose first chunk runs on K10 and
     the rest in pt_loop_fused(seed0=True) on K1, with the launch counts
     set to 0 just before and read just after: the unseeded K1 loop's
     iterations, err and fields, bitwise; then K12
     (poisson_iter_resident_ext, nit of K2's iterations in one launch
     under K10's plan) at 63 (nit 37) and 255 (nit 152) on the same
     inputs (lo randn x 2**-24) with the multi operator: hi, lo, dpr and
     the check value bitwise equal to nit K2 launches and to the plain
     version; K12's time (torch.profiler and CUDA events), the nit K2
     launches' and the bound (20 B a cell and iteration). At 255, where
     a launch takes milliseconds, K10's and K12's device time from
     torch.profiler must agree within EVENTS_RTOL with CUDA events
     recorded around each of the same traced launches. The
     phase runs right after phase 3: later in the process the profiler
     was seen to keep none or one of five K10 launches at 255 in a window
     (the cause is not known)
 17. fdm solve: the fdm backend's direct solve alone at 255 (gpu
     variant, ops/fdm_poisson.py, refine=0) on a seeded RHS against the
     host's float64 solve (solve_host_f64), the relative error printed and
     bounded by FDM_SOLVE_RTOL; with TF32 turned on
     (set_float32_matmul_precision('high')) an unguarded product differs
     while the solve stays bitwise equal; its time (and that of its three
     forward transforms and of the modal division) against its bound, the
     FLOPs of six transforms at the float32 rate against the bytes of the
     RHS, the solution and the eigenbases at the HBM rate
 18. fdm paths: ChorinSolver with poisson_backend='fdm' for the gpu and the
     multi preset at 255, 4 steps each from init_state, launch counts set
     to 0 just before and read just after: K3, K4 and K5 launched, and
     K13's pair form (the refinement's residuals), no Poisson iteration
     kernel, no plain version; every step within fdm_refine
     refinement rounds, err and the stored-state error below eps_it,
     finite fields; the rounds and err per step beside the JAX package's
     record; K3 with the step's constants (the gpu variant's g_eff = g:
     no hydrostatic split under fdm) bitwise, K4 with the unsplit pressure
     within MAX_ULP and K5 bitwise, on the last state; one more step
     traced, its device time grouped into the transforms (cuBLAS), K3, K4,
     K5 and the elementwise rest, with the idle share; the gpu path's step
     1 again with TF32 on, every field bitwise equal
 19. io: run.main on the card, the multi preset at 63: --nt 4 --save
     --nsave 2 --checkpoint-every 2, then --resume --nt 6, against an
     uninterrupted --nt 6: the final checkpoints bitwise equal, the .bin
     frames of step 4 byte-identical to numpy's column-major writer, the
     native writer (csrc/ns3dio.cpp, g++) built
 20. compat_api: run_navierstokes3d(nx=63, nt=3) with its defaults
     (compat, float64) on the card: the golden iterations [37, 259, 296]
     and Pr probes; runme(do_vis=False, do_save=True, nx=63, nt=2): the
     CPU's iterations, finite fields, step_0.mat written
 21. fdm wide: the gpu preset with the fdm backend at 511x307x307 for 2
     steps, as phase 18 (K3 at g_eff = g bitwise there too)
 22. fullstep (run after phase 12, whose runs it is held against):
     preset_multi(nx=255, dtype='float32') on the same (3,1,1) mesh of
     cuda:0 shards through ChorinSolver.step_fullstep (every stage per
     shard on the owned-face layout), 4 steps with compat off (K2-dist) and
     2 with it on (K7-dist) from init_state, launch counts set to 0 just
     before each run and read just after: its dist kernel the only kernel
     launched, 3 launches per Poisson iteration, no plain version; every
     block finite, no clamps, every compat-off solve converged; the
     iterations equal to phase 12's, the final state (from_dist) within
     FULLSTEP_TOL of phase 12's (max abs difference printed, bitwise
     reported); s/step; one more step traced, its device time by group
     (the dist kernel, the torch ops by kind) and its idle share beside
     phase 12's
 23. float64 (the solver's dtype rule: float64 runs the plain versions on
     every device, as the JAX package's float32-only kernels make it do):
     preset_multi(nx=63, dtype='float64') for 8 steps on the card and on
     the CPU: iterations equal to each other and to the JAX package's
     (REF_ITERS_F64_63), fields within F64_TOL; preset_gpu(nx=255,
     dtype='float64') for 1 step: err below eps_it, iterations, s/step; no
     kernel launched in either
Each traced step launches a marker kernel first and counts what follows
it (the tracer may drop a launch at its window's edge), and says how many
of its K3 launches the trace holds. The line before the last is a JSON
object of per-kernel results (with each kernel's SASS counts and the
paths that launched it); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import navierstokes3d_tpu_torch as nt  # noqa: E402
from navierstokes3d_tpu_torch import kernels  # noqa: E402
from navierstokes3d_tpu_torch.kernels import _build  # noqa: E402
from navierstokes3d_tpu_torch.kernels import advect as k_advect  # noqa: E402
from navierstokes3d_tpu_torch.kernels import fused_step as k_step  # noqa: E402
from navierstokes3d_tpu_torch.kernels import poisson as k_poisson  # noqa: E402
from navierstokes3d_tpu_torch.parallel import (  # noqa: E402
    build_poisson_shard_map, make_mesh)
from navierstokes3d_tpu_torch.parallel.fullstep import (  # noqa: E402
    from_dist, to_dist)
from navierstokes3d_tpu_torch.ptloop import (  # noqa: E402
    ExitRule, pt_loop_fused)

NX = 255
NSTEPS = 4
# Poisson iterations per step of the JAX package's run of the gpu
# configuration from the same initial state (runs/long_r5.jsonl.gz):
# iteration counts, a wiring cross-check for the port (not times)
REF_ITERS = (4560, 3952, 3648, 3496)
# the multi preset at the reference's own invocation (nx=63,
# NavierStokes3D_multi_gpu.jl:538), 8 steps from init_state: the JAX
# package's hybrid main path in interpret mode on the CPU. XLA's CPU
# compilation contracts FMAs and rewrites divisions by constants, which
# the port's kernels do not, so a step whose loop exits on a check value
# at the float32 noise floor may take another count (PERF.md): held
# within 20%, and equality is reported
MULTI_NX_SMALL = 63
MULTI_STEPS_SMALL = 8
REF_ITERS_MULTI63 = (259, 296, 333, 407, 481, 592, 777, 888)
# tolerance of the remaining kernel-vs-plain comparisons in ulp: both
# round every operation in float32 in the same order (the kernels are
# built with --fmad=false), so the expected difference is 0; 4 ulp leaves
# room for a library division that rounds differently. K3, K5, K6, K7,
# K8 and the dist kernels are held bitwise.
MAX_ULP = 4
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s and float32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float32 operations per cell, counted from each kernel's expressions
# (csrc/*.cu): K1 16 for the Laplacian, 1 residual, 3 dpr, 2 pr'; K2 twice
# the Laplacian, 2 residual, 3 dpr, 2 u, 6 two_sum. K3, K4 and K5 are
# rounded counts of their stress/predictor/divergence, correction and
# face-average/displacement/trilinear expressions (K5 per branch). These
# counts make every bound here a bytes bound, but they count a division
# as one operation: K3's 22 IEEE divisions per point and K8's address and
# queue work issue far more instructions than these counts (the SASS
# counts chip_smoke prints beside each bound), so a kernel can be bound by
# instruction issue while its bound says bytes (PERF.md section 6)
FLOPS_PER_CELL = {"K1 poisson_iter": 22, "K2 poisson_iter_ext": 45,
                  "K3 predict": 71, "K4 correct": 12, "K5 advect": 50,
                  "K7 poisson_iter_bc": 20, "K8 poisson_iter_sweeps": 22,
                  "K7-dist poisson_iter_bc_dist": 20,
                  "K2-dist poisson_iter_ext_bc_dist": 45,
                  "K6 advect_pre": 40, "K10 poisson_iter_resident": 22,
                  "K12 poisson_iter_resident_ext": 45,
                  "K13 compensated_residual": 180,
                  "K13-pair pair_residual": 180}
# the largest share by which a resident kernel's device time from
# torch.profiler may differ from CUDA events around the same launches
# (agrees_with_events)
EVENTS_RTOL = 0.03
K1_NAME = "K1 poisson_iter"
K2_NAME = "K2 poisson_iter_ext"
K7_NAME = "K7 poisson_iter_bc"
K8_NAME = "K8 poisson_iter_sweeps"
K7D_NAME = "K7-dist poisson_iter_bc_dist"
K2D_NAME = "K2-dist poisson_iter_ext_bc_dist"
K6_NAME = "K6 advect_pre"
K10_NAME = "K10 poisson_iter_resident"
K12_NAME = "K12 poisson_iter_resident_ext"
K13_NAME = "K13 compensated_residual"
K13P_NAME = "K13-pair pair_residual"
# the dma-mode kernel, whose function K7's kernel computes: its row in the
# JSON line carries K7's numbers under the split gpu spec and K7's
# launches on the dma path
K11_ROW = {"name": "K11 poisson_iter_bc (dma mode)",
           "source": "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "replaces": "navierstokes3d_tpu/kernels/poisson.py:1451"}
# K10's phase: the 63x38x38 grid with nit = nchk, and 255 with nit = 152
RESIDENT_NX = (63, 255)
RESIDENT_NIT = {63: 37, 255: 152}
# the folded loop's K10 launch in phase 16: a budget of 6 checks from
# it0 = 1, eps just above the third check value, a stall window of 2
LOOP_CHECKS, LOOP_WINDOW = 6, 2
UNCHAINED_STEPS = 4
DMA_STEPS = 4
# the dist kernels' device symbols as the profiler names them (one kernel
# template over the pressure words: 1 for K7-dist, 2 for K2-dist)
DIST_SYMBOLS = {"K7": "poisson_dist_kernel<1>",
                "K2": "poisson_dist_kernel<2>"}
# the copy ceiling of the dist kernels' phase: scripts/copy_ceiling.cu, a
# grid-stride float4 copy of the bytes a kernel's bound counts, at these
# (threads per block, blocks per SM), the fastest kept
COPY_SOURCE = Path(__file__).resolve().parent / "scripts" / "copy_ceiling.cu"
COPY_GRIDS = ((256, 4), (256, 8), (1024, 1), (1024, 2))
# the distributed path: the multi preset at 255 over an x-only mesh of 3
# shards (bx = 85) on one card
DIST_SHAPE = (3, 1, 1)
DIST_STEPS = 4
DIST_COMPAT_STEPS = 2
# the fullstep phase: the same runs through step_fullstep, held against
# the shard_map runs' final states within FULLSTEP_TOL of max(1, max|f|)
# (tests/test_fullstep.py's float32 tolerance; the CPU tests find them
# bitwise equal); its traced step's torch ops grouped by kernel name
FULLSTEP_TOL = 2e-5
FULLSTEP_FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
FULLSTEP_GROUPS = (("cat and copy", re.compile(r"CatArray|copy", re.I)),
                   ("reductions", re.compile(r"reduce", re.I)),
                   ("index and gather", re.compile(r"index|gather|scatter",
                                                   re.I)),
                   ("elementwise", re.compile(r"elementwise", re.I)))
# the float64 phase: preset_multi(nx=63, float64, compat=False), 8 steps
# from init_state; the JAX package's Poisson iterations per step for it
# (its float64 step on the CPU with select-shift advection,
# NS3D_FUSED_INTERPRET=1), and the card's fields against the CPU's within
# F64_TOL of max(1, max|f|)
F64_STEPS = 8
REF_ITERS_F64_63 = (259, 296, 333, 407, 481, 518, 592, 666)
F64_TOL = 1e-9
# the wide grid of README.md's "Wide grids" (511x307x307), where the JAX
# package lane-tiles its kernels and runs temporal 3-sweeps
WIDE_NX = 511
WIDE_STEPS = 2
WIDE_SWEEPS = 3
COMPAT_STEPS = 4
# the fdm backend's paths: the gpu and multi presets at 255 for FDM_STEPS
# steps, the gpu preset at the wide grid for FDM_WIDE_STEPS; the solve
# alone at 255 against the host's float64 solve within FDM_SOLVE_RTOL of
# max|p| (float32 transforms of ~250 terms: ~1e-6 expected)
FDM_STEPS = 4
FDM_WIDE_STEPS = 2
FDM_SOLVE_RTOL = 1e-4
# the traced fdm step's groups: the kernels by their device symbols, the
# transforms by cuBLAS's kernel names, everything else elementwise
FDM_GROUPS = (("K3", "predict_kernel"), ("K4", "correct_kernel"),
              ("K5", "advect_kernel"))
MATMUL_NAME = re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE)
# the I/O round trip through run.main: the multi preset at 63
IO_NX = 63
# runme(nx=63, nt=2) with its defaults (gpu preset, compat, float64): the
# port's iterations on the CPU
RUNME_ITERS = [814, 814]
# the golden configuration and its values, copied from tests/test_golden.py
# (preset_multi(nx=63, nt=3), compat, float64, 3 steps from init_state):
# Poisson iterations per step and Pr at the reference test's 1-based probe
# indices (test/test3D.jl:8-10) of the gathered inner array
GOLDEN_ITERS = [37, 259, 296]
GOLDEN_INDS = (np.array([31, 38, 50, 51]) - 1, np.array([2, 5, 19, 31]) - 1,
               np.array([12, 13, 23, 23]) - 1)
PR_GOLDEN = np.array([
    [[5.263392464132383, 5.263392464132406, 5.263392464132561, 5.263392464132561],
     [5.263197114326912, 5.2631971143269265, 5.263197114327076, 5.263197114327076],
     [5.262254541896738, 5.262254541896746, 5.262254541896831, 5.262254541896831],
     [5.263111486701518, 5.263111486701521, 5.263111486701573, 5.263111486701573]],
    [[4.0822212326994824, 4.082221232699491, 4.082221232699574, 4.082221232699574],
     [4.082125496826624, 4.082125496826638, 4.082125496826718, 4.082125496826718],
     [4.081706386467998, 4.0817063864680065, 4.081706386468053, 4.081706386468053],
     [4.082080632033709, 4.082080632033712, 4.082080632033743, 4.082080632033743]],
    [[2.0459941629046665, 2.0459941629046714, 2.0459941629046963, 2.0459941629046963],
     [2.046025003044617, 2.04602500304462, 2.046025003044646, 2.046025003044646],
     [2.0459593473281243, 2.0459593473281297, 2.045959347328146, 2.045959347328146],
     [2.046036438445157, 2.0460364384451584, 2.0460364384451712, 2.0460364384451712]],
    [[1.8754330467584193, 1.8754330467584213, 1.8754330467584455, 1.8754330467584455],
     [1.875504878213699, 1.8755048782137014, 1.8755048782137227, 1.8755048782137227],
     [1.8754224534093715, 1.875422453409371, 1.875422453409388, 1.875422453409388],
     [1.8755454375148632, 1.8755454375148652, 1.8755454375148761, 1.8755454375148761]],
])


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float32
    tensors (+0 and -0 are equal; NaN counts as infinitely far)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if bool(torch.isnan(a).any() | torch.isnan(b).any()):
        return 2 ** 31
    return int(torch.max(torch.abs(ordered(a) - ordered(b))).item())


def max_abs(pairs) -> float:
    return max(float((x - y).abs().max()) for x, y in pairs)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str, warmup: int = 2,
              events: bool = False):
    """Mean device milliseconds of one launch of the kernel whose name
    contains `kernel`, over reps calls of fn traced with torch.profiler:
    the launches' own durations. (CUDA events around a run of launches
    that each take less device time than the host needs to issue the
    next one time the host's issue rate instead.) events=True returns
    (ms, the mean of CUDA events recorded around each of the same calls
    in the traced window), for a fn of one launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the tracer may drop a launch at the window's edge (the mean is over
    # those it kept; a spin kernel opens the window) and now and then a
    # whole window: trace it again then, and raise after five. Each window
    # must keep half of reps on its own. With events the spin is ten times
    # longer (~10 ms), so that the host has queued the first launch before
    # its start event fires
    spin = 20_000_000 if events else 2_000_000
    for _ in range(5):
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(reps if events else 0)]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(spin)
            for i in range(reps):
                if events:
                    marks[i][0].record()
                fn()
                if events:
                    marks[i][1].record()
            torch.cuda.synchronize()
        durs = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name]
        if len(durs) >= reps // 2:
            ms = sum(durs) / len(durs) / 1e3
            if not events:
                return ms
            return ms, sum(a.elapsed_time(b) for a, b in marks) / reps
        print(f"[trace] {len(durs)} launches of {kernel} traced, expected "
              f"{reps}: tracing again")
    raise RuntimeError(f"device_ms: five traced windows held too few "
                       f"launches of {kernel}")


def agrees_with_events(label: str, ms: float, events_ms: float) -> None:
    """Hold a kernel's device time from torch.profiler against CUDA events
    recorded around each of the same launches (device_ms(events=True)):
    where a launch takes a millisecond or more, the events' own cost is
    well under 1% of it, and the two may differ by at most EVENTS_RTOL.
    (Events around a run of launches differ more: at 255, launches issued
    back to back read 0.3-3.5% above the profiler, and launches queued
    behind a spin kernel 0.1% in one process and 3.9% in another; events
    around each launch behind the short spin read up to 1.9% above.)"""
    if events_ms >= 1.0:
        require(abs(ms - events_ms) <= EVENTS_RTOL * events_ms,
                f"{label}: {ms:.4f} ms by torch.profiler against "
                f"{events_ms:.4f} ms by CUDA events around the same "
                f"launches")


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn by CUDA events around reps
    calls queued behind a spin kernel, so that the host's issue rate does
    not enter: for a fn of one launch, that launch's time with the gap
    between two queued launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(name: str, tensors_in, tensors_out, cells: int,
          iters: int = 1) -> dict:
    """The least time the card could take for one launch: each distinct
    input read once and each output written once over the HBM rate,
    against the float32 operations (of `iters` iterations per cell) over
    the float32 rate."""
    distinct_in = {id(t): t for t in tensors_in}.values()
    nbytes = sum(t.numel() * t.element_size() for t in distinct_in) + sum(
        t.numel() * t.element_size() for t in tensors_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_CELL[name] * iters * cells / F32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device() -> str:
    require(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


# each kernel's device symbol in the library (the mangled name holds
# "<length><name>" then the template arguments): for its SASS counts (K7
# and K7-dist launch one symbol)
SYMBOLS = {K1_NAME: r"19poisson_iter_kernelE", K2_NAME:
           r"23poisson_iter_ext_kernelE", "K3 predict": r"14predict_kernelE",
           "K4 correct": r"14correct_kernelE", "K5 advect":
           r"13advect_kernelE", K6_NAME: r"17advect_pre_kernelE",
           K7_NAME: r"19poisson_dist_kernelILi1E", K8_NAME:
           r"21poisson_sweeps_kernelILi3E", K10_NAME:
           r"28poisson_resident_grid_kernelE", K12_NAME:
           r"27poisson_resident_ext_kernelE", K13_NAME:
           r"20comp_residual_kernelILi1E", K13P_NAME:
           r"20comp_residual_kernelILi2E", K7D_NAME:
           r"19poisson_dist_kernelILi1E", K2D_NAME:
           r"19poisson_dist_kernelILi2E"}
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)([^;]*);")


def sass_counts(lib: Path) -> dict:
    """Per kernel of SYMBOLS: its SASS instructions (cuobjdump -sass), its
    IEEE divisions (FCHK), and where it streams planes (K3, K8) those of
    its plane loop, from the loop's first barrier to the branch back above
    it. A kernel of one thread per point runs at most its whole count per
    point; K3's loop runs once per thread and plane, 512 threads per 420
    points; K8's once per plane for 4 cells at s levels."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        names = [k for k, sym in SYMBOLS.items() if re.search(sym, name)]
        if not names:
            continue
        ins = []
        for addr, op, rest in SASS_LINE.findall(fn):
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            ins.append((int(addr, 16), op.split(".")[0],
                        int(target.group(1), 16) if target else None))
        row = {"instructions": len(ins),
               "divisions": sum(op == "FCHK" for _, op, _ in ins)}
        bars = [i for i, (_, op, _) in enumerate(ins) if op == "BAR"]
        back = [i for i, (_, op, tgt) in enumerate(ins) if bars and op == "BRA"
                and tgt is not None and tgt <= ins[bars[0]][0]]
        if names[0] in ("K3 predict", K8_NAME) and back:
            loop = ins[bars[0]:max(back) + 1]
            row["plane_loop"] = len(loop)
            row["plane_loop_divisions"] = sum(op == "FCHK" for _, op, _ in loop)
        if names[0] == "K3 predict" and "plane_loop" in row:
            row["per_point"] = row["plane_loop"] * 512 / 420
        out.update(dict.fromkeys(names, row))
    for kernel, row in out.items():
        print(f"[sass] {kernel}: {row}")
    return out


def phase_build() -> dict:
    res = _build.build()
    print(f"[build] {res.path.name}: "
          + (f"compiled in {res.seconds:.1f} s" if res.compiled
             else "up to date"))
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}")
    _build.load()
    return sass_counts(res.path)


def seeded(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                        device="cuda")


def interior_seeded(rng, shape, scale):
    t = torch.zeros(shape, device="cuda")
    t[1:-1, 1:-1, 1:-1] = seeded(rng, *(n - 2 for n in shape), scale=scale)
    return t


def check_k1(op, pr, dpr0, rhs, label) -> tuple:
    """K1 against plain, with and without the check reduction."""
    worst_ulp, worst = 0, 0.0
    for check in (False, True):
        pa, da = torch.empty_like(pr), dpr0.clone()
        pb, db = torch.empty_like(pr), dpr0.clone()
        ea = k_poisson.poisson_iter(pr, pa, da, rhs, op, check)
        eb = k_poisson.poisson_iter_plain(pr, pb, db, rhs, op, check)
        torch.cuda.synchronize()
        worst_ulp = max(worst_ulp, max_ulp(pa, pb), max_ulp(da, db))
        worst = max(worst, max_abs(((pa, pb), (da, db))))
        if check:
            ra, rb = float(ea), float(eb)
            require(ra == rb, f"K1 ({label}) check err {ra} vs plain {rb}")
    require(worst_ulp <= MAX_ULP, f"K1 ({label}) differs by {worst_ulp} ulp")
    pa, da = torch.empty_like(pr), dpr0.clone()
    ms = cuda_ms(lambda: k_poisson.poisson_iter(pr, pa, da, rhs, op, False),
                 50)
    ms_chk = cuda_ms(lambda: k_poisson.poisson_iter(pr, pa, da, rhs, op,
                                                    True), 20)
    plain_ms = cuda_ms(
        lambda: k_poisson.poisson_iter_plain(pr, pa, da, rhs, op, False), 20)
    print(f"[kernels] K1 poisson_iter ({label}): max ulp {worst_ulp} max abs "
          f"{worst:.3e}; {ms:.4f} ms (check iteration {ms_chk:.4f} ms), "
          f"plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def check_k8(op, pr, dpr0, rhs, s, label) -> dict:
    """K8 at depth s against its plain version (MAX_ULP) and against s K1
    launches (bitwise, check value equal), with and without the check
    reduction; then its time, the plain version's and that of s K1
    launches, and its bound."""
    worst_ulp, worst = 0, 0.0
    for check in (False, True):
        po, do = (torch.full_like(pr, float("nan")) for _ in range(2))
        ek = k_poisson.poisson_iter_sweeps(pr, dpr0, rhs, po, do, op, s,
                                           check)
        pp, dp = torch.empty_like(pr), torch.empty_like(pr)
        ep = k_poisson.poisson_iter_sweeps_plain(pr, dpr0, rhs, pp, dp, op,
                                                 s, check)
        p, d, e1 = pr.clone(), dpr0.clone(), None
        for j in range(s):
            q = torch.empty_like(pr)
            e1 = k_poisson.poisson_iter(p, q, d, rhs, op,
                                        check and j == s - 1)
            p = q
        torch.cuda.synchronize()
        worst_ulp = max(worst_ulp, max_ulp(po, pp), max_ulp(do, dp))
        worst = max(worst, max_abs(((po, pp), (do, dp))))
        require(torch.equal(po.view(torch.int32), p.view(torch.int32))
                and torch.equal(do.view(torch.int32), d.view(torch.int32)),
                f"K8 s={s} ({label}) differs from {s} K1 launches")
        if check:
            vk, vp, v1 = float(ek), float(ep), float(e1)
            require(vk == vp == v1, f"K8 s={s} ({label}) check err {vk}, "
                    f"plain {vp}, K1 {v1}")
        del p, d, q, pp, dp
    require(worst_ulp <= MAX_ULP,
            f"K8 s={s} ({label}) differs by {worst_ulp} ulp")
    po, do = torch.empty_like(pr), torch.empty_like(pr)
    ms = cuda_ms(lambda: k_poisson.poisson_iter_sweeps(
        pr, dpr0, rhs, po, do, op, s, False), 20)
    ms_chk = cuda_ms(lambda: k_poisson.poisson_iter_sweeps(
        pr, dpr0, rhs, po, do, op, s, True), 10)
    plain_ms = cuda_ms(lambda: k_poisson.poisson_iter_sweeps_plain(
        pr, dpr0, rhs, po, do, op, s, False), 5)
    pa, da = torch.empty_like(pr), dpr0.clone()
    k1_ms = cuda_ms(lambda: k_poisson.poisson_iter(pr, pa, da, rhs, op,
                                                   False), 20)
    b = bound(K8_NAME, (pr, dpr0, rhs), (po, do), pr.numel(), iters=s)
    plan = k_poisson.sweep_plan(
        tuple(pr.shape), s, torch.cuda.get_device_properties(
            0).multi_processor_count)
    print(f"[kernels] {K8_NAME} s={s} ({label}): max ulp {worst_ulp}, "
          f"bitwise equal to {s} K1 launches; {ms:.4f} ms (check "
          f"{ms_chk:.4f} ms) = {ms / s:.4f} ms per iteration against K1's "
          f"{k1_ms:.4f} ms ({ms / s / k1_ms:.3f} of it); plain "
          f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}"
          f", {b['bytes'] / 1e6:.1f} MB), kernel at "
          f"{100 * b['bound_ms'] / ms:.1f}% of it; plan {plan.blocks} blocks"
          f" of {plan.ry}x{plan.w} regions ({plan})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, k1_ms=k1_ms,
                per_iteration_over_k1=ms / s / k1_ms,
                plan=dataclasses.asdict(plan), **b)


@contextlib.contextmanager
def nan_outputs():
    """New float tensors from torch.empty / empty_like start as NaN inside
    the block, so an output cell a kernel leaves unwritten shows."""
    empty, empty_like = torch.empty, torch.empty_like

    def nan(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t
    torch.empty = lambda *a, **kw: nan(empty(*a, **kw))
    torch.empty_like = lambda *a, **kw: nan(empty_like(*a, **kw))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def check_k3(vx, vy, vz, masks, k, label) -> float:
    """K3 (NaN-filled outputs) against its plain version: vx*, vy*, vz*
    and divv bitwise. Returns the largest absolute difference."""
    with nan_outputs():
        a = k_step.predict(vx, vy, vz, masks, k)
    b = k_step.predict_plain(vx, vy, vz, masks, k)
    torch.cuda.synchronize()
    for name, x, y in zip(("vx*", "vy*", "vz*", "divv"), a, b):
        require(bitwise(x, y), f"K3 ({label}, {tuple(vx.shape)}): {name} "
                f"differs from its plain version by {max_abs([(x, y)])}")
    print(f"[kernels] K3 predict ({label}, {vx.shape[0] - 1}x{vx.shape[1]}x"
          f"{vx.shape[2]}): vx*, vy*, vz* and divv bitwise equal to the plain "
          "version")
    return max_abs(zip(a, b))


def check_k5(fields, k, window, label) -> tuple[int, float]:
    """K5's one launch and its one-branch launches (NaN-filled outputs)
    against the plain version: each field bitwise, the clamp counts
    equal. Returns the clamp count and the largest absolute difference."""
    vx, vy, vz = fields[:3]
    with nan_outputs():
        a = k_advect.advect(*fields, k, window)
    n1 = torch.zeros((1,), dtype=torch.int32, device="cuda")
    n_plain, err = 0, 0.0
    for name, f, out in zip(("vx", "vy", "vz", "c"), fields, a[:4]):
        with nan_outputs():
            one = k_advect.advect_branch(name, f, vx, vy, vz, k, window, n1)
        ref, ncl = k_advect.advect_branch_plain(name, f, vx, vy, vz, k, window)
        torch.cuda.synchronize()
        n_plain += int(ncl.item())
        diff = max_abs([(out, ref), (one, ref)])
        require(bitwise(out, ref) and bitwise(one, ref),
                f"K5 {name} ({label}, {tuple(vx.shape)}) differs from its "
                f"plain version by {diff}")
        err = max(err, diff)
        del one, ref
    n_all, n_one = int(a[4].item()), int(n1.item())
    require(n_all == n_one == n_plain, f"K5 ({label}) clamp counts: one "
            f"launch {n_all}, per branch {n_one}, plain {n_plain}")
    print(f"[kernels] K5 advect ({label}, {vx.shape[0] - 1}x{vx.shape[1]}x"
          f"{vx.shape[2]}): the four fields bitwise equal to the plain "
          f"version in one launch and per branch, clamped {n_all} in all "
          "three")
    return n_all, err


def k5_row(fields, k, window, phase, err: float) -> dict:
    """K5's numbers: the one launch of the four branches (its bytes: the
    three velocities and the tracer in, the four fields out), the plain
    version's four branches, the four one-branch launches, and the bound
    of four one-branch launches beside the launch's own."""
    vx, vy, vz, c = fields
    reps = 10 if vx.numel() < 5e7 else 5
    ms = cuda_ms(lambda: k_advect.advect(*fields, k, window), reps)
    four_ms = cuda_ms(lambda: [k_advect.advect_branch(
        name, f, vx, vy, vz, k, window)
        for name, f in zip(("vx", "vy", "vz", "c"), fields)], reps)
    plain_ms = cuda_ms(lambda: k_advect.advect(*fields, k, window,
                                               plain=True), 1, warmup=0)
    b = bound("K5 advect", fields, fields, sum(f.numel() for f in fields))
    per = [bound("K5 advect", (f, vx, vy, vz), (f,), f.numel())
           for f in fields]
    four = sum(p["bound_ms"] for p in per)
    print(f"[{phase}] K5 advect: one launch {ms:.4f} ms (four one-branch "
          f"launches {four_ms:.4f} ms), plain {plain_ms:.4f} ms; at "
          f"{100 * four / ms:.1f}% of the four branches' bounds "
          f"({four:.4f} ms), {100 * b['bound_ms'] / ms:.1f}% of the one "
          f"launch's ({b['bound_ms']:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                four_launches_ms=four_ms, four_branch_bounds_ms=four, **b)


def k13_inputs(solver, rng) -> tuple:
    """A seeded pressure pair near a solution of the solver's folded
    Poisson problem: hi, its lo word at the rounding level, and the rhs
    pair (whole-grid, 0 on the ring) at hi's float64 folded Laplacian plus
    noise of 1e-3, so that r is as small as after a solve, where every
    rounding of the compensated arithmetic shows in it."""
    g = solver.grid
    shape = (g.nx, g.ny, g.nz)
    hi = solver.set_bc_pr(seeded(rng, *shape, scale=50.0))
    lo = seeded(rng, *shape, scale=50.0 * 2.0 ** -24)
    q = {k: v[0].double() + v[1].double()
         for k, v in solver._op.quads.items()}
    p = hi.double()
    pc = p[1:-1, 1:-1, 1:-1]
    lap = ((p[2:, 1:-1, 1:-1] - pc) * q["xp"] + (p[:-2, 1:-1, 1:-1] - pc)
           * q["xm"] + (p[1:-1, 2:, 1:-1] - pc) * q["yp"]
           + (p[1:-1, :-2, 1:-1] - pc) * q["ym"] + (p[1:-1, 1:-1, 2:] - pc)
           * q["zp"] + (p[1:-1, 1:-1, :-2] - pc) * q["zm"])
    del p, pc
    lap += torch.tensor(rng.normal(size=lap.shape) * 1e-3, device="cuda")
    rh, rl = torch.zeros_like(hi), torch.zeros_like(hi)
    rh[1:-1, 1:-1, 1:-1] = lap.float()
    rl[1:-1, 1:-1, 1:-1] = (lap - lap.float().double()).float()
    return hi, lo, rh, rl


def check_k13(solver, label, rng, time_it=True) -> dict:
    """K13's two forms against their plain versions on k13_inputs: r (with
    its 0 ring for the single word) and max|r| bitwise, the pair form
    with r and without; then each form's device time (torch.profiler),
    its plain version's (CUDA events) and its bound (16 B a cell). Returns
    a row for each form's name."""
    op, inner = solver._op, (slice(1, -1),) * 3
    hi, lo, rh, rl = k13_inputs(solver, rng)
    r1, e1 = k_poisson.compensated_residual(hi, rh, rl, op)
    r0, e0 = k_poisson.compensated_residual_plain(hi, rh, rl, op)
    require(bitwise(r1, r0) and float(e1) == float(e0),
            f"K13 ({label}): r or max|r| {float(e1)} differs from the plain "
            f"version's {float(e0)}")
    args = (hi, lo, rh[inner], rl[inner], op)
    r2, e2 = k_poisson.pair_residual(*args)
    q0, f0 = k_poisson.pair_residual_plain(*args)
    m2 = k_poisson.pair_residual_max(*args)
    require(bitwise(r2, q0) and float(e2) == float(f0) == float(m2),
            f"K13-pair ({label}): r or max|r| {float(e2)}, {float(m2)} "
            f"differs from the plain version's {float(f0)}")
    print(f"[kernels] K13 ({label}): bitwise, max|r| {float(e1):.9e} "
          f"(single word), {float(e2):.9e} (pair)")
    if not time_it:
        return {}
    cells, rows = hi.numel(), {}
    for name, fn, plain, ins, outs in (
            (K13_NAME, lambda: k_poisson.compensated_residual(hi, rh, rl, op),
             lambda: k_poisson.compensated_residual_plain(hi, rh, rl, op),
             (hi, rh, rl), (r1,)),
            (K13P_NAME, lambda: k_poisson.pair_residual_max(*args),
             lambda: k_poisson.pair_residual_plain(*args),
             (hi, lo, rh, rl), ())):
        ms = device_ms(fn, 20, "comp_residual_kernel")
        plain_ms = cuda_ms(plain, 3, warmup=1)
        rows[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          **bound(name, ins, outs, cells))
        r = rows[name]
        print(f"[kernels] {name} ({label}, {'x'.join(map(str, hi.shape))}): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB), kernel at "
              f"{100 * r['bound_ms'] / ms:.1f}% of it")
    return rows


def phase_kernels(gpu, multi) -> dict:
    """Each kernel against its plain version on identical inputs, at the
    main paths' shapes."""
    rng = np.random.default_rng(2024)
    g, k, masks = gpu.grid, gpu._consts, gpu.masks
    nx, ny, nz = g.nx, g.ny, g.nz
    cells = nx * ny * nz
    vx = seeded(rng, nx + 1, ny, nz, scale=0.5) + 1.0
    vy = seeded(rng, nx, ny + 1, nz, scale=0.3)
    vz = seeded(rng, nx, ny, nz + 1, scale=0.3)
    pr = seeded(rng, nx, ny, nz, scale=50.0)
    results = {}

    # K1 with the gpu operator and with the multi one (x-lo zero-gradient)
    rhs = seeded(rng, nx, ny, nz, scale=1e5)
    dpr0 = interior_seeded(rng, (nx, ny, nz), 1e3)
    require(not gpu._op.zero_grad_x and multi._op.zero_grad_x,
            "operators: gpu x-lo Dirichlet, multi x-lo zero-gradient")
    err, ms, plain_ms = check_k1(gpu._op, pr, dpr0, rhs, "gpu operator")
    err_m, ms_m, _ = check_k1(multi._op, pr, dpr0, rhs, "multi operator")
    results["K1 poisson_iter"] = dict(
        max_abs_err=max(err, err_m), ms=ms, plain_ms=plain_ms,
        **bound("K1 poisson_iter", (pr, dpr0, rhs), (pr, dpr0), cells))
    # K8 at s = 2 (the function of the untiled two-sweep K8b) with both
    # operators; its row's main numbers come from the wide phase
    results[K8_NAME] = {"at_255_s2": {
        label: check_k8(solver._op, pr, dpr0, rhs, 2, f"{label} operator")
        for label, solver in (("gpu", gpu), ("multi", multi))}}

    # K2 at the multi preset's shapes: a seeded (hi, lo) pair with lo at
    # the rounding level of hi, with and without the check reduction
    op = multi._op
    hi = multi.set_bc_pr(seeded(rng, nx, ny, nz, scale=50.0))
    lo = seeded(rng, nx, ny, nz, scale=50.0 * 2.0 ** -24)
    worst_ulp, worst = 0, 0.0
    for check in (False, True):
        a = [torch.full_like(hi, float("nan")), torch.full_like(hi,
                                                                float("nan")),
             dpr0.clone()]
        b = [torch.empty_like(hi), torch.empty_like(hi), dpr0.clone()]
        ea = k_poisson.poisson_iter_ext(hi, lo, *a, rhs, op, check)
        eb = k_poisson.poisson_iter_ext_plain(hi, lo, *b, rhs, op, check)
        torch.cuda.synchronize()
        worst_ulp = max(worst_ulp, *(max_ulp(x, y) for x, y in zip(a, b)))
        worst = max(worst, max_abs(zip(a, b)))
        if check:
            ra, rb = float(ea), float(eb)
            require(ra == rb, f"K2 check err {ra} vs plain {rb}")
            print(f"[kernels] K2 check err {ra:.9e} plain {rb:.9e}")
    require(worst_ulp <= MAX_ULP, f"K2 differs by {worst_ulp} ulp")
    outs = [torch.empty_like(hi), torch.empty_like(hi), dpr0.clone()]
    ms = cuda_ms(lambda: k_poisson.poisson_iter_ext(hi, lo, *outs, rhs, op,
                                                    False), 50)
    ms_chk = cuda_ms(lambda: k_poisson.poisson_iter_ext(hi, lo, *outs, rhs,
                                                        op, True), 20)
    plain_ms = cuda_ms(lambda: k_poisson.poisson_iter_ext_plain(
        hi, lo, *outs, rhs, op, False), 20)
    print(f"[kernels] K2 poisson_iter_ext: max ulp {worst_ulp} max abs "
          f"{worst:.3e}; {ms:.4f} ms (check iteration {ms_chk:.4f} ms), "
          f"plain {plain_ms:.4f} ms")
    results["K2 poisson_iter_ext"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound("K2 poisson_iter_ext", (hi, lo, dpr0, rhs), (hi, lo, dpr0),
                cells))

    # K3 with both presets' masks and constants, NaN-filled outputs
    err = max(check_k3(vx, vy, vz, solver.masks, solver._consts,
                       f"{label} preset")
              for label, solver in (("gpu", gpu), ("multi", multi)))
    ms = cuda_ms(lambda: k_step.predict(vx, vy, vz, masks, k), 20)
    plain_ms = cuda_ms(lambda: k_step.predict_plain(vx, vy, vz, masks, k), 5)
    print(f"[kernels] K3 predict: {ms:.4f} ms, plain {plain_ms:.4f} ms")
    mask_bytes = (masks.mask_vx, masks.mask_vy, masks.mask_vz)
    results["K3 predict"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound("K3 predict", (vx, vy, vz, *mask_bytes),
                k_step.predict(vx, vy, vz, masks, k), cells))

    # K4 with each variant's BC stack
    worst, times = 0.0, {}
    for solver in (gpu, multi):
        kk = solver._consts
        a = k_step.correct(vx, vy, vz, pr, masks, kk)
        b = k_step.correct_plain(vx, vy, vz, pr, masks, kk)
        u = max(max_ulp(x, y) for x, y in zip(a, b))
        require(u <= MAX_ULP, f"K4 ({kk.variant}) differs by {u} ulp")
        worst = max(worst, max_abs(zip(a, b)))
        ms = cuda_ms(lambda: k_step.correct(vx, vy, vz, pr, masks, kk), 20)
        plain_ms = cuda_ms(
            lambda: k_step.correct_plain(vx, vy, vz, pr, masks, kk), 5)
        times[kk.variant] = (ms, plain_ms)
        print(f"[kernels] K4 correct ({kk.variant}): max ulp {u}; {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms")
    require(bool((a[0][0] == multi.cfg.physics.vin).all()),
            "K4 (multi) inlet plane")
    results["K4 correct"] = dict(
        max_abs_err=worst, ms=times["gpu"][0], plain_ms=times["gpu"][1],
        **bound("K4 correct", (vx, vy, vz, pr, *mask_bytes), a, cells))

    # K5, once with sub-window displacements and once with clamped points
    c = torch.tensor(rng.uniform(size=(nx, ny, nz)).astype(np.float32),
                     device="cuda")
    err = 0.0
    for scale in (0.5, 2.5):
        ncl, e = check_k5((vx * scale, vy * scale, vz * scale, c), k,
                          gpu.advect_k, f"velocity scale {scale}")
        err = max(err, e)
        require((ncl > 0) == (scale > 1.0),
                f"K5 case of velocity scale {scale}: {ncl} clamped points")
    results["K5 advect"] = k5_row((vx, vy, vz, c), k, gpu.advect_k, "kernels",
                                  err)
    # K13's two forms with each preset's operator, timed with the gpu one
    del vx, vy, vz, c
    check_k13(multi, "multi operator", rng, time_it=False)
    results.update(check_k13(gpu, "gpu operator", rng))
    for name, r in results.items():
        if name == K8_NAME:
            continue
        print(f"[kernels] {name}: bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB per launch"
              f"); kernel at {100 * r['bound_ms'] / r['ms']:.1f}% of it")
    return results


def phase_k7(solvers) -> dict:
    """K7 against its plain version with each compat solver's BC spec (the
    unsplit gpu one first: its Dirichlet planes are two more inputs)."""
    fields = k7_inputs(solvers[0].grid.shape_c)
    rows = [check_k7_spec(s._bc_op, fields, f"{s.cfg.variant} compat spec",
                          "kernels") for s in solvers]
    r = dict(rows[0])
    r["max_abs_err"] = max(row["max_abs_err"] for row in rows)
    return {K7_NAME: r}


def run_steps(solver, nsteps: int, label: str, ref_iters=None,
              clamps_allowed: bool = False):
    """nsteps of a main path from init_state with the launch counts set to
    0 just before and read just after. Returns (counts, iters, states,
    stats) with states[i] the state entering step i+1 (and the last one
    after) and stats[i] step i+1's StepStats."""
    g, eps_it = solver.grid, solver.cfg.numerics.eps_it
    state = solver.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    wall, iters, ext, states, all_stats = [], [], [], [state], []
    for step in range(nsteps):
        t0 = time.perf_counter()
        state, stats = solver.step(state)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        iters.append(stats.iters)
        ext.append(stats.iters_ext)
        states.append(state)
        all_stats.append(stats)
        ref = "" if ref_iters is None else f" (JAX {ref_iters[step]})"
        print(f"[{label}] step {step + 1}: iters {stats.iters}{ref} "
              f"iters_ext {stats.iters_ext} err {float(stats.err):.6e} "
              f"advect_clamped {stats.advect_clamped} wall "
              f"{wall[-1]:.3f} s", flush=True)
        require(bool(np.isfinite(stats.err)) and stats.err < eps_it,
                f"{label} step {step + 1} did not converge "
                f"(err {stats.err})")
        require(stats.iters < g.niter,
                f"{label} step {step + 1} used the whole budget {g.niter}")
        require(clamps_allowed or stats.advect_clamped == 0,
                f"{label} step {step + 1} clamped {stats.advect_clamped}")
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo"):
            require(bool(torch.isfinite(getattr(state, name)).all()),
                    f"{label} step {step + 1}: non-finite {name}")
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    total = sum(wall)
    print(f"[{label}] {total / nsteps:.4f} s/step, "
          f"{sum(iters) / total:.1f} Poisson iterations/s "
          f"({sum(iters)} iterations, {sum(e or 0 for e in ext)} of them "
          f"K2 or defect "
          f"correction, in {total:.3f} s)")
    for name, (launches, plain) in counts.items():
        print(f"[{label}] {name}: {launches} launches, plain version "
              f"{plain} calls")
        require(plain == 0, f"{label}: {name} ran its plain version")
    return counts, iters, states, all_stats


def stored_errs(solver, states, label, steps, required=True) -> list:
    """The stored-state criterion of the given steps (read after the
    counts: each predictor snapshot launches K3 once more). required=False
    only reports it: where the extended hybrid's phase 1 converges on its
    own float32 check, the JAX package returns (pr1, 0) with no
    stored-state re-evaluation (models/chorin.py:1583-1586), and the port
    does the same."""
    out = []
    for step in steps:
        err = solver.stored_residual_err(
            states[step], divv=solver.predictor_divv(states[step - 1]))
        print(f"[{label}] stored-state err of step {step}: "
              f"{float(err):.6e}")
        if required:
            require(float(err) < solver.cfg.numerics.eps_it,
                    f"{label} stored-state err {err} at step {step}")
        out.append(float(err))
    return out


def profile_step(solver, state, label, step=None) -> dict:
    """One more step of a main path (solver.step, or `step`) traced with
    torch.profiler (after its counts were read; the same step runs once
    before it untraced, as the profiler's warm-up): device time per kernel
    name, biggest first, and the device's idle share of the span from the
    first kernel's start to the last one's end. Returns the traced wall
    (s), the iterations, the busy and span times (us) and the per-name
    (us, launches)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the tracer drops launches at the start of its window (a wide-grid
    # trace lost K3, the step's first kernel): the same step runs first as
    # the schedule's warm-up, and a spin kernel of ~1 ms opens the active
    # window; the spin and the window's own range are not counted
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    run = solver.step if step is None else step
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        run(state)
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        k3_before = k_step.predict.launches
        t0 = time.perf_counter()
        _, stats = run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    ivs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name
                 and not e.name.startswith("ProfilerStep"))
    print(f"[{label} trace] next step: iters {stats.iters} iters_ext "
          f"{stats.iters_ext}, wall {wall * 1e3:.2f} ms (traced)")
    k3_traced = sum("predict_kernel" in iv[2] for iv in ivs)
    if k_step.predict.launches > k3_before:
        print(f"[{label} trace] K3 launched "
              f"{k_step.predict.launches - k3_before} times, traced "
              f"{k3_traced} times")
    if not ivs:
        print(f"[{label} trace] the profiler recorded no device time")
        return dict(wall=wall, iters=stats.iters, busy=0.0, span=0.0,
                    by_name={})
    by_name, busy, cur_s, cur_e = {}, 0.0, ivs[0][0], ivs[0][1]
    for s, e, name in ivs:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e - s, n + 1)
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = ivs[-1][1] - ivs[0][0]
    for name, (us, n) in sorted(by_name.items(), key=lambda t: -t[1][0]):
        print(f"[{label} trace] {us / 1e3:10.3f} ms {n:6d} launches "
              f"{us / n:9.2f} us each {100 * us / busy:6.2f}% of busy  "
              f"{name[:70]}")
    print(f"[{label} trace] device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms kernel span: idle "
          f"{100 * (1 - busy / span):.2f}%; {len(ivs)} kernels")
    return dict(wall=wall, iters=stats.iters, busy=busy, span=span,
                by_name=by_name)


def phase_gpu_path(solver) -> dict:
    counts, iters, states, _ = run_steps(solver, NSTEPS, "gpu", REF_ITERS)
    # the folded loops run one K10 launch a loop at 255; the defect phase
    # one K13 launch a step
    for name in (K10_NAME, K13_NAME, "K3 predict", "K4 correct",
                 "K5 advect"):
        require(counts[name][0] > 0, f"gpu: {name} never launched")
    stored_errs(solver, states, "gpu", [NSTEPS])
    profile_step(solver, states[-1], "gpu")
    require(tuple(iters) == REF_ITERS,
            f"gpu iterations {iters} differ from the JAX package's "
            f"{REF_ITERS}")
    return counts


def k12_count(label, counts, stats) -> None:
    """Print K12's launches and iterations on a multi path beside its
    steps' extended iterations."""
    print(f"[{label}] K12: {counts[K12_NAME][0]} launches carrying "
          f"{k_poisson.poisson_iter_resident_ext.iterations} iterations, K2 "
          f"{counts[K2_NAME][0]} launches; iters_ext "
          f"{[st.iters_ext for st in stats]}")


def phase_multi_paths(multi) -> list:
    counts, _, states, stats = run_steps(multi, NSTEPS, "multi")
    k12_count("multi", counts, stats)
    for name in (K10_NAME, K12_NAME, "K3 predict", "K4 correct",
                 "K5 advect"):
        require(counts[name][0] > 0, f"multi: {name} never launched")
    stored_errs(multi, states, "multi", range(1, NSTEPS + 1))
    profile_step(multi, states[-1], "multi")
    del states
    small = nt.ChorinSolver(nt.preset_multi(nx=MULTI_NX_SMALL,
                                            compat=False, dtype="float32"),
                            device="cuda")
    counts63, iters, states, stats = run_steps(small, MULTI_STEPS_SMALL,
                                               "multi63", REF_ITERS_MULTI63)
    k12_count("multi63", counts63, stats)
    stored_errs(small, states, "multi63", range(1, MULTI_STEPS_SMALL + 1),
                required=False)
    for name in (K10_NAME, K12_NAME, "K3 predict", "K4 correct",
                 "K5 advect"):
        require(counts63[name][0] > 0, f"multi63: {name} never launched")
    for step, (got, ref) in enumerate(zip(iters, REF_ITERS_MULTI63)):
        require(abs(got - ref) <= 0.2 * ref,
                f"multi63 step {step + 1} iterations {got} not within 20% "
                f"of {ref}")
    print(f"[multi63] iterations equal to the JAX package's: "
          f"{tuple(iters) == REF_ITERS_MULTI63}")
    return [counts, counts63]


def finite_state(state) -> bool:
    return all(bool(torch.isfinite(getattr(state, n)).all())
               for n in ("pr", "vx", "vy", "vz", "c", "dprdtau"))


def phase_compat(solver, label) -> dict:
    """COMPAT_STEPS compat steps from init_state with the launch counts set
    to 0 just before and read just after; then step 1 (or the steps up to
    a blow-up) again with use_pallas=False, the plain versions."""
    k7 = next(kk for kk in kernels.KERNELS if kk.name == K7_NAME)
    state = solver.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    wall, iters, states, blown = [], [], [state], None
    for step in range(COMPAT_STEPS):
        n0 = k7.wrapper.launches
        t0 = time.perf_counter()
        state, stats = solver.step(state)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        iters.append(stats.iters)
        states.append(state)
        finite = finite_state(state)
        print(f"[{label}] step {step + 1}: iters {stats.iters} err "
              f"{float(stats.err):.6e} {wall[-1]:.4f} s/step, K7 launches "
              f"{k7.wrapper.launches - n0}"
              + ("" if finite else "; NON-FINITE fields"), flush=True)
        if not finite and blown is None:
            blown = step + 1
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    total = sum(wall)
    print(f"[{label}] {total / COMPAT_STEPS:.4f} s/step, "
          f"{sum(iters) / total:.1f} Poisson iterations/s ({sum(iters)} "
          f"iterations in {total:.3f} s)")
    for name, (launches, plain) in counts.items():
        print(f"[{label}] {name}: {launches} launches, plain version "
              f"{plain} calls")
        require(plain == 0, f"{label}: {name} ran its plain version")
        require((launches > 0) == (name == K7_NAME),
                f"{label}: {name} launched {launches} times")
    # the plain versions on the card: step 1, or up to a blow-up
    plain = nt.ChorinSolver(solver.cfg.replace(use_pallas=False), "cuda")
    st = plain.init_state()
    for step in range(blown or 1):
        st, stats = plain.step(st)
        require(stats.iters == iters[step],
                f"{label} step {step + 1}: plain run iterations "
                f"{stats.iters}, kernel run {iters[step]}")
    if blown is None:
        u = max_ulp(st.pr, states[1].pr)
        print(f"[{label}] step 1 with use_pallas=False: iters {iters[0]} "
              f"equal, pr max ulp {u}")
        require(u <= MAX_ULP, f"{label}: plain run's pr differs by {u} ulp")
    else:
        require(not finite_state(st),
                f"{label}: the kernel run turned non-finite at step "
                f"{blown}, the plain run did not")
        print(f"[{label}] non-finite from step {blown} in the plain run "
              f"too, with equal counts: the reference's gpu blow-up")
    profile_step(solver, states[-1], label)
    return counts


def phase_golden() -> None:
    """The repo's golden configuration on the card: float64 compat, torch
    ops only (no kernel launches, no plain version)."""
    s = nt.ChorinSolver(nt.preset_multi(nx=63, nt=3), device="cuda")
    require(s.cfg.compat and s.dtype == torch.float64,
            "golden: the preset defaults are compat, float64")
    kernels.reset_counts()
    state, iters = s.init_state(), []
    t0 = time.perf_counter()
    for _ in range(3):
        state, stats = s.step(state)
        iters.append(stats.iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c, pr, vx, vy, vz = nt.gather_inner(state)
    probe = pr[np.ix_(*GOLDEN_INDS)]
    rel = float(np.max(np.abs(probe / PR_GOLDEN - 1.0)))
    print(f"[golden] multi 63x38x38 float64 compat on the card: iters "
          f"{iters} (tests/test_golden.py: {GOLDEN_ITERS}), Pr probes max "
          f"rel diff {rel:.3e}, max|Vz| {np.abs(vz).max():.3e}, "
          f"{wall / 3:.3f} s/step")
    require(iters == GOLDEN_ITERS, f"golden iterations {iters}")
    require(np.allclose(probe, PR_GOLDEN, rtol=3e-3, atol=1e-8),
            f"golden Pr probes differ by {rel} (rtol 3e-3)")
    require(float(np.abs(vz).max()) < 1e-10, "golden: Vz was advected")
    for kk in kernels.KERNELS:
        require(kk.wrapper.launches == 0 and kk.plain.calls == 0,
                f"golden: {kk.name} ran")


def compare_with_cpu(cfg, label) -> None:
    """The port on the card against the same solver's plain path on the
    CPU, 2 steps: equal iteration, accuracy-phase and clamp counts, pr
    within 1e-5 (step 1) and 1e-3 (step 2) of max|pr| (the CPU tests'
    standard against the JAX package)."""
    gpu, cpu = nt.ChorinSolver(cfg, "cuda"), nt.ChorinSolver(cfg, "cpu")
    a, b = gpu.init_state(), cpu.init_state()
    for step, tol in enumerate((1e-5, 1e-3)):
        a, sa = gpu.step(a)
        b, sb = cpu.step(b)
        pa, pb = a.pr.cpu().numpy(), b.pr.numpy()
        scale = max(1.0, float(np.abs(pb).max()))
        dp = float(np.abs(pa - pb).max()) / scale
        print(f"[reference] {label} step {step + 1}: iters {sa.iters}/"
              f"{sb.iters} iters_ext {sa.iters_ext}/{sb.iters_ext} clamped "
              f"{sa.advect_clamped}/{sb.advect_clamped} pr diff {dp:.3e}")
        require((sa.iters, sa.iters_ext, sa.advect_clamped)
                == (sb.iters, sb.iters_ext, sb.advect_clamped),
                f"{label}: card and CPU counts differ")
        require(dp <= tol, f"{label}: card and CPU pr differ by {dp}")


def phase_reference() -> None:
    compare_with_cpu(nt.preset_gpu(nx=15, dtype="float32", compat=False),
                     "gpu nx=15")
    multi = nt.preset_multi(nx=15, dtype="float32", compat=False)
    multi = multi.replace(numerics=dataclasses.replace(multi.numerics,
                                                       eps_it=1e-9))
    kernels.reset_counts()
    compare_with_cpu(multi, "multi nx=15 eps_it=1e-9")
    k12 = next(kk for kk in kernels.KERNELS if kk.name == K12_NAME)
    require(k12.wrapper.launches > 0,
            "multi nx=15 eps_it=1e-9: K12 never launched")


def phase_kernels_wide(wide, results) -> None:
    """At the wide grid's shapes: K8 at s = 2 and 3 (its main numbers are
    s = 3's, the depth the wide path runs), and one launch each of K1, K3,
    K4 and K5 against its plain version (timed once: K5's plain version
    takes ~0.2 s a launch there), into results[name]['wide']."""
    rng = np.random.default_rng(2026)
    g, k, masks = wide.grid, wide._consts, wide.masks
    nx, ny, nz = g.nx, g.ny, g.nz
    cells = nx * ny * nz
    pr = wide.set_bc_pr(seeded(rng, nx, ny, nz, scale=50.0))
    rhs = seeded(rng, nx, ny, nz, scale=1e5)
    dpr0 = interior_seeded(rng, (nx, ny, nz), 1e3)
    for s in (2, WIDE_SWEEPS):
        r = check_k8(wide._op, pr, dpr0, rhs, s, f"{nx}, gpu operator")
        results[K8_NAME][f"at_{nx}_s{s}"] = r
    results[K8_NAME].update(results[K8_NAME][f"at_{nx}_s{WIDE_SWEEPS}"])

    err, ms, plain_ms = check_k1(wide._op, pr, dpr0, rhs,
                                 f"{nx}, gpu operator")
    wide_rows = {K1_NAME: dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(K1_NAME, (pr, dpr0, rhs), (pr, dpr0), cells))}
    del pr, rhs, dpr0

    vx = seeded(rng, nx + 1, ny, nz, scale=0.5) + 1.0
    vy = seeded(rng, nx, ny + 1, nz, scale=0.3)
    vz = seeded(rng, nx, ny, nz + 1, scale=0.3)
    pr = seeded(rng, nx, ny, nz, scale=50.0)
    mask_bytes = (masks.mask_vx, masks.mask_vy, masks.mask_vz)
    err = check_k3(vx, vy, vz, masks, k, "gpu preset")
    wide_rows["K3 predict"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: k_step.predict(vx, vy, vz, masks, k), 5),
        plain_ms=cuda_ms(lambda: k_step.predict_plain(vx, vy, vz, masks, k),
                         1, warmup=0),
        **bound("K3 predict", (vx, vy, vz, *mask_bytes),
                k_step.predict(vx, vy, vz, masks, k), cells))
    a = k_step.correct(vx, vy, vz, pr, masks, k)
    b = k_step.correct_plain(vx, vy, vz, pr, masks, k)
    u = max(max_ulp(x, y) for x, y in zip(a, b))
    require(u <= MAX_ULP, f"K4 at {nx}: differs by {u} ulp")
    wide_rows["K4 correct"] = dict(
        max_abs_err=max_abs(zip(a, b)),
        ms=cuda_ms(lambda: k_step.correct(vx, vy, vz, pr, masks, k), 5),
        plain_ms=cuda_ms(lambda: k_step.correct_plain(vx, vy, vz, pr, masks,
                                                      k), 1, warmup=0),
        **bound("K4 correct", (vx, vy, vz, pr, *mask_bytes), a, cells))
    print(f"[wide kernels] K4 correct: max ulp {u}")
    del a, b
    c = torch.tensor(rng.uniform(size=(nx, ny, nz)).astype(np.float32),
                     device="cuda")
    fields = (vx, vy, vz, c)
    err = max(check_k5(tuple(f * scale for f in fields[:3]) + (c,), k,
                       wide.advect_k, f"velocity scale {scale}")[1]
              for scale in (1.0, 2.5))
    wide_rows["K5 advect"] = k5_row(fields, k, wide.advect_k, "wide kernels",
                                    err)
    del vx, vy, vz, pr, c, fields
    wide_rows.update(check_k13(wide, f"{nx}, gpu operator", rng))
    for name, r in wide_rows.items():
        print(f"[wide kernels] {name} at {nx}x{ny}x{nz}: max abs "
              f"{r['max_abs_err']:.3e}; {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB per launch);"
              f" kernel at {100 * r['bound_ms'] / r['ms']:.1f}% of it")
        results[name]["wide"] = r


def phase_wide_path(wide, smi) -> dict:
    """The wide grid's main path: WIDE_STEPS steps with the sweep plan on
    (its default there), then step 1 again with it off, then a traced
    step."""
    g = wide.grid
    budget = (g.niter // g.nchk) * g.nchk
    s = wide._sweep_plan(budget)
    print(f"[wide] grid {g.nx}x{g.ny}x{g.nz} float32, niter {g.niter}, nchk "
          f"{g.nchk}, accuracy phase {wide.acc}, sweep depths "
          f"{wide._sweep_depths}, plan: bodies of two K8 launches of s={s} "
          f"({smi})")
    require(s == WIDE_SWEEPS, f"wide: sweep plan s={s}")
    counts, iters, states, stats = run_steps(wide, WIDE_STEPS, "wide",
                                             clamps_allowed=True)
    for name in (K8_NAME, K1_NAME, "K3 predict", "K4 correct", "K5 advect"):
        require(counts[name][0] > 0, f"wide: {name} never launched")
    require(counts[K10_NAME][0] == 0, "wide: K10 launched (no form fits)")
    for step in range(WIDE_STEPS):
        print(f"[wide] step {step + 1}: K8 bodies of {2 * s} iterations, "
              f"advect_clamped {stats[step].advect_clamped}")
    stored_errs(wide, states, "wide", range(1, WIDE_STEPS + 1))
    # step 1 with the plan off: K1 bodies, the same iterations
    depths, wide._sweep_depths = wide._sweep_depths, ()
    kernels.reset_counts()
    t0 = time.perf_counter()
    st, st_stats = wide.step(states[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wide._sweep_depths = depths
    k8 = next(kk for kk in kernels.KERNELS if kk.name == K8_NAME)
    require(k8.wrapper.launches == 0, "wide: K8 launched with the plan off")
    print(f"[wide] step 1 with the plan off: iters {st_stats.iters} "
          f"iters_ext {st_stats.iters_ext}, {wall:.3f} s, "
          f"{st_stats.iters / wall:.1f} Poisson iterations/s ({smi})")
    require((st_stats.iters, st_stats.iters_ext)
            == (stats[0].iters, stats[0].iters_ext),
            f"wide: plan off took {st_stats.iters}/{st_stats.iters_ext}, "
            f"plan on {stats[0].iters}/{stats[0].iters_ext}")
    for name in ("pr", "pr_lo"):
        a, b = getattr(st, name), getattr(states[1], name)
        require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                f"wide: {name} with the plan off differs")
    print("[wide] plan off: equal counts, pr and pr_lo bitwise equal")
    del st
    profile_step(wide, states[-1], "wide")
    return counts


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def dist_operators() -> dict:
    """The dist kernels' BC operators at 255: K7-dist's with the compat
    specs of both variants (the gpu one unsplit), K2-dist's with the main
    paths' (the gpu one split)."""
    ops = {}
    for variant, make in (("gpu", nt.preset_gpu), ("multi", nt.preset_multi)):
        cfg = make(nx=NX, dtype="float32")
        g = nt.make_grid(cfg)
        for kind, split in (("K7", False), ("K2", variant == "gpu")):
            ops[(kind, variant)] = k_poisson.make_bc_operator(
                k_poisson.poisson_bc_spec(variant, g, cfg.physics, split), g,
                "cuda")
    return ops


@functools.cache
def copy_library() -> ctypes.CDLL:
    """scripts/copy_ceiling.cu, built with the port's nvcc flags."""
    lib = _build.BUILD_DIR / f"libcopy_ceiling_{_build.build_key()}.so"
    if not lib.exists():
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib), str(COPY_SOURCE)], check=True,
                       capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.ns3d_copy_float4.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_long, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    cdll.ns3d_copy_float4.restype = ctypes.c_int
    return cdll


@functools.cache
def copy_ms(mb: int) -> tuple[float, str]:
    """The copy ceiling at mb MB and how it was timed: device ms of the
    fastest grid-stride float4 copy of mb/2 MB into as many (COPY_GRIDS),
    as the dist kernels are timed (torch.profiler, 20 launches after
    warm-up). Where the tracer keeps none of its launches (it has lost
    whole windows of this ctypes-launched kernel), the copy, one launch a
    call, is timed by `queued_ms` instead."""
    n4 = mb * 10 ** 6 // 32
    src = torch.rand(4 * n4, device="cuda")
    dst = torch.empty_like(src)
    sms = _build.sm_count(src.device)
    fn = copy_library().ns3d_copy_float4

    def run(threads, per_sm):
        _build.check(fn(src.data_ptr(), dst.data_ptr(), n4, per_sm * sms,
                        threads, _build.stream_of(src)), "copy_float4")
    try:
        best = min(device_ms(lambda: run(*grid), 20, "copy_float4_kernel")
                   for grid in COPY_GRIDS), "profiler"
    except RuntimeError as e:
        print(f"[trace] {e}: the copy by CUDA events behind a spin kernel")
        best = min(queued_ms(lambda: run(*grid), 20)
                   for grid in COPY_GRIDS), "CUDA events behind a spin"
    require(torch.equal(src, dst), "copy_float4 copied wrongly")
    return best


def check_dist(kind, op, fields, x_off, bx, label) -> dict:
    """One shard of K7-dist (kind 'K7') or K2-dist ('K2') at global offset
    x_off against its plain version, with and without the check: every
    output and the check value bitwise. Then its ms per launch, the plain
    version's and its bound (the shard's planes, the halo planes it reads
    and the Dirichlet planes of the faces it holds, each once; its
    outputs)."""
    pr, lo, dpr, rhs = fields
    nx = pr.shape[0]
    sl = slice(x_off, x_off + bx)

    def halo(t):
        return (t[x_off - 1] if x_off > 0 else None,
                t[x_off + bx] if x_off + bx < nx else None)
    if kind == "K7":
        name, nout = K7D_NAME, 2
        ins, halos = (pr[sl], dpr[sl], rhs[sl]), halo(pr)
        fns = (k_poisson.poisson_iter_bc_dist,
               k_poisson.poisson_iter_bc_dist_plain)
    else:
        name, nout = K2D_NAME, 3
        ins, halos = (pr[sl], lo[sl], dpr[sl], rhs[sl]), (*halo(pr),
                                                           *halo(lo))
        fns = (k_poisson.poisson_iter_ext_bc_dist,
               k_poisson.poisson_iter_ext_bc_dist_plain)

    def run(fn, outs, check):
        return fn(*ins, *outs, *halos, x_off, op, check)
    worst = 0.0
    for check in (False, True):
        a = [torch.full_like(ins[0], float("nan")) for _ in range(nout)]
        b = [torch.full_like(ins[0], float("nan")) for _ in range(nout)]
        ea, eb = run(fns[0], a, check), run(fns[1], b, check)
        torch.cuda.synchronize()
        worst = max(worst, max_abs(zip(a, b)))
        require(all(bitwise(x, y) for x, y in zip(a, b)),
                f"{name} ({label}) differs from its plain version by "
                f"{worst}")
        if check:
            require(float(ea) == float(eb), f"{name} ({label}) check err "
                    f"{float(ea)} vs plain {float(eb)}")
        del a, b
    outs = [torch.empty_like(ins[0]) for _ in range(nout)]
    kname = DIST_SYMBOLS[kind]
    ms = device_ms(lambda: run(fns[0], outs, False), 50, kname)
    ms_chk = device_ms(lambda: run(fns[0], outs, True), 20, kname)
    issue_ms = cuda_ms(lambda: run(fns[0], outs, False), 50)
    plain_ms = cuda_ms(lambda: run(fns[1], outs, False), 10)
    planes = [t for t, held in ((op.xlo, x_off == 0), (op.xhi, x_off + bx
                                                        == nx))
              if t is not None and held]
    b = bound(name, (*ins, *(h for h in halos if h is not None), *planes),
              outs, ins[0].numel())
    mb = round(b["bytes"] / 1e6)
    copy, copy_timing = copy_ms(mb)
    print(f"[dist kernels] {name} ({label}): bitwise equal to its plain "
          f"version; {ms:.4f} ms of device time (check iteration "
          f"{ms_chk:.4f} ms), {issue_ms:.4f} ms per launch issued back to "
          f"back (CUDA events), plain {plain_ms:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bytes'] / 1e6:.1f} "
          f"MB per launch), kernel at {100 * b['bound_ms'] / ms:.1f}% of it; "
          f"a copy of {mb} MB {copy:.4f} ms ({copy_timing}; "
          f"{100 * b['bound_ms'] / copy:.1f}% of the bound)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                events_ms=issue_ms, **b)


def phase_dist_kernels() -> dict:
    """K7-dist and K2-dist on the first, middle and last shard of the
    255 grid over DIST_SHAPE, for two BC specs each, and K2-dist on the
    whole grid. The JSON row's numbers are the middle shard's with the
    multi spec (the dist path's)."""
    rng = np.random.default_rng(2027)
    g = nt.make_grid(nt.preset_multi(nx=NX))
    shape = g.shape_c
    fields = (seeded(rng, *shape, scale=50.0),
              seeded(rng, *shape, scale=50.0 * 2.0 ** -24),
              interior_seeded(rng, shape, 1e3), seeded(rng, *shape, scale=1e5))
    ops = dist_operators()
    bx = NX // DIST_SHAPE[0]
    rows = {}
    for kind in ("K7", "K2"):
        for variant in ("gpu", "multi"):
            for x_off in range(0, NX, bx):
                rows[(kind, variant, x_off)] = check_dist(
                    kind, ops[(kind, variant)], fields, x_off, bx,
                    f"{variant} spec, shard at x_off {x_off} of {bx} planes")
    whole = check_dist("K2", ops[("K2", "multi")], fields, 0, NX,
                       "multi spec, the whole grid (K2-unfolded)")
    results = {}
    for kind, name in (("K7", K7D_NAME), ("K2", K2D_NAME)):
        r = dict(rows[(kind, "multi", bx)])
        r["max_abs_err"] = max(v["max_abs_err"] for k, v in rows.items()
                               if k[0] == kind)
        r["shards"] = {f"{v} x_off {x}": {key: rows[(kind, v, x)][key]
                                          for key in ("ms", "events_ms",
                                                      "plain_ms",
                                                      "bound_ms")}
                       for (k, v, x) in rows if k == kind}
        results[name] = r
    results[K2D_NAME]["whole_grid"] = {key: whole[key] for key in (
        "max_abs_err", "ms", "events_ms", "plain_ms", "bound_ms",
        "bound_by")}
    return results


def run_dist(compat: bool, nsteps: int, mesh, smi) -> dict:
    """nsteps of the multi preset at 255 through step_shard_map(mesh), the
    launch counts set to 0 just before and read just after; then step 1's
    solve on a one-shard mesh, and one more step traced."""
    label = "dist compat" if compat else "dist"
    s = nt.ChorinSolver(nt.preset_multi(nx=NX, compat=compat,
                                        dtype="float32"), device="cuda")
    g, eps_it = s.grid, s.cfg.numerics.eps_it
    on = K7D_NAME if compat else K2D_NAME
    print(f"[{label}] grid {g.nx}x{g.ny}x{g.nz} float32 on a "
          f"{'x'.join(map(str, mesh.shape))} mesh of {mesh.devices[0]} "
          f"shards, niter {g.niter}, nchk {g.nchk}, stall exit {s._stall}, "
          f"{on} per shard ({smi})")
    step = s.step_shard_map(mesh)
    state = s.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    states, all_stats, wall = [state], [], []
    for k in range(nsteps):
        t0 = time.perf_counter()
        state, stats = step(state)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        states.append(state)
        all_stats.append(stats)
        print(f"[{label}] step {k + 1}: iters {stats.iters} err "
              f"{float(stats.err):.6e} advect_clamped {stats.advect_clamped}"
              f" {wall[-1]:.4f} s/step, "
              f"{1e3 * wall[-1] / max(stats.iters, 1):.4f} ms per iteration",
              flush=True)
        require(finite_state(state), f"{label} step {k + 1}: non-finite "
                "fields")
        if not compat:
            require(bool(np.isfinite(stats.err)) and stats.err < eps_it
                    and stats.iters < g.niter,
                    f"{label} step {k + 1} did not converge "
                    f"(iters {stats.iters}, err {stats.err})")
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    iters = sum(st.iters for st in all_stats)
    print(f"[{label}] {sum(wall) / nsteps:.4f} s/step, "
          f"{1e3 * sum(wall) / iters:.4f} ms per iteration, "
          f"{iters / sum(wall):.1f} Poisson iterations/s ({iters} "
          f"iterations in {sum(wall):.3f} s; {smi})")
    for name, (launches, plain) in counts.items():
        print(f"[{label}] {name}: {launches} launches ({launches / nsteps:.1f}"
              f" per step), plain version {plain} calls")
        require(plain == 0, f"{label}: {name} ran its plain version")
        require((launches > 0) == (name == on),
                f"{label}: {name} launched {launches} times")
    # step 1's solve again on one shard: the same algorithm undecomposed
    solve1 = build_poisson_shard_map(
        make_mesh((1, 1, 1), mesh.devices[0]), g, s.cfg.physics, eps_it,
        s.cfg.variant, torch.float32, pressure_split=s.pressure_split,
        stall=s._stall, use_pallas=True, extended=s.extended)
    st0 = states[0]
    divv = k_step.predict_ops(st0.vx, st0.vy, st0.vz, s.masks, s._consts)[3]
    t0 = time.perf_counter()
    p1, d1, it1, err1, _ = solve1(st0.pr, st0.dprdtau,
                                  (s.cfg.physics.rho / g.dt) * divv)
    torch.cuda.synchronize()
    w1 = time.perf_counter() - t0
    same = bitwise(p1, states[1].pr) and bitwise(d1, states[1].dprdtau)
    print(f"[{label}] step 1's solve on a 1x1x1 mesh: iters {it1} err "
          f"{float(err1):.6e} ({all_stats[0].iters}, "
          f"{float(all_stats[0].err):.6e} on {mesh.size} shards), pr and "
          f"dprdtau bitwise equal: {same}; {w1:.4f} s, "
          f"{1e3 * w1 / max(it1, 1):.4f} ms per iteration")
    require(it1 == all_stats[0].iters and err1 == all_stats[0].err and same,
            f"{label}: the one-shard solve differs from the sharded one")
    final = states[-1]
    del states
    tr = profile_step(s, final, label, step=step)
    print(f"[{label} trace] traced step: wall {tr['wall'] * 1e3:.2f} ms, "
          f"device busy {tr['busy'] / 1e3:.3f} ms, idle "
          f"{100 * (1 - tr['busy'] / max(tr['span'], 1e-9)):.2f}% of the "
          f"{tr['span'] / 1e3:.3f} ms kernel span ({smi})")
    n = max(tr["iters"], 1)
    kern_us = sum(us for name, (us, _) in tr["by_name"].items()
                  if DIST_SYMBOLS["K7" if compat else "K2"] in name)
    print(f"[{label} trace] per iteration: wall {1e3 * tr['wall'] / n:.4f} "
          f"ms, the dist kernel {kern_us / 1e3 / n:.4f} ms of device time, "
          f"device busy {tr['busy'] / 1e3 / n:.4f} ms ({tr['iters']} "
          f"iterations; {smi})")
    return dict(counts=counts, iters=[st.iters for st in all_stats],
                err=[st.err for st in all_stats], state=final, trace=tr)


def phase_dist_path(smi) -> list:
    """The shard_map runs (compat off, then on): their counts, iterations,
    final states and traces, which the fullstep phase is held against."""
    mesh = make_mesh(DIST_SHAPE, "cuda:0")
    return [run_dist(False, DIST_STEPS, mesh, smi),
            run_dist(True, DIST_COMPAT_STEPS, mesh, smi)]


def group_breakdown(prof: dict, label: str, kernel_symbol: str) -> dict:
    """One traced step's device time by group: the dist kernel (its
    device symbol), then the torch ops by kind (FULLSTEP_GROUPS, the rest
    'other'), with the idle share."""
    groups = dict.fromkeys(("dist kernel", *(k for k, _ in FULLSTEP_GROUPS),
                            "other"), 0.0)
    for name, (us, _) in prof["by_name"].items():
        key = "dist kernel" if kernel_symbol in name else next(
            (k for k, rx in FULLSTEP_GROUPS if rx.search(name)), "other")
        groups[key] += us
    busy, span = prof["busy"], prof["span"]
    require(busy > 0, f"{label}: the traced step recorded no device time")
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / busy:.1f}%)"
                      for k, v in groups.items())
    print(f"[{label} trace] by group: {parts}; busy {busy / 1e3:.3f} ms, "
          f"idle {100 * (1 - busy / span):.2f}% of the kernel span, wall "
          f"{prof['wall'] * 1e3:.2f} ms")
    return groups


def idle(prof: dict) -> float:
    return 100 * (1 - prof["busy"] / max(prof["span"], 1e-9))


def run_fullstep(compat: bool, nsteps: int, mesh, smi, dist: dict) -> dict:
    """nsteps of the multi preset at 255 through step_fullstep(mesh) from
    init_state, the launch counts set to 0 just before and read just
    after: its dist kernel the only kernel launched, mesh.size launches
    per Poisson iteration, no plain version; every block finite, no
    clamps, every compat-off solve converged; the iterations beside (and
    equal to) the shard_map run's, the final state against it; then one
    more step traced, by group, its idle share beside the shard_map
    run's."""
    label = "fullstep compat" if compat else "fullstep"
    s = nt.ChorinSolver(nt.preset_multi(nx=NX, compat=compat,
                                        dtype="float32"), device="cuda")
    g, eps_it = s.grid, s.cfg.numerics.eps_it
    on = K7D_NAME if compat else K2D_NAME
    require(s._dist_kernels(mesh), f"{label}: the kernel loop is off")
    print(f"[{label}] grid {g.nx}x{g.ny}x{g.nz} float32 on a "
          f"{'x'.join(map(str, mesh.shape))} mesh of {mesh.devices[0]} "
          f"shards (one card: the schedule and the kernels, not an exchange "
          f"between cards), every stage per shard, {on} per shard ({smi})")
    step = s.step_fullstep(mesh)
    d = to_dist(s.init_state(), mesh)
    torch.cuda.synchronize()
    kernels.reset_counts()
    iters, wall = [], []
    for k in range(nsteps):
        t0 = time.perf_counter()
        d, stats = step(d)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        iters.append(stats.iters)
        print(f"[{label}] step {k + 1}: iters {stats.iters} (shard_map "
              f"{dist['iters'][k]}) err {float(stats.err):.6e} advect_clamped"
              f" {stats.advect_clamped} {wall[-1]:.4f} s/step", flush=True)
        require(all(bool(torch.isfinite(b).all()) for f in FULLSTEP_FIELDS
                    for b in getattr(d, f)),
                f"{label} step {k + 1}: non-finite fields")
        require(stats.advect_clamped == 0,
                f"{label} step {k + 1} clamped {stats.advect_clamped}")
        if not compat:
            require(bool(np.isfinite(stats.err)) and stats.err < eps_it
                    and stats.iters < g.niter,
                    f"{label} step {k + 1} did not converge "
                    f"(iters {stats.iters}, err {stats.err})")
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    print(f"[{label}] {sum(wall) / nsteps:.4f} s/step, "
          f"{1e3 * sum(wall) / sum(iters):.4f} ms per iteration ({sum(iters)}"
          f" iterations in {sum(wall):.3f} s; {smi})")
    for name, (launches, plain) in counts.items():
        print(f"[{label}] {name}: {launches} launches, plain version "
              f"{plain} calls")
        require(plain == 0, f"{label}: {name} ran its plain version")
        require((launches > 0) == (name == on),
                f"{label}: {name} launched {launches} times")
    require(counts[on][0] == mesh.size * sum(iters),
            f"{label}: {counts[on][0]} launches of {on} for {sum(iters)} "
            f"iterations on {mesh.size} shards")
    print(f"[{label}] iterations {iters}, the shard_map path's "
          f"{dist['iters']} in this run: equal {iters == dist['iters']}")
    require(iters == dist["iters"],
            f"{label}: iterations {iters} differ from the shard_map path's "
            f"{dist['iters']}")
    got, want = from_dist(d), dist["state"]
    same = True
    for f in FULLSTEP_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        diff = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        same = same and bitwise(a, b)
        print(f"[{label}] {f}: max abs difference from the shard_map path "
              f"{diff:.3e} (tolerance {FULLSTEP_TOL:g} x {scale:.4g})")
        require(diff <= FULLSTEP_TOL * scale,
                f"{label}: {f} differs from the shard_map path by {diff}")
    print(f"[{label}] every field bitwise equal to the shard_map path's: "
          f"{same}")
    del got, want
    tr = profile_step(s, d, label, step=step)
    sym = DIST_SYMBOLS["K7" if compat else "K2"]
    group_breakdown(tr, label, sym)
    print(f"[{label} trace] idle {idle(tr):.2f}% against the shard_map "
          f"path's {idle(dist['trace']):.2f}% in this run; wall "
          f"{tr['wall'] * 1e3:.2f} ms against {dist['trace']['wall'] * 1e3:.2f}"
          f" ms ({smi})")
    return counts


def phase_fullstep(smi, dist: list) -> list:
    mesh = make_mesh(DIST_SHAPE, "cuda:0")
    return [run_fullstep(False, DIST_STEPS, mesh, smi, dist[0]),
            run_fullstep(True, DIST_COMPAT_STEPS, mesh, smi, dist[1])]


def phase_float64(smi) -> list:
    """float64 outside compat on the card, by the solver's dtype rule (the
    JAX package's: its kernels are float32-only, so float64 runs the
    plain versions everywhere): the multi preset at 63 for F64_STEPS steps
    against the same run on the CPU and the JAX package's counts, and one
    step of the gpu preset at 255. No kernel may launch."""
    out = []
    cfg = nt.preset_multi(nx=MULTI_NX_SMALL, compat=False, dtype="float64")
    card = nt.ChorinSolver(cfg, device="cuda")
    cpu = nt.ChorinSolver(cfg, device="cpu")
    require(card.plain, "float64 on the card: the kernel routes are on")
    print(f"[f64] multi {card.grid.nx}x{card.grid.ny}x{card.grid.nz} "
          f"float64 on the card and on the CPU, {F64_STEPS} steps; "
          f"accuracy phase {card.acc}; the dtype rule routes every kernel "
          f"to its plain version ({smi})")
    runs = {}
    for label, s in (("card", card), ("cpu", cpu)):
        st = s.init_state()
        kernels.reset_counts()
        t0, iters, errs = time.perf_counter(), [], []
        for _ in range(F64_STEPS):
            st, stats = s.step(st)
            iters.append(stats.iters)
            errs.append(float(stats.err))
        if label == "card":
            torch.cuda.synchronize()
            counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
                      for kk in kernels.KERNELS}
            out.append(counts)
        w = time.perf_counter() - t0
        runs[label] = (iters, st)
        print(f"[f64] {label}: iterations {iters}, err "
              f"{[f'{e:.6e}' for e in errs]}, {w / F64_STEPS:.4f} s/step")
    print(f"[f64] the JAX package's float64 counts (CPU): {REF_ITERS_F64_63}")
    for name, (launches, plain) in out[0].items():
        print(f"[f64] {name}: {launches} launches, plain version {plain} "
              f"calls")
        require(launches == 0, f"f64: {name} launched {launches} times")
    require(runs["card"][0] == runs["cpu"][0] == list(REF_ITERS_F64_63),
            f"f64: iterations card {runs['card'][0]}, CPU {runs['cpu'][0]}, "
            f"JAX {REF_ITERS_F64_63}")
    for f in FULLSTEP_FIELDS:
        a, b = getattr(runs["card"][1], f).cpu(), getattr(runs["cpu"][1], f)
        diff = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        print(f"[f64] {f} after step {F64_STEPS}: card - CPU max abs "
              f"{diff:.3e} (tolerance {F64_TOL:g} x {scale:.4g}), bitwise "
              f"{bitwise(a, b)}")
        require(diff <= F64_TOL * scale, f"f64: {f} differs by {diff}")
    del runs, card, cpu
    gpu = nt.ChorinSolver(nt.preset_gpu(nx=NX, compat=False,
                                        dtype="float64"), device="cuda")
    g = gpu.grid
    st = gpu.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    st, stats = gpu.step(st)
    torch.cuda.synchronize()
    w = time.perf_counter() - t0
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    print(f"[f64 gpu] {g.nx}x{g.ny}x{g.nz} float64 (the reference's own "
          f"dtype and size), step 1: iters {stats.iters} err "
          f"{float(stats.err):.6e} (eps_it {gpu.cfg.numerics.eps_it}), "
          f"advect_clamped {stats.advect_clamped}, {w:.3f} s/step, "
          f"{1e3 * w / max(stats.iters, 1):.4f} ms per iteration ({smi})")
    require(stats.err < gpu.cfg.numerics.eps_it and stats.iters < g.niter,
            f"f64 gpu step 1 did not converge ({stats.iters}, {stats.err})")
    require(finite_state(st), "f64 gpu: non-finite fields")
    for name, (launches, plain) in counts.items():
        require(launches == 0, f"f64 gpu: {name} launched {launches} times")
    print(f"[f64 gpu] kernel launches 0 (plain calls: "
          f"{ {n: c[1] for n, c in counts.items() if c[1]} })")
    out.append(counts)
    return out


def nan_pads(branch, vels):
    """K6's operands with NaN in the pads of the branch's staggered axis
    (its write mask must keep them unread)."""
    axis = k_advect._PAD_AXIS[branch]
    out = []
    for v in vels:
        v = v.clone()
        if axis is not None:
            v.select(axis, 0).fill_(float("nan"))
            v.select(axis, -1).fill_(float("nan"))
        out.append(v)
    return out


def phase_unchained_kernels(solver) -> dict:
    """K6's one launch for the four branches from their torch-op face
    averages against its plain version and against K5 on the same
    velocities, at the main path's shapes, once with sub-window
    displacements and once with clamps."""
    rng = np.random.default_rng(2028)
    g, k, w = solver.grid, solver._consts, solver.advect_k
    nx, ny, nz = g.nx, g.ny, g.nz
    vx0 = seeded(rng, nx + 1, ny, nz, scale=0.5) + 1.0
    vy0 = seeded(rng, nx, ny + 1, nz, scale=0.3)
    vz0 = seeded(rng, nx, ny, nz + 1, scale=0.3)
    c = torch.tensor(rng.uniform(size=(nx, ny, nz)).astype(np.float32),
                     device="cuda")
    names = ("vx", "vy", "vz", "c")
    worst = 0.0
    for scale in (0.5, 2.5):
        vx, vy, vz = vx0 * scale, vy0 * scale, vz0 * scale
        fields = dict(zip(names, (vx, vy, vz, c)))
        vels = {name: k_advect.pre_velocities(name, vx, vy, vz)
                for name in names}
        n6 = torch.zeros((1,), dtype=torch.int32, device="cuda")
        n0 = k_advect.advect_pre.launches
        with nan_outputs():
            o6 = k_advect.advect_pre(fields, {name: nan_pads(name, v) for
                                              name, v in vels.items()}, k, w,
                                     n6)
        require(k_advect.advect_pre.launches == n0 + 1,
                "K6: the four branches took more than one launch")
        o5 = k_advect.advect(vx, vy, vz, c, k, w)
        op, n_plain = k_advect.advect_pre_plain(fields, vels, k, w)
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            worst = max(worst, float((o6[name] - op[name]).abs().max()))
            require(bitwise(o6[name], op[name]), f"K6 {name} (scale "
                    f"{scale}) differs from its plain version by {worst}")
            require(bitwise(o6[name], o5[i]), f"K6 {name} (scale {scale}) "
                    "differs from K5")
        n6, n5, n_plain = (int(n6.item()), int(o5[4].item()),
                           int(n_plain.item()))
        require(n6 == n_plain == n5, f"K6 clamp count {n6}, plain "
                f"{n_plain}, K5 {n5} (scale {scale})")
        require((n6 > 0) == (scale > 1.0),
                f"K6 case of velocity scale {scale}: {n6} clamped points")
        print(f"[unchained kernels] K6 advect_pre (velocity scale {scale}):"
              f" the four branches in one launch bitwise equal to the plain "
              f"version and to K5, clamped {n6} in all three")
        del o6, o5, op, vels
    fields = dict(zip(names, (vx0, vy0, vz0, c)))
    vels = {name: k_advect.pre_velocities(name, vx0, vy0, vz0)
            for name in names}
    ms = device_ms(lambda: k_advect.advect_pre(fields, vels, k, w), 20,
                   "advect_pre_kernel")
    events_ms = cuda_ms(lambda: k_advect.advect_pre(fields, vels, k, w), 20)
    plain_ms = cuda_ms(lambda: k_advect.advect_pre_plain(fields, vels, k, w),
                       3)
    ins = [t for name in names for t in (fields[name], *vels[name])]
    b = bound(K6_NAME, ins, list(fields.values()),
              sum(f.numel() for f in fields.values()))
    step_ms = cuda_ms(lambda: k_advect.advect_unchained(vx0, vy0, vz0, c, k,
                                                        w), 10)
    k5_ms = cuda_ms(lambda: k_advect.advect(vx0, vy0, vz0, c, k, w), 10)
    r = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
             events_ms=events_ms, four_branches_ms=step_ms,
             k5_four_branches_ms=k5_ms, **b)
    print(f"[unchained kernels] {K6_NAME}: the four branches in one launch "
          f"{ms:.4f} ms of device time ({events_ms:.4f} ms by CUDA events), "
          f"plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}, {b['bytes'] / 1e6:.1f} MB), kernel at "
          f"{100 * b['bound_ms'] / ms:.1f}% of it; advect_unchained "
          f"(torch-op face averages + 1 K6) {step_ms:.4f} ms against K5's "
          f"four branches {k5_ms:.4f} ms")
    return {K6_NAME: r}


def phase_unchained_path(solver, smi) -> dict:
    """The unchained step (fused_step=False) at 255: K6 one launch a step,
    K10 launched (the folded loops' bodies), K3, K4 and K5 not."""
    g = solver.grid
    print(f"[unchained] grid {g.nx}x{g.ny}x{g.nz} float32, fused_step "
          f"{solver.fused_step}, accuracy phase {solver.acc} ({smi})")
    counts, iters, states, _ = run_steps(solver, UNCHAINED_STEPS,
                                         "unchained", REF_ITERS)
    require(counts[K6_NAME][0] == UNCHAINED_STEPS,
            f"unchained: K6 launched {counts[K6_NAME][0]} times")
    require(counts[K10_NAME][0] > 0, "unchained: K10 never launched")
    for name in ("K3 predict", "K4 correct", "K5 advect"):
        require(counts[name][0] == 0, f"unchained: {name} launched")
    stored_errs(solver, states, "unchained",
                range(1, UNCHAINED_STEPS + 1))
    print(f"[unchained] iterations {tuple(iters)}; the chained path's "
          f"(phase 4, the JAX package's) {REF_ITERS}: equal "
          f"{tuple(iters) == REF_ITERS}")
    profile_step(solver, states[-1], "unchained")
    return counts


def k7_inputs(shape) -> tuple:
    """Seeded pr, dpr (zero ring) and rhs for the K7 comparisons."""
    rng = np.random.default_rng(2025)
    return (seeded(rng, *shape, scale=50.0), interior_seeded(rng, shape, 1e3),
            seeded(rng, *shape, scale=1e5))


def check_k7_spec(op, fields, label, phase) -> dict:
    """K7 against its plain version with one BC spec: both outputs
    bitwise; ms, plain ms and the bound."""
    pr, dpr, rhs = fields
    a = [torch.full_like(pr, float("nan")) for _ in range(2)]
    b = [torch.empty_like(pr) for _ in range(2)]
    k_poisson.poisson_iter_bc(pr, dpr, rhs, *a, op)
    k_poisson.poisson_iter_bc_plain(pr, dpr, rhs, *b, op)
    torch.cuda.synchronize()
    worst = max_abs(zip(a, b))
    require(all(bitwise(x, y) for x, y in zip(a, b)),
            f"K7 ({label}) differs from its plain version by {worst}")
    ms = cuda_ms(lambda: k_poisson.poisson_iter_bc(pr, dpr, rhs, *a, op), 50)
    plain_ms = cuda_ms(
        lambda: k_poisson.poisson_iter_bc_plain(pr, dpr, rhs, *b, op), 10)
    r = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
             **bound(K7_NAME, (pr, dpr, rhs, *(t for t in (op.xlo, op.xhi)
                                               if t is not None)), a,
                     pr.numel()))
    print(f"[{phase}] {K7_NAME} ({label}): bitwise equal to its plain "
          f"version; {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} "
          f"MB per launch), kernel at {100 * r['bound_ms'] / ms:.1f}% of it")
    return r


def phase_dma_path(smi):
    """The dma-mode solve (poisson_mode='dma') of the gpu preset at 255:
    K7 under the split spec and the reference's loop, no accuracy phase.
    Returns (counts, K7's numbers under the split spec)."""
    s = nt.ChorinSolver(nt.preset_gpu(nx=NX, compat=False, dtype="float32"),
                        device="cuda", poisson_mode="dma")
    g, eps_it, op = s.grid, s.cfg.numerics.eps_it, s._bc_op
    require(op is not None and op.z_lo_add != 0.0 and not op.zero_grad_x,
            "dma: K7 under the split gpu spec")
    print(f"[dma] grid {g.nx}x{g.ny}x{g.nz} float32, poisson_mode "
          f"{s.poisson_mode}, niter {g.niter} = {g.niter // g.nchk} chunks "
          f"of nchk {g.nchk} + {g.niter % g.nchk}, stall exit {s._stall}, "
          f"split spec z_lo_add {op.z_lo_add} z_hi_add {op.z_hi_add} "
          f"({smi})")
    k7 = next(kk for kk in kernels.KERNELS if kk.name == K7_NAME)
    state = s.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    states, all_stats, wall = [state], [], []
    for step in range(DMA_STEPS):
        n0 = k7.wrapper.launches
        t0 = time.perf_counter()
        state, stats = s.step(state)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        states.append(state)
        all_stats.append(stats)
        err = float(stats.err)
        end = ("non-finite err" if not np.isfinite(err) else
               "converged" if err < eps_it else
               "the budget" if stats.iters >= g.niter else "stalled")
        print(f"[dma] step {step + 1}: iters {stats.iters} err {err:.6e} "
              f"({end}) advect_clamped {stats.advect_clamped} "
              f"{wall[-1]:.4f} s, K7 launches {k7.wrapper.launches - n0}",
              flush=True)
        require(finite_state(state), f"dma step {step + 1}: non-finite "
                "fields")
        require(stats.pr_lo is None and state.pr_lo is None,
                "dma: a stored pair")
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    iters = sum(st.iters for st in all_stats)
    print(f"[dma] {sum(wall) / DMA_STEPS:.4f} s/step, "
          f"{iters / sum(wall):.1f} Poisson iterations/s ({iters} "
          f"iterations in {sum(wall):.3f} s; {smi})")
    on_path = {K7_NAME, "K3 predict", "K4 correct", "K5 advect"}
    for name, (launches, plain) in counts.items():
        print(f"[dma] {name}: {launches} launches, plain version {plain} "
              "calls")
        require(plain == 0, f"dma: {name} ran its plain version")
        require((launches > 0) == (name in on_path),
                f"dma: {name} launched {launches} times")
    plain = nt.ChorinSolver(s.cfg.replace(use_pallas=False), "cuda",
                            poisson_mode="dma")
    st, pstats = plain.step(plain.init_state())
    u = max_ulp(st.pr, states[1].pr)
    print(f"[dma] step 1 with use_pallas=False: iters {pstats.iters} "
          f"(kernels {all_stats[0].iters}), err {float(pstats.err):.6e}, pr "
          f"max ulp {u}")
    require(pstats.iters == all_stats[0].iters,
            f"dma: plain run iterations {pstats.iters}")
    require(u <= MAX_ULP, f"dma: plain run's pr differs by {u} ulp")
    del st, plain
    profile_step(s, states[-1], "dma")
    k11 = check_k7_spec(op, k7_inputs(g.shape_c),
                        "split gpu spec, the dma path's", "dma kernels")
    return counts, k11


def resident_inputs(g):
    """benchmarks/resident_probe.py's inputs: randn pr, 0.01 randn dpr,
    randn rhs from RandomState(0), float32, on the card."""
    rng = np.random.RandomState(0)
    shape = (g.nx, g.ny, g.nz)
    pr = rng.randn(*shape).astype(np.float32)
    dpr = (rng.randn(*shape).astype(np.float32) * 0.01).astype(np.float32)
    rhs = rng.randn(*shape).astype(np.float32)
    return tuple(torch.tensor(a, device="cuda") for a in (pr, dpr, rhs))


def check_plan(plan, shape, label) -> None:
    """K10's plan against its rule: the cut of the (y, z) column
    plane that `grid_cut` picks for the card's SMs (z rows of a warp's 32
    lanes, balanced y parts), one block a region, the largest region's
    column slots a block (at most one a thread), and the shared memory of
    their dpr through every plane."""
    nx, ny, nz = shape
    sms = k_poisson.resident_sms("cuda")
    gy, gz = k_poisson.grid_cut(ny, nz, sms)
    cols = -(-ny // gy) * k_poisson.RESIDENT_LANES
    need = k_poisson.grid_smem(cols, nx)
    require(plan.cut == (gy, gz) and plan.blocks == gy * gz <= sms
            and plan.per_block == cols <= k_poisson.RESIDENT_THREADS
            and need <= plan.smem_bytes
            <= k_poisson.SMEM_LIMIT - k_poisson.RESIDENT_STATIC_SMEM,
            f"K10 ({label}): plan {plan}, expected the cut {gy} x {gz} of "
            f"{cols} columns a block and {need} B")
    print(f"[resident] K10 ({label}): cut {gy} x {gz} of the {ny}x{nz} "
          f"columns, {plan.blocks} blocks of at most {cols} column slots "
          f"({min(nx, k_poisson.RESIDENT_THREADS // cols)} runs of planes "
          f"a column), {plan.smem_bytes} B of shared memory a block")


def check_k10(solver, nit, smi) -> dict:
    """K10 under its plan against nit K1 launches and its plain version
    (bitwise), then the times of K10 and of the nit K1 launches: device
    time from torch.profiler and CUDA events."""
    g, op = solver.grid, solver._op
    plan = k_poisson.resident_plan(g.shape_c, k_poisson.resident_sms("cuda"))
    require(plan is not None, f"K10 at {g.shape_c}: no plan")
    label = f"{g.nx}x{g.ny}x{g.nz}, nit {nit}"
    check_plan(plan, g.shape_c, label)
    pr0, dpr0, rhs = resident_inputs(g)
    p, d = pr0.clone(), dpr0.clone()
    scratch = torch.full_like(p, float("nan"))
    e = k_poisson.poisson_iter_resident(p, d, rhs, op, nit, scratch)
    q, dq = pr0.clone(), dpr0.clone()
    for j in range(nit):
        o = torch.empty_like(q)
        e1 = k_poisson.poisson_iter(q, o, dq, rhs, op, j == nit - 1)
        q = o
    pp, dp = pr0.clone(), dpr0.clone()
    ep = k_poisson.poisson_iter_resident_plain(pp, dp, rhs, op, nit)
    torch.cuda.synchronize()
    worst = max_abs(((p, pp), (d, dp)))
    require(bitwise(p, q) and bitwise(d, dq) and float(e) == float(e1),
            f"K10 ({label}) differs from {nit} K1 launches")
    require(bitwise(p, pp) and bitwise(d, dp) and float(e) == float(ep),
            f"K10 ({label}) differs from its plain version by {worst}")
    print(f"[resident] K10 ({label}): pr, dpr and the check value "
          f"{float(e):.9e} bitwise equal to {nit} K1 launches and to the "
          "plain version")
    del q, dq, pp, dp
    # the K1 chain's own state (sharing dpr with K10's would mix two
    # iterations)
    bufs = [pr0.clone(), torch.empty_like(pr0)]
    dk = dpr0.clone()

    def k1_chain():
        for j in range(nit):
            k_poisson.poisson_iter(bufs[j % 2], bufs[(j + 1) % 2], dk, rhs,
                                   op, j == nit - 1)

    def k10(n=nit):
        return k_poisson.poisson_iter_resident(p, d, rhs, op, n, scratch)
    reps = 20 if g.nx < 100 else 5
    ms, launch_events_ms = device_ms(k10, reps, "poisson_resident",
                                     events=True)
    ms1 = device_ms(lambda: k10(1), reps, "poisson_resident")
    events_ms = cuda_ms(k10, reps)
    k1_ms = nit * device_ms(k1_chain, reps, "poisson_iter_kernel")
    k1_events_ms = cuda_ms(k1_chain, reps)
    plain_ms = cuda_ms(lambda: k_poisson.poisson_iter_resident_plain(
        p, d, rhs, op, nit, scratch), 3, warmup=1)
    b = bound(K10_NAME, (pr0, dpr0, rhs), (p, d), p.numel(), iters=nit)
    # what the fields move where they do not stay in L2: K1's bytes (5 x 4
    # B per cell) every iteration. K10 keeps dpr on chip, reads rhs from
    # HBM (4 B) and moves pr in, rhs in and pr out through L2 (12 B) at the
    # rate of a warm copy of pr into a buffer as large (the pair fits the
    # 50 MB L2 at 255); its ceiling is nit times the larger (at 63 the copy
    # of at least 1 MB is bound by its launch, and the ceiling loose).
    cells = p.numel()
    stream_ms = nit * 5 * 4 * cells / HBM_BYTES_PER_S * 1e3
    pair_mb = max(1, round(2 * 4 * cells / 1e6))
    pair_ms, pair_timing = copy_ms(pair_mb)
    l2_rate = pair_mb * 1e6 / (pair_ms / 1e3)
    hbm_s, l2_s = 4 * cells / HBM_BYTES_PER_S, 12 * cells / l2_rate
    form_ms = nit * max(hbm_s, l2_s) * 1e3
    form_by = (f"{'HBM (rhs)' if hbm_s >= l2_s else 'L2 (pr, rhs)'}; a "
               f"copy of {pair_mb} MB {pair_ms:.4f} ms, "
               f"{l2_rate / 1e12:.3f} TB/s, {pair_timing}")
    per_iter = (ms - ms1) / (nit - 1)
    agrees_with_events(f"K10 ({label})", ms, launch_events_ms)
    print(f"[resident] K10 ({label}): {ms:.4f} ms of device time "
          f"({launch_events_ms:.4f} ms by CUDA events around the traced "
          f"launches, {events_ms:.4f} ms around launches issued back to "
          f"back), {per_iter * 1e3:.2f} us per "
          f"added iteration (nit 1: {ms1:.4f} ms); {nit} K1 launches "
          f"{k1_ms:.4f} ms of device time ({k1_events_ms:.4f} ms by CUDA "
          f"events, issued back to back); plain {plain_ms:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: one pass "
          f"{b['bytes'] / 1e6:.2f} MB, {nit} iterations of operations), "
          f"kernel at {100 * b['bound_ms'] / ms:.1f}% of it; {nit} passes "
          f"through HBM {stream_ms:.4f} ms; the design's ceiling "
          f"{form_ms:.4f} ms ({form_by}), kernel at {100 * form_ms / ms:.1f}"
          f"% of it; "
          f"K10 {'beats' if ms < k1_ms else 'does not beat'} the {nit} K1 "
          f"launches in device time ({plan}; {smi})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                events_ms=events_ms, launch_events_ms=launch_events_ms,
                k1_launches_ms=k1_ms,
                k1_launches_events_ms=k1_events_ms, ms_nit1=ms1,
                per_iteration_ms=per_iter, hbm_passes_ms=stream_ms,
                form_bound_ms=form_ms, **b)


def check_k10_loop(solver, smi) -> None:
    """The folded loop's K10 launch (poisson_loop_resident: check
    intervals from it0 = 1, each exit decision taken on the card) on
    resident_inputs, against host-driven K10 launches of nit = nchk - it
    % nchk (each check value read by the host, the parent design) and
    against its plain version: a budget of LOOP_CHECKS checks, eps just
    above the third check value, the stall window of the preset's ratio
    over LOOP_WINDOW checks, NaN in the scratch. The loop must end
    partway, as ExitRule.stops on the host-driven check values says; pr,
    dpr, the check values and the checks taken bitwise; one launch and no
    plain call, read right after the launch."""
    g, op = solver.grid, solver._op
    nchk, f32 = g.nchk, np.float32
    label = f"{g.nx}x{g.ny}x{g.nz}, nchk {nchk}"
    scale = f32(solver._err_scale())
    pr0, dpr0, rhs = resident_inputs(g)
    q, dq = pr0.clone(), dpr0.clone()
    scratch = torch.full_like(q, float("nan"))
    it, errs, fields = 1, [], []
    while it < LOOP_CHECKS * nchk:
        nit = nchk - it % nchk
        e = k_poisson.poisson_iter_resident(q, dq, rhs, op, nit, scratch)
        it += nit
        errs.append(f32(float(e)) * scale)
        fields.append((q.clone(), dq.clone()))
    errs = np.array(errs, np.float32)
    eps = np.nextafter(errs[2], f32(np.inf))
    rule = ExitRule(1, LOOP_CHECKS * nchk, nchk, eps, scale, LOOP_WINDOW,
                    f32(solver.cfg.numerics.stall_ratio ** LOOP_WINDOW),
                    f32(1e30))
    n = next(k + 1 for k in range(LOOP_CHECKS)
             if rule.stops((k + 1) * nchk, errs[:k + 1]))
    kind = "stall" if rule.stalled(errs[:n]) else "eps"
    require(n < LOOP_CHECKS, f"K10 loop ({label}): the check values "
            f"{errs} end no loop partway")
    kernels.reset_counts()
    p, d = pr0.clone(), dpr0.clone()
    scratch.fill_(float("nan"))
    got = k_poisson.poisson_loop_resident(p, d, rhs, op, rule, scratch)
    counts = (k_poisson.poisson_iter_resident.launches,
              k_poisson.poisson_iter_resident_plain.calls,
              k_poisson.poisson_iter_resident.checks)
    pp, dp = pr0.clone(), dpr0.clone()
    words = k_poisson.poisson_loop_resident_plain(pp, dp, rhs, op,
                                                  rule).numpy()
    plain = words[1:1 + words[0]].view(np.float32) * scale
    torch.cuda.synchronize()
    qn, dqn = fields[n - 1]
    require(counts == (1, 0, n), f"K10 loop ({label}): launches, plain "
            f"calls and checks {counts}, expected (1, 0, {n})")
    require(got.view(np.int32).tolist() == errs[:n].view(np.int32).tolist()
            and bitwise(p, qn) and bitwise(d, dqn),
            f"K10 loop ({label}) differs from the host-driven launches: "
            f"check values {got}, expected {errs[:n]}")
    require(plain.view(np.int32).tolist() == got.view(np.int32).tolist()
            and bitwise(p, pp) and bitwise(d, dp)
            and k_poisson.poisson_iter_resident_plain.checks == n,
            f"K10 loop ({label}) differs from its plain version by "
            f"{max_abs(((p, pp), (d, dp)))}")
    print(f"[resident] K10 loop ({label}): one launch took {n} of "
          f"{LOOP_CHECKS} checks on the card and stopped by {kind} (eps "
          f"{float(eps):.9e}, window {LOOP_WINDOW}); pr, dpr and the check "
          f"values {[float(v) for v in got]} bitwise equal to {n} "
          f"host-driven K10 launches and to the plain version; no plain "
          f"call ({smi})")


def resident_solve(smi) -> dict:
    """One Poisson solve at 63x38x38 (the gpu preset's first, from
    init_state: the folded protocol's exact first iteration, then K1 over
    the budget) twice: all on K1, and with its first chunk (nchk - 1
    iterations after the exact one) on one K10 launch and the rest in
    pt_loop_fused(seed0=True) on K1, the launch counts set to 0 just
    before and read just after. Iterations, err, history and fields must
    be the unseeded loop's, bitwise."""
    s = nt.ChorinSolver(nt.preset_gpu(nx=RESIDENT_NX[0], compat=False,
                                      dtype="float32"), device="cuda")
    g, eps_it = s.grid, s.cfg.numerics.eps_it
    nchunks, rem = s._budget()
    st = s.init_state()
    divv = s.predictor_divv(st)
    rhs, es = s._rhs3d(divv), s._err_scale()
    chain = s._kernel_chain(rhs, es)

    def loop(p, d, it0, **kw):
        (p, _, d, _), it, err, hist = pt_loop_fused(
            chain, (p, torch.empty_like(p), d, None), it0,
            nchunks * g.nchk + rem, g.nchk, nchunks, eps_it, s.dtype,
            stall=s._stall, **kw)
        return p, d, it, err, hist
    t0 = time.perf_counter()
    pu, du, itu, erru, histu = loop(*s._first_iteration(st.pr, st.dprdtau,
                                                        divv), 1)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    p, d = s._first_iteration(st.pr, st.dprdtau, divv)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    resident = k_poisson.make_resident(g.nchk - 1, g.shape_c, "cuda")
    require(resident is not None, f"resident solve: no K10 at {g.shape_c}")
    p, d, e = resident(p, d, rhs, s._op)
    ps, ds_, its, errs, hists = loop(p, d, g.nchk, err0=e * es, seed0=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    same = (bitwise(ps, pu) and bitwise(ds_, du)
            and np.array_equal(hists, histu, equal_nan=True))
    print(f"[resident solve] {g.nx}x{g.ny}x{g.nz}, nchk {g.nchk}: unseeded "
          f"K1 loop {itu} iterations err {float(erru):.6e} ({wall_u:.4f} s); "
          f"K10 ({g.nchk - 1} iterations) + seeded loop {its} iterations "
          f"err {float(errs):.6e} ({wall_s:.4f} s); fields and history "
          f"bitwise equal: {same}; K10 {counts[K10_NAME][0]} launch, K1 "
          f"{counts[K1_NAME][0]} launches ({smi})")
    require(its == itu and errs == erru and same,
            "resident solve: the seeded loop differs from the unseeded one")
    for name, (launches, plain) in counts.items():
        require(plain == 0, f"resident solve: {name} ran its plain version")
        require((launches > 0) == (name in (K10_NAME, K1_NAME)),
                f"resident solve: {name} launched {launches} times")
    return counts


def check_k12(solver, nit, smi) -> dict:
    """K12 under K10's plan against nit K2 launches and its plain version
    (bitwise), then the times of K12 and of the nit K2 launches (device
    time from torch.profiler) against K12's bound, 20 B a cell and
    iteration."""
    g, op = solver.grid, solver._op
    label = f"{g.nx}x{g.ny}x{g.nz}, nit {nit}"
    hi0, dpr0, rhs = resident_inputs(g)
    lo0 = torch.tensor(np.random.RandomState(1).randn(*hi0.shape).astype(
        np.float32) * 2.0 ** -24, device="cuda")
    h, l, d = hi0.clone(), lo0.clone(), dpr0.clone()
    scratch = tuple(torch.full_like(hi0, float("nan")) for _ in range(2))
    e = k_poisson.poisson_iter_resident_ext(h, l, d, rhs, op, nit, *scratch)
    q = (hi0.clone(), lo0.clone(), torch.empty_like(hi0),
         torch.empty_like(lo0))
    dq = dpr0.clone()
    for j in range(nit):
        e2 = k_poisson.poisson_iter_ext(*q, dq, rhs, op, j == nit - 1)
        q = (q[2], q[3], q[0], q[1])
    hp, lp, dp = hi0.clone(), lo0.clone(), dpr0.clone()
    ep = k_poisson.poisson_iter_resident_ext_plain(hp, lp, dp, rhs, op, nit)
    torch.cuda.synchronize()
    worst = max_abs(((h, hp), (l, lp), (d, dp)))
    require(bitwise(h, q[0]) and bitwise(l, q[1]) and bitwise(d, dq)
            and float(e) == float(e2),
            f"K12 ({label}) differs from {nit} K2 launches")
    require(bitwise(h, hp) and bitwise(l, lp) and bitwise(d, dp)
            and float(e) == float(ep),
            f"K12 ({label}) differs from its plain version by {worst}")
    print(f"[resident] K12 ({label}): hi, lo, dpr and the check value "
          f"{float(e):.9e} bitwise equal to {nit} K2 launches and to the "
          "plain version")
    del q, dq, hp, lp, dp
    # the K2 chain's own state (sharing dpr with K12's would mix two
    # iterations)
    bufs = [hi0.clone(), lo0.clone(), torch.empty_like(hi0),
            torch.empty_like(lo0)]
    dk = dpr0.clone()

    def k2_chain():
        for j in range(nit):
            a, b = (0, 2) if j % 2 == 0 else (2, 0)
            k_poisson.poisson_iter_ext(bufs[a], bufs[a + 1], bufs[b],
                                       bufs[b + 1], dk, rhs, op,
                                       j == nit - 1)

    def k12():
        return k_poisson.poisson_iter_resident_ext(h, l, d, rhs, op, nit,
                                                   *scratch)
    reps = 20 if g.nx < 100 else 5
    ms, launch_events_ms = device_ms(k12, reps, "poisson_resident_ext",
                                     events=True)
    k2_ms = nit * device_ms(k2_chain, reps, "poisson_iter_ext_kernel")
    plain_ms = cuda_ms(lambda: k_poisson.poisson_iter_resident_ext_plain(
        h, l, d, rhs, op, nit, *scratch), 3, warmup=1)
    cells = h.numel()
    bound_ms = nit * 20 * cells / HBM_BYTES_PER_S * 1e3
    agrees_with_events(f"K12 ({label})", ms, launch_events_ms)
    print(f"[resident] K12 ({label}): {ms:.4f} ms of device time "
          f"({launch_events_ms:.4f} ms by CUDA events around the traced "
          f"launches), "
          f"{ms / nit * 1e3:.2f} us an iteration; {nit} K2 launches "
          f"{k2_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"(20 B a cell and iteration), kernel at "
          f"{100 * bound_ms / ms:.1f}% of it ({solver._resident_plan}; "
          f"{smi})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                launch_events_ms=launch_events_ms, k2_launches_ms=k2_ms,
                bound_ms=bound_ms, bound_by="bytes")


def phase_resident(smi):
    """K10 and K12 at 63 (nit = nchk = 37) and 255 (nit = 152), and the
    seeded solve at 63. Returns (results, counts of the seeded solve)."""
    rows, rows12 = {}, {}
    for nx in RESIDENT_NX:
        s = nt.ChorinSolver(nt.preset_gpu(nx=nx, compat=False,
                                          dtype="float32"), device="cuda")
        rows[nx] = check_k10(s, RESIDENT_NIT[nx], smi)
        check_k10_loop(s, smi)
        del s
    counts = resident_solve(smi)
    for nx in RESIDENT_NX:
        s = nt.ChorinSolver(nt.preset_multi(nx=nx, compat=False,
                                            dtype="float32"), device="cuda")
        rows12[nx] = check_k12(s, RESIDENT_NIT[nx], smi)
        del s
    out = {}
    for name, by_nx in ((K10_NAME, rows), (K12_NAME, rows12)):
        r = dict(by_nx[RESIDENT_NX[1]])
        r["max_abs_err"] = max(v["max_abs_err"] for v in by_nx.values())
        r["at_63"] = by_nx[RESIDENT_NX[0]]
        out[name] = r
    return out, counts


def fdm_solver(make, nx: int) -> "nt.ChorinSolver":
    """The preset's float32 solver with the fdm backend, on the card."""
    cfg = make(nx=nx, compat=False, dtype="float32")
    return nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm")), device="cuda")


def fdm_flops(shape) -> int:
    """float32 operations of one direct solve (refine=0): six transforms,
    each 2*m1*m2*m3*(m1+m2+m3) over the three axes' products, and one
    division a cell."""
    m1, m2, m3 = shape
    return 2 * (2 * m1 * m2 * m3 * (m1 + m2 + m3)) + m1 * m2 * m3


def phase_fdm_solve(smi) -> dict:
    """The fdm solve alone at 255 (gpu variant): the card's float32 solve
    of a seeded RHS against the host's float64 solve (relative error
    bounded by FDM_SOLVE_RTOL), bitwise the same with TF32 turned on (and
    an unguarded product under TF32 shown to differ, so the switch was
    live), then its time against its bound."""
    from navierstokes3d_tpu_torch.ops.fdm_poisson import solve_host_f64
    s = fdm_solver(nt.preset_gpu, NX)
    g, fdm = s.grid, s._fdm
    rng = np.random.default_rng(7)
    rhs64 = rng.normal(size=fdm.shape) * 1e5
    rhs = torch.tensor(rhs64.astype(np.float32), device="cuda")
    p = fdm(rhs, refine=0)
    torch.cuda.synchronize()
    ref = solve_host_f64(g, "gpu", rhs64)
    rel = float(np.abs(p.cpu().numpy() - ref).max() / np.abs(ref).max())
    print(f"[fdm solve] {g.nx}x{g.ny}x{g.nz} (interior {fdm.shape}): card "
          f"float32 against host float64, max rel err {rel:.3e} (bound "
          f"{FDM_SOLVE_RTOL:g})")
    require(rel < FDM_SOLVE_RTOL, f"fdm solve rel err {rel}")
    prev = torch.get_float32_matmul_precision()
    f2 = rhs.reshape(fdm.shape[0], -1)
    raw_ieee = torch.matmul(fdm._qxT, f2)
    torch.set_float32_matmul_precision("high")
    try:
        raw_tf32 = torch.matmul(fdm._qxT, f2)
        p_tf32 = fdm(rhs, refine=0)
        require(torch.get_float32_matmul_precision() == "high",
                "fdm solve did not restore the caller's precision")
    finally:
        torch.set_float32_matmul_precision(prev)
    torch.cuda.synchronize()
    live = not bitwise(raw_ieee, raw_tf32)
    print(f"[fdm solve] TF32 on: an unguarded x transform differs "
          f"({live}); the solve bitwise equal to the IEEE one "
          f"({bitwise(p, p_tf32)})")
    require(live, "TF32 did not change an unguarded product: the check "
            "would not see the guard fail")
    require(bitwise(p, p_tf32), "fdm solve differs with TF32 on")
    ms = cuda_ms(lambda: fdm(rhs, refine=0), 20)
    ms_t = cuda_ms(lambda: fdm.to_modal(rhs), 20)
    ms_d = cuda_ms(lambda: fdm.modal_scale(rhs), 20)
    flops = fdm_flops(fdm.shape)
    nbytes = 2 * rhs.numel() * 4 + sum(
        q.numel() * 4 for q in (fdm._qx, fdm._qy, fdm._qz))
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(ms=ms, to_modal_ms=ms_t, modal_scale_ms=ms_d,
               flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               rel_err_vs_f64=rel)
    print(f"[fdm solve] one solve {ms:.4f} ms (three transforms "
          f"{ms_t:.4f} ms, the modal division {ms_d:.4f} ms); "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB: bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), at "
          f"{100 * row['bound_ms'] / ms:.1f}% of it; "
          f"{flops / ms / 1e9:.2f} TFLOP/s ({smi})")
    print(f"[fdm solve] {json.dumps(row)}")
    return row


def fdm_breakdown(prof: dict, label: str) -> None:
    """One traced fdm step's device time by group: cuBLAS's matmuls (the
    transforms), K3, K4, K5, and the rest (elementwise passes and
    reductions: the RHS pair, the compensated residual, the refinement's
    two_sum, the BCs, the modal division), with the idle share."""
    groups = dict.fromkeys(("matmuls", "K3", "K4", "K5", "elementwise"), 0.0)
    for name, (us, _) in prof["by_name"].items():
        key = next((k for k, sym in FDM_GROUPS if sym in name), None)
        if key is None:
            key = "matmuls" if MATMUL_NAME.search(name) else "elementwise"
        groups[key] += us
    busy, span = prof["busy"], prof["span"]
    require(busy > 0, f"{label}: the traced step recorded no device time")
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / busy:.1f}%)"
                      for k, v in groups.items())
    print(f"[{label} trace] by group: {parts}; busy {busy / 1e3:.3f} ms, "
          f"idle {100 * (1 - busy / span):.2f}% of the kernel span, wall "
          f"{prof['wall'] * 1e3:.2f} ms")


def check_fdm_kernels(solver, state, label) -> None:
    """K3 with the fdm step's constants (g_eff = g in the gpu variant: no
    hydrostatic split) on the state's velocities, bitwise; K4 with its
    unsplit pressure within MAX_ULP; K5 on its velocities, bitwise."""
    k, masks = solver._consts, solver.masks
    vx, vy, vz = state.vx, state.vy, state.vz
    check_k3(vx, vy, vz, masks, k, f"{label}, g_eff {k.g_eff}")
    a = k_step.correct(vx, vy, vz, state.pr, masks, k)
    b = k_step.correct_plain(vx, vy, vz, state.pr, masks, k)
    u = max(max_ulp(x, y) for x, y in zip(a, b))
    print(f"[kernels] K4 correct ({label}, unsplit pressure up to "
          f"{float(state.pr.abs().max()):.4g}): max ulp {u}")
    require(u <= MAX_ULP, f"K4 ({label}) differs by {u} ulp")
    del a, b
    check_k5((vx, vy, vz, state.c), k, solver.advect_k, label)


def run_fdm(solver, nsteps: int, label: str, smi) -> dict:
    """nsteps of an fdm path from init_state (counts as the main paths'):
    K3, K4 and K5 launched, no Poisson kernel and no plain version; every
    step within fdm_refine rounds, err and the stored-state error below
    eps_it, finite fields; the rounds and err beside the JAX package's
    record; then K3/K4/K5 held on the last state and one step traced."""
    g, num = solver.grid, solver.cfg.numerics
    print(f"[{label}] grid {g.nx}x{g.ny}x{g.nz} float32, fdm_refine "
          f"{num.fdm_refine}, eps_it {num.eps_it}, g_eff "
          f"{solver._consts.g_eff} ({smi}); the JAX package's TPU record: "
          f"1 round a step, err ~1.4e-8 at 255, 6.6e-8 at 511")
    counts, iters, states, stats = run_steps(solver, nsteps, label,
                                             clamps_allowed=True)
    # K13's pair form: the refinement's residuals of the stored pair
    for name, (launches, _) in counts.items():
        on_path = name.split()[0] in ("K3", "K4", "K5", "K13-pair")
        require((launches > 0) == on_path,
                f"{label}: {name} launched {launches} times")
    for step, st in enumerate(stats):
        require(st.iters <= num.fdm_refine,
                f"{label} step {step + 1}: {st.iters} rounds")
    stored_errs(solver, states, label, range(1, nsteps + 1))
    print(f"[{label}] rounds {iters}, err "
          f"{[float(st.err) for st in stats]}")
    check_fdm_kernels(solver, states[-1], label)
    fdm_breakdown(profile_step(solver, states[-1], label), label)
    return counts, states


def phase_fdm_paths(smi) -> list:
    """The fdm backend's paths: gpu and multi at 255 for FDM_STEPS steps,
    the gpu one's step 1 again with TF32 on (bitwise)."""
    out = []
    for make in (nt.preset_gpu, nt.preset_multi):
        s = fdm_solver(make, NX)
        counts, states = run_fdm(s, FDM_STEPS, f"fdm {s.cfg.variant}", smi)
        out.append(counts)
        if s.cfg.variant == "gpu":
            prev = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("high")
            try:
                st, _ = s.step(states[0])
            finally:
                torch.set_float32_matmul_precision(prev)
            torch.cuda.synchronize()
            for name in ("pr", "pr_lo", "vx", "vy", "vz", "c", "dprdtau"):
                require(bitwise(getattr(st, name), getattr(states[1], name)),
                        f"fdm gpu step 1 with TF32 on: {name} differs")
            print("[fdm gpu] step 1 with TF32 on: every field bitwise equal")
        del s, states
    return out


def phase_fdm_wide(smi) -> dict:
    s = fdm_solver(nt.preset_gpu, WIDE_NX)
    counts, states = run_fdm(s, FDM_WIDE_STEPS, "fdm wide", smi)
    return counts


def phase_io(smi) -> None:
    """The I/O layer through run.main on the card (multi preset at 63):
    --nt 4 --save --checkpoint-every 2, then --resume --nt 6, against an
    uninterrupted 6-step run: the final checkpoints bitwise equal; the
    .bin frame of step 4 byte-identical to numpy's column-major writer on
    the step-4 checkpoint's gathered field; the native writer built."""
    from navierstokes3d_tpu_torch import run as trun
    from navierstokes3d_tpu_torch.io import binio, checkpoint, native
    root = Path(__file__).resolve().parent / "smoke_out" / "io"
    shutil.rmtree(root, ignore_errors=True)
    base = ["--preset", "multi", "--nx", str(IO_NX), "--device", "cuda",
            "--quiet"]
    try:
        t0 = time.perf_counter()
        require(trun.main(base + ["--nt", "6", "--checkpoint-every", "6",
                                  "--ckpt-dir", str(root / "whole")]) == 0,
                "io: the uninterrupted run failed")
        part = ["--ckpt-dir", str(root / "ck"), "--out-dir",
                str(root / "out"), "--save", "--nsave", "2",
                "--checkpoint-every", "2"]
        require(trun.main(base + part + ["--nt", "4"]) == 0,
                "io: the first part failed")
        require(trun.main(base + part + ["--nt", "6", "--resume"]) == 0,
                "io: the resumed part failed")
        wall = time.perf_counter() - t0
        a, ia = checkpoint.load_checkpoint(
            str(root / "whole" / "ckpt_0000006.npz"), device="cuda")
        b, ib = checkpoint.load_checkpoint(
            str(root / "ck" / "ckpt_0000006.npz"), device="cuda")
        require(ia == ib == 6, f"io: checkpoint steps {ia}, {ib}")
        for name in ("pr", "pr_lo", "vx", "vy", "vz", "c", "dprdtau"):
            require(bitwise(getattr(a, name), getattr(b, name)),
                    f"io: resumed {name} differs from the uninterrupted run")
        require(native.lib() is not None,
                f"io: the native writer did not build ({native.build_error})")
        st4, _ = checkpoint.load_checkpoint(
            str(root / "ck" / "ckpt_0000004.npz"), device="cuda")
        fields = dict(zip(("C", "Pr", "Vx", "Vy", "Vz"),
                          nt.gather_inner(st4)))
        for name, arr in fields.items():
            got = (root / "out" / f"out_{name}_v_0002.bin").read_bytes()
            want = np.asarray(arr, np.float32).flatten(order="F").tobytes()
            require(got == want, f"io: out_{name}_v_0002.bin differs from "
                    "numpy's writer")
        require(binio.load_array(str(root / "out" / "out_Pr_v_0003.bin"),
                                 fields["Pr"].shape).shape
                == fields["Pr"].shape, "io: frame 3 missing")
        libs = sorted(p.name for p in native.BUILD_DIR.glob("libns3dio-*"))
        print(f"[io] multi {IO_NX}: 4 steps + checkpoint, resume to 6: "
              f"every field bitwise equal to the uninterrupted 6 steps; "
              f".bin frames byte-identical to numpy's writer; native "
              f"library {libs}; {wall:.1f} s for the three runs ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_compat_api(smi) -> None:
    """The reference's entry functions on the card with their defaults
    (compat, float64): run_navierstokes3d(nx=63, nt=3), the golden
    configuration (iterations [37, 259, 296] and tests/test_golden.py's
    Pr probes), and runme(do_vis=False) at nx=63 for 2 steps with a .mat
    snapshot."""
    from navierstokes3d_tpu_torch import compat_api
    iters, step = [], nt.ChorinSolver.step

    def recording(self, state):
        state, stats = step(self, state)
        iters.append(stats.iters)
        return state, stats
    root = Path(__file__).resolve().parent / "smoke_out" / "api"
    shutil.rmtree(root, ignore_errors=True)
    nt.ChorinSolver.step = recording
    try:
        c, pr, vx, vy, vz = compat_api.run_navierstokes3d(nx=63, nt=3)
        probe = pr[np.ix_(*GOLDEN_INDS)]
        rel = float(np.max(np.abs(probe / PR_GOLDEN - 1.0)))
        print(f"[compat_api] run_navierstokes3d(nx=63, nt=3) on the card: "
              f"iters {iters}, Pr probes max rel diff {rel:.3e}")
        require(iters == GOLDEN_ITERS, f"compat_api iterations {iters}")
        require(np.allclose(probe, PR_GOLDEN, rtol=3e-3, atol=1e-8),
                f"compat_api Pr probes differ by {rel}")
        iters.clear()
        st = compat_api.runme(do_vis=False, do_save=True, nx=63, nt=2,
                              out_dir=str(root))
        require(st.pr.device.type == "cuda" and finite_state(st),
                "runme: state not finite on the card")
        require(iters == RUNME_ITERS, f"runme iterations {iters}, the "
                f"CPU's {RUNME_ITERS}")
        require((root / "step_0.mat").exists(), "runme: no step_0.mat")
        print(f"[compat_api] runme(do_vis=False, nx=63, nt=2): iters "
              f"{iters}, finite fields on {st.pr.device}, step_0.mat "
              f"written ({smi})")
    finally:
        nt.ChorinSolver.step = step
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    smi = phase_device()
    sass = phase_build()
    gpu = nt.ChorinSolver(nt.preset_gpu(nx=NX, compat=False,
                                        dtype="float32"), device="cuda")
    multi = nt.ChorinSolver(nt.preset_multi(nx=NX, compat=False,
                                            dtype="float32"), device="cuda")
    for s in (gpu, multi):
        g = s.grid
        print(f"[{s.cfg.variant}] grid {g.nx}x{g.ny}x{g.nz} float32, niter "
              f"{g.niter}, nchk {g.nchk}, eps_it {s.cfg.numerics.eps_it}, "
              f"accuracy phase {s.acc} ({smi})")
    compat = [nt.ChorinSolver(make(nx=NX, compat=True, dtype="float32"),
                              device="cuda")
              for make in (nt.preset_gpu, nt.preset_multi)]
    for s in compat:
        g = s.grid
        print(f"[{s.cfg.variant} compat] niter {g.niter} = "
              f"{g.niter // g.nchk} chunks of nchk {g.nchk} + "
              f"{g.niter % g.nchk}, stall exit {s._stall}")
    results = phase_kernels(gpu, multi)
    results.update(phase_k7(compat))
    # phase 16 early in the process: late in it the profiler was seen to
    # keep none or one of five K10 launches at 255 in a window
    resident_results, resident_counts = phase_resident(smi)
    results.update(resident_results)
    # each path's launch counts by its label (the JSON line's "paths")
    runs = {"gpu": phase_gpu_path(gpu)}
    runs.update(zip(("multi", "multi63"), phase_multi_paths(multi)))
    runs.update((f"{s.cfg.variant} compat", phase_compat(
        s, f"{s.cfg.variant} compat")) for s in compat)
    phase_golden()
    phase_reference()
    del gpu, multi, compat
    phase_fdm_solve(smi)
    runs.update(zip(("fdm gpu", "fdm multi"), phase_fdm_paths(smi)))
    phase_io(smi)
    phase_compat_api(smi)
    results.update(phase_dist_kernels())
    dist = phase_dist_path(smi)
    runs.update(zip(("dist", "dist compat"), (r["counts"] for r in dist)))
    runs.update(zip(("fullstep", "fullstep compat"),
                    phase_fullstep(smi, dist)))
    del dist
    runs.update(zip(("f64 multi63", "f64 gpu"), phase_float64(smi)))
    unchained = nt.ChorinSolver(nt.preset_gpu(nx=NX, compat=False,
                                              dtype="float32"),
                                device="cuda", fused_step=False)
    results.update(phase_unchained_kernels(unchained))
    runs["unchained"] = phase_unchained_path(unchained, smi)
    del unchained
    dma_counts, k11 = phase_dma_path(smi)
    runs["resident"] = resident_counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wide = nt.ChorinSolver(nt.preset_gpu(nx=WIDE_NX, compat=False,
                                         dtype="float32"), device="cuda")
    phase_kernels_wide(wide, results)
    runs["wide"] = phase_wide_path(wide, smi)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[wide] peak device memory {peak:.2f} GB ({smi})")
    del wide
    torch.cuda.empty_cache()
    runs["fdm wide"] = phase_fdm_wide(smi)
    rows = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for kk in kernels.KERNELS:
        r = results[kk.name]
        row = {"name": kk.name, "route": "cuda", "source": kk.source,
               "replaces": kk.replaces,
               "launches": sum(c[kk.name][0] for c in runs.values()),
               "paths": [p for p, c in runs.items() if c[kk.name][0] > 0],
               **{key: r[key] for key in keys}, "library_ms": None,
               "sass": sass.get(kk.name)}
        # the wide grid's numbers (K8's main ones are s=3 at 511; its s=2
        # numbers at 255 go beside them)
        if "wide" in r:
            row["wide"] = {key: r["wide"][key] for key in keys}
        if "at_255_s2" in r:
            row["at_255_s2"] = {label: {key: v[key] for key in keys}
                                for label, v in r["at_255_s2"].items()}
        # the dist kernels: the middle shard's numbers (multi spec), every
        # shard's and K2-dist's on the whole grid beside them
        for extra in ("per_iteration_over_k1", "plan", "at_511_s2",
                      "shards", "whole_grid", "at_63", "events_ms",
                      "launch_events_ms", "k1_launches_ms",
                      "k1_launches_events_ms",
                      "k2_launches_ms",
                      "per_iteration_ms", "four_branches_ms",
                      "form_bound_ms",
                      "k5_four_branches_ms", "four_launches_ms",
                      "four_branch_bounds_ms"):
            if extra in r:
                row[extra] = r[extra]
        rows.append(row)
    # K11, the dma-mode kernel: K7's kernel under the split gpu spec, its
    # launches those of the dma path
    rows.append({**K11_ROW, "route": "cuda",
                 "launches": dma_counts[K7_NAME][0], "paths": ["dma"],
                 **{key: k11[key] for key in keys}, "library_ms": None,
                 "sass": sass.get(K7_NAME)})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
