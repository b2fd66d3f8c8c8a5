"""The PyTorch port's configuration, grid and package boundary.

The port mirrors the JAX package's config dataclasses field for field (it
cannot import them: navierstokes3d_tpu/config.py imports jax), so these
tests hold the two copies equal in names and defaults, and check that the
port imports without jax, refuses a missing CUDA device, and never hands a
CPU tensor to the kernel loader.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import navierstokes3d_tpu.config as jcfg
import navierstokes3d_tpu.grid as jgrid
import navierstokes3d_tpu_torch as nt
import navierstokes3d_tpu_torch.config as tcfg
import navierstokes3d_tpu_torch.grid as tgrid
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import _build
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _fields_and_defaults(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = dataclasses.asdict(f.default_factory())
        else:
            default = dataclasses.MISSING
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["PhysicsConfig", "NumericsConfig",
                                  "IOConfig", "ParallelConfig", "SimConfig"])
def test_dataclass_fields_and_defaults_match(name):
    assert (_fields_and_defaults(getattr(tcfg, name))
            == _fields_and_defaults(getattr(jcfg, name)))


@pytest.mark.parametrize("preset", ["preset_gpu", "preset_multi"])
@pytest.mark.parametrize("kw", [{}, {"nx": 31, "nt": 3, "compat": False,
                                     "dtype": "float32"}])
def test_presets_match(preset, kw):
    a = dataclasses.asdict(getattr(tcfg, preset)(**kw))
    b = dataclasses.asdict(getattr(jcfg, preset)(**kw))
    assert a == b


@pytest.mark.parametrize("preset", ["preset_gpu", "preset_multi"])
@pytest.mark.parametrize("nx", [15, 17, 24, 63, 255])
def test_make_grid_matches(preset, nx):
    a = tgrid.make_grid(getattr(tcfg, preset)(nx=nx))
    b = jgrid.make_grid(getattr(jcfg, preset)(nx=nx))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for fn in ("xc", "yc", "zc", "xv", "yv", "zv"):
        np.testing.assert_array_equal(getattr(a, fn)(), getattr(b, fn)())
    assert a.field_shapes() == b.field_shapes()


def test_torch_dtype():
    assert tcfg.NumericsConfig(dtype="float32").torch_dtype == torch.float32
    assert tcfg.NumericsConfig().torch_dtype == torch.float64


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import navierstokes3d_tpu_torch\n"
            "import navierstokes3d_tpu_torch.run\n"
            "import navierstokes3d_tpu_torch.kernels\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'navierstokes3d_tpu.', 'flax')) or "
            "m == 'navierstokes3d_tpu')\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = nt.preset_gpu(nx=15, compat=False, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.ChorinSolver(cfg, device="cuda")


def test_solver_defaults_to_cuda():
    """ChorinSolver(cfg) targets the card: with none present it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cfg in (nt.preset_gpu(nx=15, compat=False, dtype="float32"),
                nt.preset_multi(nx=15, compat=False, dtype="float32")):
        with pytest.raises(RuntimeError, match="CUDA"):
            nt.ChorinSolver(cfg)


def test_unported_configs_raise():
    """What the solver refuses: the fdm backend under compat mode (the JAX
    package's rule; outside compat it is ported) and the hydrostatic split
    on the multi variant. float64 off the CPU outside compat mode is no
    longer refused: the dtype rule routes it to the plain versions
    (tests/test_torch_slice_f64.py holds the routes)."""
    for compat in (True, False):
        cfg = nt.preset_gpu(nx=15, compat=compat, dtype="float32")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm"))
        if compat:
            with pytest.raises(ValueError, match="fdm"):
                nt.ChorinSolver(cfg, device="cpu")
        else:
            assert nt.ChorinSolver(cfg, device="cpu")._fdm is not None
    assert nt.ChorinSolver(nt.preset_gpu(nx=15, compat=False),
                           device="meta").plain
    cfg = nt.preset_multi(nx=15, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                   pressure_split=True))
    with pytest.raises(NotImplementedError, match="pressure_split"):
        nt.ChorinSolver(cfg, device="cpu")


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def refuse():
        raise AssertionError("kernel loader called for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    kernels.reset_counts()
    gpu = nt.preset_gpu(nx=15, compat=False, dtype="float32")
    # the multi preset at eps_it=1e-9 runs its accuracy phase in its first
    # step: on K12 (its route), and on K2 with the route off (below)
    multi = nt.preset_multi(nx=15, compat=False, dtype="float32")
    multi = multi.replace(numerics=dataclasses.replace(multi.numerics,
                                                       eps_it=1e-9))
    # compat float32 runs K7
    compat = nt.preset_multi(nx=9, dtype="float32")
    # and the gpu preset with the sweep plan forced on runs K8
    for cfg, depths in ((gpu, ()), (multi, ()), (compat, ()), (gpu, (2,))):
        s = nt.ChorinSolver(cfg, device="cpu")
        s._sweep_depths = depths
        state, stats = s.step(s.init_state())
        assert stats.iters > 0
        if cfg is multi:
            assert stats.iters_ext > 0
    s = nt.ChorinSolver(multi, device="cpu")
    s._resident_plan = None
    assert s.step(s.init_state())[1].iters_ext > 0
    # the sharded step on an x-only mesh runs K2-dist, and K7-dist in
    # compat mode
    mesh = make_mesh((3, 1, 1), "cpu")
    for cfg in (multi, nt.preset_multi(nx=12, dtype="float32")):
        s = nt.ChorinSolver(cfg, device="cpu")
        state, stats = s.step_shard_map(mesh)(s.init_state())
        assert stats.iters > 0
    # the unchained step runs K6, and K10 runs behind make_resident
    s = nt.ChorinSolver(gpu, device="cpu", fused_step=False)
    state, stats = s.step(s.init_state())
    assert stats.iters > 0
    p = state.pr.clone()
    kp.make_resident(3)(p, state.dprdtau.clone(), p.clone(), s._op)
    # the stored-state criterion runs K13's pair form (the gpu steps above
    # ran its single-word form in their defect phase)
    assert np.isfinite(s.stored_residual_err(state,
                                             state_before=s.init_state()))
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name
        assert k.plain.calls > 0, k.name
    kernels.reset_counts()


def test_use_pallas_false_runs_plain_versions():
    """use_pallas=False: the solver calls the plain versions directly
    (the switch of the hand kernels), with the same results on the CPU."""
    cfg = nt.preset_gpu(nx=15, compat=False, dtype="float32")
    a = nt.ChorinSolver(cfg, device="cpu")
    b = nt.ChorinSolver(cfg.replace(use_pallas=False), device="cpu")
    assert b.plain and not a.plain
    sa, ta = a.step(a.init_state())
    sb, tb = b.step(b.init_state())
    assert (ta.iters, ta.iters_ext) == (tb.iters, tb.iters_ext)
    assert torch.equal(sa.pr, sb.pr) and torch.equal(sa.vx, sb.vx)


def test_build_sources_and_key():
    names = sorted(p.name for p in _build.sources())
    assert names == ["advect.cu", "common.cuh", "fused_step.cu",
                     "poisson.cu"]
    assert _build.build_key() == _build.build_key()
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SIGNATURES) == {
        "ns3d_poisson_iter", "ns3d_poisson_iter_ext", "ns3d_poisson_iter_bc",
        "ns3d_poisson_iter_sweeps", "ns3d_predict", "ns3d_correct",
        "ns3d_advect", "ns3d_poisson_iter_bc_dist",
        "ns3d_poisson_iter_ext_bc_dist", "ns3d_poisson_iter_resident",
        "ns3d_poisson_iter_resident_ext", "ns3d_comp_residual"}
