"""The port's whole CLI (navierstokes3d_tpu_torch/run.py) on the CPU,
modelled on the JAX package's tests/test_io.py, test_defaults.py and
test_clamp_policy.py: the flags and defaults against the JAX package's
argparser, save/vis/checkpoint/resume with the total-horizon rule and
frame numbering, --log-jsonl, --sync-every, --abort-on-nan, the fdm
backend on one device and on a mesh, and the --on-clamp policies."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu import run as jrun
from navierstokes3d_tpu_torch import run as trun
from navierstokes3d_tpu_torch.io import binio, checkpoint, matio

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
# the JAX CLI's flags that stay behind: jax configuration, the TPU
# layout option, and multi-host initialization (ROADMAP queue 1, item 6)
LEFT_OUT = {"--x64", "--platform", "--flat-state", "--distributed"}


def _flags(ap):
    return {s for a in ap._actions for s in a.option_strings} - {"-h",
                                                                   "--help"}


def test_every_jax_flag_with_its_default():
    jap, tap = jrun.build_argparser(), trun.build_argparser()
    missing = _flags(jap) - LEFT_OUT - _flags(tap)
    assert not missing, missing
    jd, td = vars(jap.parse_args([])), vars(tap.parse_args([]))
    for key, val in jd.items():
        if "--" + key.replace("_", "-") not in LEFT_OUT:
            assert td[key] == val, key
    assert td["device"] == "cuda"
    assert (td["preset"], td["nx"], td["nt"]) == ("multi", 63, 10)


def test_cli_targets_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--nx", "9", "--nt", "1"])


def _base(tmp_path, *extra):
    return ["--preset", "multi", "--nx", "9", "--device", "cpu",
            "--out-dir", str(tmp_path / "out"),
            "--viz-dir", str(tmp_path / "viz"),
            "--ckpt-dir", str(tmp_path / "ck"), *extra]


def _summary(out):
    return json.loads(out.strip().splitlines()[-1])


def test_cli_end_to_end_resume(tmp_path, capsys):
    """save + vis + checkpoint + animate, then a resume to a larger total
    horizon (steps 5-6 only, frames numbered from the step), then the
    original command again (nothing to do); the resumed run's state is
    bitwise the uninterrupted run's."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    assert trun.main(_base(tmp_path, "--nt", "4", "--save", "--vis",
                           "--nvis", "2", "--nsave", "2",
                           "--checkpoint-every", "2", "--animate")) == 0
    out = capsys.readouterr().out
    assert out.count("step ") == 4 and _summary(out)["steps"] == 3
    assert (tmp_path / "out" / "out_Pr_v_0001.bin").exists()
    assert (tmp_path / "out" / "step_4.mat").exists()
    assert (tmp_path / "viz" / "3D_NavierStokes_xy_Pr_0001.png").exists()
    assert (tmp_path / "ck" / "ckpt_0000004.npz").exists()
    assert (tmp_path / "viz" / "Vx_xy.gif").stat().st_size > 0
    frame1 = tmp_path / "viz" / "3D_NavierStokes_xy_Pr_0001.png"
    mtime = frame1.stat().st_mtime_ns
    assert trun.main(_base(tmp_path, "--nt", "6", "--resume",
                           "--checkpoint-every", "2", "--vis", "--nvis",
                           "2")) == 0
    cap = capsys.readouterr()
    assert "resumed from" in cap.err and "ckpt_0000004.npz" in cap.err
    assert [ln.split(":")[0] for ln in cap.out.splitlines()
            if ln.startswith("step ")] == ["step 5", "step 6"]
    assert (tmp_path / "ck" / "ckpt_0000006.npz").exists()
    assert (tmp_path / "viz" / "3D_NavierStokes_xy_Pr_0003.png").exists()
    assert frame1.stat().st_mtime_ns == mtime
    assert trun.main(_base(tmp_path, "--nt", "4", "--resume")) == 0
    assert "nothing to do" in capsys.readouterr().err
    # the uninterrupted 6 steps
    s = nt.ChorinSolver(nt.preset_multi(nx=9, compat=False,
                                        dtype="float32"), device="cpu")
    st = s.init_state()
    for _ in range(6):
        st, _ = s.step(st)
    back, it = checkpoint.load_checkpoint(
        str(tmp_path / "ck" / "ckpt_0000006.npz"), device="cpu")
    assert it == 6
    for k in FIELDS + ("pr_lo",):
        assert torch.equal(getattr(back, k), getattr(st, k)), k


def test_cli_save_cadences_and_bin_bytes(tmp_path, capsys):
    """--nvis 3 --nsave 5 over 6 steps: viz frames at steps 0, 3 and 6,
    saves at 0 and 5 (independent cadences, gpu.jl:143,168); .mat keyed
    by the step with full-shape fields; the .bin bytes are numpy's
    column-major writer's on the same gathered field."""
    pytest.importorskip("matplotlib")
    assert trun.main(_base(tmp_path, "--nt", "5", "--vis", "--save",
                           "--nvis", "3", "--nsave", "5", "--quiet")) == 0
    out = capsys.readouterr().out
    assert "step " not in out and _summary(out)["steps"] == 4
    d = tmp_path / "out"
    assert (d / "out_Pr_v_0000.bin").exists()
    assert (d / "out_Pr_v_0001.bin").exists()
    assert not (d / "out_Pr_v_0002.bin").exists()
    assert (d / "step_0.mat").exists() and (d / "step_5.mat").exists()
    assert not (d / "step_1.mat").exists()
    m = matio.load_step_mat(str(d / "step_5.mat"))
    assert m["Pr"].shape == (9, 6, 6) and m["Vx"].shape == (10, 6, 6)
    pngs = sorted(p.name for p in (tmp_path / "viz").glob(
        "3D_NavierStokes_xy_Pr_*.png"))
    assert pngs == [f"3D_NavierStokes_xy_Pr_{i:04d}.png" for i in range(2)]
    # the frame of step 5 is the gathered inner field of the 5-step run
    s = nt.ChorinSolver(nt.preset_multi(nx=9, compat=False,
                                        dtype="float32"), device="cpu")
    st = s.init_state()
    for _ in range(5):
        st, _ = s.step(st)
    c, pr, vx, vy, vz = s.gather_inner(st)
    np.testing.assert_array_equal(
        binio.load_array(str(d / "out_Vx_v_0001.bin"), vx.shape), vx)
    pr.flatten(order="F").astype(np.float32).tofile(str(tmp_path / "p.bin"))
    with open(d / "out_Pr_v_0001.bin", "rb") as f1, \
            open(tmp_path / "p.bin", "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(m["Pr"], st.pr.numpy())


def test_cli_jsonl_and_sync_every(tmp_path, capsys):
    log = tmp_path / "steps.jsonl"
    assert trun.main(_base(tmp_path, "--nt", "5", "--sync-every", "3",
                           "--log-jsonl", str(log))) == 0
    out = capsys.readouterr().out
    lines = [json.loads(ln) for ln in open(log)]
    assert [ln["it"] for ln in lines] == [1, 2, 3, 4, 5]
    assert all({"iters", "err", "advect_clamped", "wall_s"} <= set(ln)
               for ln in lines)
    assert _summary(out)["steps"] == 4   # the first step is dropped
    # each step's line, in step order, with the step's counts
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [int(ln.split()[3]) for ln in steps] == [ln["iters"]
                                                     for ln in lines]


def test_cli_abort_on_nan(tmp_path, capsys):
    """A NaN-poisoned checkpoint makes the next step's residual
    non-finite: the run exits non-zero after writing a nanstate snapshot
    that latest_checkpoint never picks."""
    s = nt.ChorinSolver(nt.preset_multi(nx=9, compat=False,
                                        dtype="float32"), device="cpu")
    st = s.init_state()
    pr = st.pr.clone()
    pr[3, 2, 2] = float("nan")
    ck = tmp_path / "ck"
    checkpoint.save_checkpoint(str(ck / "ckpt_0000003.npz"),
                               st.replace(pr=pr), 3,
                               pressure_split=s.pressure_split)
    with pytest.raises(SystemExit, match="non-finite residual"):
        trun.main(_base(tmp_path, "--resume", "--nt", "6",
                        "--abort-on-nan", "--quiet"))
    assert (ck / "nanstate_0000004.npz").exists()
    assert checkpoint.latest_checkpoint(str(ck)).endswith("ckpt_0000003.npz")


def test_cli_fdm_single_device(tmp_path, capsys):
    """--poisson-backend fdm: the direct solve, rounds as iters, err below
    eps_it; equal to the solver's own fdm steps; with --compat refused."""
    assert trun.main(["--preset", "gpu", "--nx", "15", "--nt", "2",
                      "--device", "cpu", "--poisson-backend", "fdm",
                      "--checkpoint-every", "2", "--ckpt-dir",
                      str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "fdm direct solve" in out.splitlines()[0]
    cfg = nt.preset_gpu(nx=15, compat=False, dtype="float32")
    s = nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm")), device="cpu")
    st = s.init_state()
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    for k in range(2):
        st, stats = s.step(st)
        assert stats.err < 1e-3
        assert steps[k].startswith(f"step {k + 1}: iters {stats.iters} ")
    back, _ = checkpoint.load_checkpoint(
        str(tmp_path / "ck" / "ckpt_0000002.npz"), device="cpu",
        expect_pressure_split=False)
    for k in FIELDS + ("pr_lo",):
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    with pytest.raises(SystemExit, match="compat"):
        trun.main(["--nx", "9", "--device", "cpu", "--compat",
                   "--poisson-backend", "fdm"])


def test_cli_fdm_on_a_mesh(capsys):
    """fdm on a mesh of more than one shard takes the global-view path,
    which is not ported: exit 2; an explicit shard_map is refused as in
    the JAX package (its PT loop would ignore the backend)."""
    argv = ["--nx", "16", "--nt", "1", "--device", "cpu",
            "--poisson-backend", "fdm"]
    assert trun.main(argv + ["--mesh", "4x1x1"]) == 2
    err = capsys.readouterr().err
    assert "sharded" in err and "ROADMAP.md queue 1, item 6" in err
    with pytest.raises(SystemExit, match="global-view"):
        trun.main(argv + ["--mesh", "4x1x1", "--comm", "shard_map"])


def _hot():
    """A multi solver and a state whose vx displacement is ~8 cells a step,
    far beyond the select-shift window k=2."""
    s = nt.ChorinSolver(nt.preset_multi(nx=16, compat=False,
                                        dtype="float32"), device="cpu")
    st = s.init_state()
    big = 8.0 * s.grid.dx / s.grid.dt
    return s, st.replace(vx=torch.full_like(st.vx, big))


def test_clamp_policies():
    s, hot = _hot()
    assert s.advect_method == "selectshift"
    _, stats = s.step(hot)
    n = stats.advect_clamped
    assert n > 0
    with pytest.raises(SystemExit, match="ABORT"):
        trun.clamp_escalation("abort", s, 1, n, lambda: None)
    assert trun.clamp_escalation("warn", s, 1, n, lambda: None) is None
    assert s.advect_method == "selectshift"
    assert trun.clamp_escalation("abort", s, 1, 0, lambda: None) is None
    rebuilds = []

    def rebuild():
        rebuilds.append(lambda st: s.step(st))
        return rebuilds[-1]

    new = trun.clamp_escalation("gather", s, 1, n, rebuild)
    assert new is rebuilds[0] and s.advect_method == "gather"
    st, stats = new(hot)
    assert stats.advect_clamped == 0
    assert bool(torch.isfinite(st.pr).all())
    assert trun.clamp_escalation("gather", s, 2, 1, rebuild) is None
    assert len(rebuilds) == 1


def test_cli_on_clamp_gather(tmp_path, capsys):
    """--on-clamp gather through the CLI: the hot checkpoint's first step
    clamps, the policy switches the advection, the next step clamps
    none."""
    s, hot = _hot()
    checkpoint.save_checkpoint(str(tmp_path / "ck" / "ckpt_0000001.npz"),
                               hot, 1, pressure_split=s.pressure_split)
    log = tmp_path / "l.jsonl"
    assert trun.main(["--nx", "16", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path / "ck"), "--resume", "--nt", "3",
                      "--on-clamp", "gather", "--log-jsonl", str(log),
                      "--quiet"]) == 0
    assert "switching the advection backend" in capsys.readouterr().err
    clamps = [json.loads(ln)["advect_clamped"] for ln in open(log)]
    assert clamps[0] > 0 and clamps[1] == 0
    with pytest.raises(SystemExit, match="ABORT"):
        trun.main(["--nx", "16", "--device", "cpu", "--ckpt-dir",
                   str(tmp_path / "ck"), "--resume", "--nt", "3",
                   "--on-clamp", "abort", "--quiet"])


def test_cli_defaults_reach_the_solver(monkeypatch, capsys):
    """No flags but --device cpu and --nt: the multi preset at 63, compat
    off, float32, the JAX package's CLI defaults."""
    seen = {}

    def spy(cfg, device):
        seen["cfg"] = cfg
        raise SystemExit(0)
    monkeypatch.setattr(trun, "ChorinSolver", spy)
    with pytest.raises(SystemExit):
        trun.main(["--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.variant, cfg.numerics.nx, cfg.numerics.nt, cfg.compat,
            cfg.numerics.dtype) == ("multi", 63, 10, False, "float32")
