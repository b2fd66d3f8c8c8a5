"""The port's I/O layer (navierstokes3d_tpu_torch/io) and compat_api
against the JAX package's: the .bin layout and naming, the native writer
byte for byte against numpy's and the JAX package's, the .mat round trip,
checkpoints crossing between the two packages in both directions bitwise,
a bit-exact resume, and the reference's two entry functions at nx=10,
nt=1 against the JAX package's returns (float64 compat: the same
expressions, differences at the level of float64 rounding, held to 1e-10
of each field's max)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu.io import binio as jbinio
from navierstokes3d_tpu.io import checkpoint as jckpt
from navierstokes3d_tpu_torch.io import binio, checkpoint, matio, native

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def test_bin_roundtrip_column_major(tmp_path):
    """Julia's column-major write (NavierStokes3D_multi_gpu.jl:27-30):
    element (i,j,k) at flat index i + j*n1 + k*n1*n2."""
    a = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    p = binio.save_array(str(tmp_path / "t"), a)
    raw = np.fromfile(p, dtype=np.float32)
    assert raw[0] == a[0, 0, 0]
    assert raw[1] == a[1, 0, 0]          # i fastest
    assert raw[2] == a[0, 1, 0]          # then j
    assert raw[2 * 3] == a[0, 0, 1]      # then k
    np.testing.assert_array_equal(binio.load_array(p, a.shape),
                                  a.astype(np.float32))


def test_save_fields_naming_and_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    fields = {"C": rng.random((5, 4, 3)), "Pr": rng.normal(size=(5, 4, 3))}
    paths = binio.save_fields(str(tmp_path / "t"), 7, fields)
    want = jbinio.save_fields(str(tmp_path / "j"), 7, fields)
    assert paths["C"].endswith("out_C_v_0007.bin")
    assert sorted(paths) == sorted(want)
    for name in fields:
        assert os.path.basename(paths[name]) == os.path.basename(want[name])
        assert _read(paths[name]) == _read(want[name])


def test_native_writer_byte_identical(tmp_path):
    """csrc/ns3dio.cpp built into the package's _build/: byte-identical to
    the numpy writer, synchronous and asynchronous, and read back."""
    lib = native.lib()
    if lib is None:
        pytest.skip(f"native build unavailable: {native.build_error}")
    assert any(native.BUILD_DIR.glob("libns3dio-*.so"))
    a = np.random.default_rng(1).random((7, 5, 3)).astype(np.float32)
    assert native.write_f32(str(tmp_path / "n.bin"), a)
    a.flatten(order="F").tofile(str(tmp_path / "p.bin"))
    assert _read(tmp_path / "n.bin") == _read(tmp_path / "p.bin")
    np.testing.assert_array_equal(
        native.read_f32(str(tmp_path / "n.bin"), a.shape), a)
    for i in range(4):
        assert native.write_f32(str(tmp_path / f"a{i}.bin"), a + i,
                                asynchronous=True)
    native.drain()
    for i in range(4):
        np.testing.assert_array_equal(
            binio.load_array(str(tmp_path / f"a{i}.bin"), a.shape),
            a + np.float32(i))


def test_mat_roundtrip(tmp_path):
    pr = np.random.default_rng(0).random((3, 4, 5))
    p = matio.save_step_mat(str(tmp_path), 3, pr, pr, pr, pr, pr,
                            0.1, 0.2, 0.3)
    assert p.endswith("step_3.mat")
    d = matio.load_step_mat(p)
    np.testing.assert_array_equal(d["Pr"], pr)
    assert float(np.asarray(d["dx"]).reshape(-1)[0]) == 0.1


def _seeded_fields(grid, dtype, pr_lo, seed=3):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=s).astype(dtype)
           for k, s in grid.field_shapes().items()}
    out["pr_lo"] = (rng.normal(size=grid.shape_c).astype(dtype) * 1e-8
                    if pr_lo else None)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pr_lo", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_checkpoints_cross_between_packages(tmp_path, dtype, pr_lo, split):
    """A port checkpoint loads into the JAX package and a JAX checkpoint
    into the port, every field bitwise, with the step, the pressure
    convention and the optional low word."""
    g = nt.make_grid(nt.preset_multi(nx=9))
    f = _seeded_fields(g, dtype, pr_lo)
    tst = nt.state_from_numpy(f, device="cpu")
    p = checkpoint.save_checkpoint(str(tmp_path / "t" / "ckpt_0000005"),
                                   tst, 5, pressure_split=split)
    assert p.endswith(".npz") and os.path.exists(p)
    jst, it = jckpt.load_checkpoint(p, expect_pressure_split=split)
    assert it == 5
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jst, k)), f[k])
    assert (jst.pr_lo is None) == (not pr_lo)
    if pr_lo:
        np.testing.assert_array_equal(np.asarray(jst.pr_lo), f["pr_lo"])
    # and back: the JAX package writes, the port reads
    jst2 = ns.FlowState(**{k: jnp.asarray(f[k]) for k in FIELDS},
                        pr_lo=None if not pr_lo else jnp.asarray(f["pr_lo"]))
    q = jckpt.save_checkpoint(str(tmp_path / "j" / "ckpt_0000006.npz"),
                              jst2, 6, pressure_split=split)
    back, it = checkpoint.load_checkpoint(q, expect_pressure_split=split,
                                          device="cpu")
    assert it == 6
    for k in FIELDS + (("pr_lo",) if pr_lo else ()):
        t = getattr(back, k)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), f[k])
    assert (back.pr_lo is None) == (not pr_lo)
    with pytest.raises(ValueError, match="pressure_split"):
        checkpoint.load_checkpoint(q, expect_pressure_split=not split,
                                   device="cpu")


def test_load_checkpoint_casts_and_targets_the_card(tmp_path):
    g = nt.make_grid(nt.preset_multi(nx=9))
    f = _seeded_fields(g, np.float64, True)
    p = checkpoint.save_checkpoint(str(tmp_path / "ckpt_0000001.npz"),
                                   nt.state_from_numpy(f, device="cpu"), 1)
    st, _ = checkpoint.load_checkpoint(p, dtype=torch.float32, device="cpu")
    for k in FIELDS + ("pr_lo",):
        assert getattr(st, k).dtype == torch.float32
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      f[k].astype(np.float32))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            checkpoint.load_checkpoint(p)   # the card by default


def test_latest_checkpoint_skips_nanstate(tmp_path):
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    for name in ("ckpt_0000002.npz", "ckpt_0000010.npz",
                 "nanstate_0000011.npz", "other.npz"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith(
        "ckpt_0000010.npz")


def test_checkpoint_resume_bitexact(tmp_path):
    """A resumed run continues exactly where the original stopped (multi
    preset, float32: the stored pair's low word crosses too)."""
    s = nt.ChorinSolver(nt.preset_multi(nx=9, compat=False,
                                        dtype="float32"), device="cpu")
    state = s.init_state()
    for _ in range(2):
        state, _ = s.step(state)
    assert state.pr_lo is not None
    p = checkpoint.save_checkpoint(str(tmp_path / "ckpt_0000002.npz"),
                                   state, 2,
                                   pressure_split=s.pressure_split)
    cont = state
    for _ in range(2):
        cont, _ = s.step(cont)
    resumed, it = checkpoint.load_checkpoint(
        p, dtype=s.dtype, expect_pressure_split=s.pressure_split,
        device="cpu")
    assert it == 2
    for _ in range(2):
        resumed, _ = s.step(resumed)
    for k in FIELDS + ("pr_lo",):
        assert torch.equal(getattr(cont, k), getattr(resumed, k)), k


def test_compat_api_run_navierstokes3d_matches_jax(tmp_path):
    from navierstokes3d_tpu.compat_api import run_navierstokes3d as jrun
    from navierstokes3d_tpu_torch.compat_api import run_navierstokes3d
    got = run_navierstokes3d(do_vis=False, do_save=True, do_print=True,
                             nx=10, nt=1, out_dir=str(tmp_path / "out"),
                             device="cpu")
    want = jrun(do_vis=False, do_save=True, nx=10, nt=1,
                out_dir=str(tmp_path / "jout"))
    # gathered inner shapes as the reference returns (multi_gpu.jl:386-390)
    assert got[0].shape == (8, 4, 4) and got[2].shape == (9, 4, 4)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert isinstance(a, np.ndarray) and a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * max(1e-30, np.abs(b).max()))
    for name in ("C", "Pr", "Vx", "Vy", "Vz"):
        assert (tmp_path / "out" / f"out_{name}_v_0000.bin").exists()
    assert not np.isnan(got[1]).any()


def test_compat_api_runme_matches_jax(tmp_path):
    from navierstokes3d_tpu.compat_api import runme as jrunme
    from navierstokes3d_tpu_torch.compat_api import runme
    st = runme(do_vis=False, do_save=True, nx=10, nt=1,
               out_dir=str(tmp_path / "out"), device="cpu")
    want = jrunme(do_vis=False, do_save=False, nx=10, nt=1)
    assert (tmp_path / "out" / "step_0.mat").exists()
    for k in FIELDS:
        a, b = getattr(st, k).numpy(), np.asarray(getattr(want, k))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(b).max()),
                                   err_msg=k)
    m = matio.load_step_mat(str(tmp_path / "out" / "step_0.mat"))
    assert m["Pr"].shape == (10, 6, 6) and m["Vx"].shape == (11, 6, 6)


def test_entry_points_target_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from navierstokes3d_tpu_torch.compat_api import run_navierstokes3d, runme
    with pytest.raises(RuntimeError, match="CUDA"):
        run_navierstokes3d(nx=10, nt=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        runme(do_vis=False, nx=10, nt=1)


def test_viz_frame_and_animation(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    from navierstokes3d_tpu_torch.io import viz
    g = nt.make_grid(nt.preset_multi(nx=9))
    rng = np.random.default_rng(0)
    fields = {k: rng.random((7, 4, 4)) for k in ("Pr", "C", "Vx", "Vy",
                                                   "Vz")}
    for i in range(2):
        paths = viz.save_frame(str(tmp_path), i, g, fields, t=0.1 * i)
        assert len(paths) == 10
    gif = viz.make_animation(str(tmp_path), "Vx", "xy")
    assert os.path.getsize(gif) > 0
    p = viz.save_convergence(str(tmp_path), 0, [1, 2, 3], [1e-1, 1e-2, 1e-3])
    assert p.endswith("3D_NavierStokes_iter_0000.png")
