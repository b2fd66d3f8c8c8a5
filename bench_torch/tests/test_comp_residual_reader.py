"""The compensated residual's kernel group (layers/k13_comp_residual.json)
and its reader (metrics/comp_residual_roofline.py): bytes a launch at the
gpu cells' grids, no counter (a program without the kernel has no
wrapper to count it), the bytes bound setting the launch's bound, and the
reader on synthetic traces: None without a K13 launch (a program without
the kernel) or without a trace, a share under 100% where the device time
is above the bound, 100% at the bound."""

import re

import pytest

import harness
import work

GROUPS = {g["group"]: g for g in work.load_groups()}
PEAKS = work.load_peaks()
K13 = "K13 comp_residual"
G255 = (255, 153, 153)
G511 = (511, 307, 307)


def _reader():
    name = "comp_residual_roofline"
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py",
                               "bench_metric_" + re.sub(r"\W", "_", name))


@pytest.mark.parametrize("shape, mb", [(G255, 95.5), (G511, 770.6)])
def test_k13_bytes_per_launch(shape, mb):
    assert round(work.bytes_per_launch(GROUPS[K13], shape) / 1e6, 1) == mb


def test_k13_group_names_no_counter_and_matches_both_forms():
    g = GROUPS[K13]
    assert "counter" not in g
    assert g["ops_per"] == "launch" and g["ops_per_cell"] == 180
    for w in (1, 2):
        name = ("void (anonymous namespace)::comp_residual_kernel<%d>(float "
                "const*, float const*, (anonymous namespace)::RhsPair, "
                "float*, (anonymous namespace)::QuadRows, int, int, int, "
                "int, unsigned int*)" % w)
        assert any(re.search(p, name) for p in g["patterns"])
    assert not any(re.search(p, "poisson_iter_kernel")
                   for p in g["patterns"])


def test_k13_bound_is_set_by_bytes():
    t, which = work.launch_bound(GROUPS[K13], G511, PEAKS)
    assert which == "bytes"
    assert t == pytest.approx(770.6e6 / 3.35e12, rel=1e-3)


def _ctx(launches, us_per_launch, steps=4, grid=G255, logs=None):
    groups = {name: {"us": 0.0, "launches": 0, "layer": g["layer"],
                     "spec": g} for name, g in GROUPS.items()}
    groups[K13].update(us=launches * us_per_launch, launches=launches)
    tr = {"groups": groups, "steps": [{"iters": 1}] * steps}
    return {"trace": tr, "grid": grid, "peaks": PEAKS,
            "log": (logs.append if logs is not None else lambda *a: None)}


def test_reader_is_none_without_k13_launches_or_trace():
    read = _reader().read
    assert read(_ctx(0, 0.0)) is None
    ctx = _ctx(8, 70.0)
    del ctx["trace"]["groups"][K13]
    assert read(ctx) is None
    assert read(dict(_ctx(8, 70.0), trace=None)) is None


@pytest.mark.parametrize("grid", [G255, G511])
def test_reader_share(grid):
    bound_us = work.bytes_per_launch(GROUPS[K13], grid) / PEAKS[
        "hbm_bytes_per_s"] * 1e6
    logs = []
    share = _reader().read(_ctx(8, 2.0 * bound_us, grid=grid, logs=logs))
    assert share == pytest.approx(50.0)
    assert "2.00 launches a step" in logs[0]
    assert _reader().read(_ctx(4, bound_us, grid=grid)) == pytest.approx(
        100.0)
