"""The work arithmetic of bench_torch/layers/: bytes per launch from the
grid's shape reproduce PERF.md section 6's MB per launch, and the
roofline shares built from them cannot pass 100% where the device time
is at least the bound."""

import pytest

import work

GROUPS = {g["group"]: g for g in work.load_groups()}
PEAKS = work.load_peaks()
G255 = (255, 153, 153)
G511 = (511, 307, 307)


@pytest.mark.parametrize("group, shape, mb", [
    ("K1 poisson_iter", G255, 119.4), ("K1 poisson_iter", G511, 963.2),
    ("K8 poisson_iter_sweeps", G511, 963.2),
    ("K2 poisson_iter_ext", G255, 167.1),
    ("K3 predict", G255, 168.1), ("K3 predict", G511, 1352.3),
    ("K4 correct", G255, 168.1), ("K4 correct", G511, 1352.3),
    ("K5 advect", G255, 191.8), ("K5 advect", G511, 1544.4),
])
def test_bytes_per_launch_match_the_kernel_table(group, shape, mb):
    assert round(work.bytes_per_launch(GROUPS[group], shape) / 1e6, 1) == mb


def test_k1_bound_is_set_by_bytes():
    t, which = work.launch_bound(GROUPS["K1 poisson_iter"], G255, PEAKS)
    assert which == "bytes"
    assert t == pytest.approx(119.4e6 / 3.35e12, rel=1e-3)


def _trace(groups, launches, us_per_launch):
    return {"groups": {name: {"us": launches * us_per_launch,
                              "launches": launches,
                              "layer": GROUPS[name]["layer"],
                              "spec": GROUPS[name]}
                       for name in groups}}


def test_iteration_roofline_counts_bytes_per_launch_not_per_iteration():
    """K8 at s = 3: a third of the launches of K1 for the same
    iterations, so the bytes bound falls by three while the operations
    bound stays: at the bytes bound's own time the share is 100%."""
    bound = work.bytes_per_launch(GROUPS["K8 poisson_iter_sweeps"], G511) \
        / PEAKS["hbm_bytes_per_s"] * 1e6
    tr = _trace(["K8 poisson_iter_sweeps"], 1000, bound)
    pct, which = work.iteration_roofline("poisson", tr, 3000, G511, PEAKS)
    assert which == "bytes" and pct == pytest.approx(100.0)
    assert work.iteration_roofline("advect", tr, 3000, G511, PEAKS) is None


def test_per_launch_roofline_of_k3_and_k4():
    tr = _trace(["K3 predict", "K4 correct"], 4, 100.0)
    pct, which = work.per_launch_roofline("predict_correct", tr, G255, PEAKS)
    assert which == "bytes"
    assert pct == pytest.approx(100 * 2 * 168.07e6 / 3.35e12 / 200e-6,
                                rel=1e-3)
