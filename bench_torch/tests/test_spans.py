"""The spans pass's reduction (spans.reduce, spans.metrics) on a synthetic
event list, and the pass itself on the CPU at a tiny grid.

The synthetic step (times in us): ns3d.step 0-100 > ns3d.poisson 5-60 >
ns3d.read 20-30, then ns3d.advect 60-100. The device runs k1 (launched at
10, inside ns3d.poisson) from 12 to 22, the read's copy to the host
(launched at 21, inside ns3d.read) from 22 to 23, idles while the host
returns from the read and sits in the next launch's Python (the gap
23-40 begins inside ns3d.read, though most of it lies after it), runs k2
(launched at 35 inside ns3d.poisson) from 40 to 70, after ns3d.poisson
closed at 60, then the advection's k3 (launched at 65 inside ns3d.advect,
so queued when the device finished k2: a dispatch gap) from 75 to 80. A cudaMalloc at 62 lies inside ns3d.advect; the harness's
copy (launched at 101, after the step) runs 110-111."""

import pytest
import torch

import harness
import spans

SPANS = [(0.0, 100.0, "ns3d.step"), (5.0, 60.0, "ns3d.poisson"),
         (20.0, 30.0, "ns3d.read"), (60.0, 100.0, "ns3d.advect")]
DEV = [(12.0, 22.0, "poisson_iter_kernel", 1),
       (22.0, 23.0, "Memcpy DtoH (Device -> Pageable)", 2),
       (40.0, 70.0, "poisson_iter_kernel", 3),
       (75.0, 80.0, "advect_kernel", 4),
       (110.0, 111.0, "Memcpy DtoD (Device -> Device)", 5)]
CALLS = [(10.0, 11.0, "cudaLaunchKernel", 1),
         (21.0, 21.5, "cudaMemcpyAsync", 2),
         (35.0, 36.0, "cudaLaunchKernel", 3),
         (62.0, 64.0, "cudaMalloc", 90),
         (65.0, 66.0, "cudaLaunchKernel", 4),
         (101.0, 102.0, "cudaMemcpyAsync", 5)]
GROUPS = [{"patterns": ["poisson_iter_kernel"]},
          {"patterns": ["advect_kernel"]}]


def test_reduce_places_ops_and_gaps_by_the_host():
    red = spans.reduce(SPANS, DEV, CALLS, GROUPS)
    by = red["spans"]
    step = by["ns3d.step"]
    poisson = by["ns3d.step>ns3d.poisson"]
    read = by["ns3d.step>ns3d.poisson>ns3d.read"]
    advect = by["ns3d.step>ns3d.advect"]
    # k2 ran after ns3d.poisson closed: it is the solve's, by its launch
    assert poisson["device_us"] == pytest.approx(10 + 1 + 30)
    assert read["device_us"] == pytest.approx(1)
    assert read["torch_ops_us"] == pytest.approx(1)
    assert advect["device_us"] == pytest.approx(5)
    # the device waited on the host from 23 to 40, a gap that began
    # inside ns3d.read; k3 was queued before the gap 70-75 began: a
    # dispatch gap of ns3d.advect, which launched it
    assert read["wait_us"] == pytest.approx(17)
    assert poisson["wait_us"] == pytest.approx(17)
    assert advect["wait_us"] == 0
    assert advect["queued_us"] == pytest.approx(5)
    assert step["wait_us"] == pytest.approx(17)
    assert step["queued_us"] == pytest.approx(5)
    assert red["read_wait_us"] == pytest.approx(17)
    assert red["step_idle_us"] == pytest.approx(22)
    # the step's device window: k1's start to k3's end; the gap 80-110,
    # begun in ns3d.advect past that window, is the harness's
    assert red["step_window_us"] == pytest.approx(80 - 12)
    assert red["outside_idle_us"] == pytest.approx(30)
    assert advect["mallocs"] == 1 and step["mallocs"] == 1
    assert red["mallocs_in_steps"] == 1 and red["mallocs_outside"] == 0
    assert red["longest_waits"] == [
        (pytest.approx(17), "ns3d.step>ns3d.poisson>ns3d.read")]
    assert step["reads"] == poisson["reads"] == read["reads"] == 1
    assert step["host_us"] == 100
    assert step["self_us"] == pytest.approx(100 - 55 - 40)
    assert poisson["self_us"] == pytest.approx(55 - 10)
    assert red["steps"] == 1 and red["unmatched"] == 0
    assert red["hidden_reads"] == 0
    m = spans.metrics(red, reads=1, steps=1)
    assert m == {"host_reads_per_step": 1.0,
                 "read_wait_ms_per_step": pytest.approx(0.017),
                 "step_idle_pct": pytest.approx(100 * 22 / 68)}


def test_reduce_counts_what_it_cannot_place():
    """A device op whose launch is missing from the trace counts as
    unmatched; a copy to the host outside ns3d.read as a hidden read; a
    gap inside a step clipped to the step's device window."""
    dev = DEV + [(81.0, 82.0, "Memcpy DtoH (Device -> Pageable)", 6),
                 (85.0, 86.0, "kernel_without_launch", 77)]
    calls = CALLS + [(78.0, 79.0, "cudaMemcpyAsync", 6),
                     (105.0, 106.0, "cudaMalloc", 91)]
    red = spans.reduce(SPANS, dev, calls, GROUPS)
    assert red["unmatched"] == 1 and red["hidden_reads"] == 1
    assert red["mallocs_in_steps"] == 1 and red["mallocs_outside"] == 1
    assert red["step_window_us"] == pytest.approx(82 - 12)
    # the gap 80-81 (the copy queued) lies inside the window; 82-85 and
    # 86-110 began in ns3d.advect past the window's end: the harness's
    assert red["step_idle_us"] == pytest.approx(22 + 1)
    assert red["outside_idle_us"] == pytest.approx(3 + 24)


def test_merge_adds_the_cycles():
    """Two traced cycles merged: counts and sums doubled, per span too;
    the per-step numbers those of one cycle."""
    red = spans.reduce(SPANS, DEV, CALLS, GROUPS)
    two = spans.merge([red, red])
    assert two["steps"] == 2 and two["read_wait_us"] == 2 * red["read_wait_us"]
    read = "ns3d.step>ns3d.poisson>ns3d.read"
    assert two["spans"][read]["wait_us"] == 2 * red["spans"][read]["wait_us"]
    assert two["spans"][read]["count"] == 2
    assert len(two["longest_waits"]) == 2
    assert spans.metrics(two, reads=2, steps=2) == spans.metrics(
        red, reads=1, steps=1)


def test_metrics_without_a_device():
    red = spans.reduce(SPANS, [], [], GROUPS)
    assert spans.metrics(red, reads=3, steps=1) == {
        "host_reads_per_step": 3.0, "read_wait_ms_per_step": None,
        "step_idle_pct": None}


def test_the_pass_on_the_cpu():
    """The pass on the cell at nx 15 on the CPU: the counter's reads, no
    device numbers; `result` runs no pass where the harness's trace saw
    no device work (ctx["trace"] None), and caches what it found."""
    cell = harness.load_cell("multi255.step1.pt", 15)
    lines = []
    ctx = {"cell": cell, "log": lines.append, "trace": None}
    torch.set_num_threads(2)
    assert spans.result(ctx) is None and "ns3d_spans" in ctx
    assert lines == []
    out = spans.run(ctx, "cpu")
    assert out["host_reads_per_step"] >= 2
    assert out["step_idle_pct"] is None
    assert any("ns3d.poisson.phase1" in ln for ln in lines)
    assert any("new pool segments in each cycle" in ln for ln in lines)
