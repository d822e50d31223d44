"""The readers of the program's spans (benchlib/spans.py and the metrics
bind_ms, bind_idle_ms, loop_idle_ms, wrapper_host_ms): exact values on a
hand-built trace, None on a trace without spans; and, on the card (marked
`card`), a traced solve of each cell's engine."""

import math

import pytest

from portbench_testlib import bench, small_cell
from portbench.benchlib import spans
from portbench.benchlib.profile import Trace
from portbench.benchlib.runner import RunRecord
from portbench.benchlib.spec import load_cell, reader

SPAN_METRICS = ("bind_ms", "bind_idle_ms", "loop_idle_ms", "wrapper_host_ms")
MS = 1_000_000  # ns


def _solve(t0):
    """One solve's host spans and device events, starting at t0 ms: bind
    [0, 20] with the device busy [5, 18]; init [20, 30], busy [25, 30];
    a step [30, 90], busy [30, 40] and [50, 90]; kernel wrappers K3 [22,
    28], K13 [40, 50], K11's apply [60, 70] around its edge pass [61,
    65]."""
    host = [("opt.solve", 0, 100), ("opt.bind", 0, 20),
            ("aten::copy_", 0, 20), ("opt.init", 20, 30),
            ("opt.kernel.K3.warp_linearize", 22, 28), ("opt.step", 30, 90),
            ("opt.linearize", 30, 40),
            ("opt.kernel.K13.resident_pcg", 40, 50),
            ("opt.kernel.K11.graph_hat_apply", 60, 70),
            ("opt.kernel.K11.graph_hat_edge", 61, 65), ("opt.read", 90, 100)]
    device = [("Memcpy HtoD", 5, 7, "h2d"), ("k", 10, 8, "kernel"),
              ("k", 25, 15, "kernel"), ("k", 50, 45, "kernel")]
    return ([(n, (t0 + s) * MS, (t0 + e) * MS) for n, s, e in host],
            [(n, (t0 + s) * MS, d * MS, k) for n, s, d, k in device])


def _trace(solves=2):
    host, device = [], []
    for i in range(solves):
        h, d = _solve(1000 * i)
        host += h
        device += d
    return Trace(solves, 0.2, device, host)


def _run(trace):
    return RunRecord(1.0, [], 1.0, trace, None)


@pytest.mark.parametrize("solves", [1, 2])
def test_span_metrics_read_exactly(solves):
    run = _run(_trace(solves))
    got = {m: reader(m)(run) for m in SPAN_METRICS}
    assert got == {"bind_ms": 20.0, "bind_idle_ms": 7.0,
                   "loop_idle_ms": 15.0, "wrapper_host_ms": 26.0}


def test_span_metrics_are_none_without_spans():
    tr = _trace()
    tr.host = [ev for ev in tr.host if not ev[0].startswith("opt.")]
    for m in SPAN_METRICS:
        assert reader(m)(_run(tr)) is None
        assert reader(m)(_run(None)) is None


def test_idle_is_the_interval_less_the_union_of_device_events():
    tr = Trace(1, 0.0, [("a", 10, 30, "kernel"), ("b", 20, 5, "kernel"),
                        ("c", 60, 10, "memset"), ("d", 95, 50, "kernel")],
               [("opt.step", 0, 100), ("opt.step", 200, 250)])
    busy = spans.DeviceBusy(tr)
    assert busy.ivs == [(10, 40), (60, 70), (95, 145)]
    assert busy.within_ns(0, 100) == 30 + 10 + 5
    assert busy.within_ns(30, 65) == 10 + 5
    assert busy.within_ns(200, 250) == 0
    assert spans.idle_ms_per_solve(tr, lambda n: n == "opt.step") == (
        (100 - 45) + 50) / 1e6
    assert spans.covered_ns([(0, 10), (5, 20), (30, 31)]) == 21


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.card
@pytest.mark.parametrize("name", ["warp512_gn", "vol128_gn"])
def test_traced_solve_keeps_spans_off_the_device_track(card, name):
    """The cuda engine at 512^2 (the cell's own size) and stream3d at a
    small volume: no device event is named after a span, every span
    metric reads a finite value, and the idle time the bind and the loop
    spans see lies within the idle time of their solves."""
    from portbench.benchlib import window
    from portbench.benchlib.profile import trace

    torch = card
    if name == "warp512_gn":
        cell, engine = load_cell(bench(), name, True), "cuda"
    else:
        cell, engine = small_cell(name, trace=True)
    pool = window.make_pool(cell, 2 ** 31 + 7)
    loop = window.Loop(window.new_plan(cell, "cuda"), pool, engine)
    loop.solve()
    tr = trace(torch, loop.solve, 3)
    assert loop.plan.engine == engine
    assert tr.device
    assert not [n for n, _, _, _ in tr.device if n.startswith("opt.")]
    run = _run(tr)
    got = {m: reader(m)(run) for m in SPAN_METRICS}
    print(name, got)
    assert all(v is not None and math.isfinite(v) for v in got.values())
    solve_idle = spans.idle_ms_per_solve(tr, lambda n: n == "opt.solve")
    assert got["bind_idle_ms"] + got["loop_idle_ms"] <= solve_idle + 1e-9
