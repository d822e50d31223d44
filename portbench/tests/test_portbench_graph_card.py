"""The graph cell (arap262k_gn) on the card, at its full size (marked
`card`; skips without one):

    python3 -m pytest -c portbench/pytest.ini portbench/tests -m card

One solve through engine="auto" runs the graph engine with a K11 edge and
vertex pass and a K2 update for each of the 8 x 100 PCG iterations, the
kernels' spans inside opt.pcg; a traced solve keeps the spans off the
device track, every span metric reads a finite value, the PCG's kernels
do most of the kernel time and K11's roofline share lies under 100%."""

import math

import pytest
import torch

from portbench_testlib import bench
from portbench.benchlib import pcg, spans, window
from portbench.benchlib.profile import trace
from portbench.benchlib.runner import RunRecord
from portbench.benchlib.spec import load_cell, reader
from portbench.benchlib.work import peaks_for

pytestmark = pytest.mark.card

CELL = "arap262k_gn"
# launches a GN solve by counter, every other counter 0: K11's two passes
# and K2 for each of the 8 x 100 iterations (the classic hat-space loop);
# K9 and K10 for the outer steps' leaf partials and diagonals (counts that
# the plan's graph groups set)
LAUNCHES_A_SOLVE = {"K11.graph_hat_edge": 800, "K11.graph_hat_vertex": 800,
                    "K2.pcg_update": 800, "K9.graph_gather": 100,
                    "K10.graph_scatter": 32}
PCG_SPANS = ("opt.kernel.K11.", "opt.kernel.K2.")
METRICS = ("bind_ms", "bind_idle_ms", "loop_idle_ms", "wrapper_host_ms",
           "linearize_ms", "pcg_kernel_share_pct", "pcg_kernel_roofline_pct",
           "graph_apply_roofline_pct")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _within(ivs, s, e):
    return any(a <= s and e <= b for a, b in ivs)


def test_graph_cell_runs_its_launches_spans_and_readers(card):
    from opt_tpu_torch.runtime.trace import LAUNCHES

    cell = load_cell(bench(held=True), CELL, True)
    loop = window.Loop(window.new_plan(cell, card),
                       window.make_pool(cell, 2 ** 31 + 11))
    loop.solve()
    before = dict(LAUNCHES)
    _, cost = loop.solve()
    got = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
           if v != before.get(k, 0)}
    print(CELL, "launches a solve", got)
    assert (loop.plan.engine, loop.plan.variant) == ("graph", "classic")
    assert math.isfinite(cost)
    assert got == LAUNCHES_A_SOLVE

    tr = trace(torch, loop.solve, 2)
    assert tr.device
    assert not [n for n, _, _, _ in tr.device if n.startswith("opt.")]
    pcg_ivs = spans.intervals(tr, lambda n: n == "opt.pcg")
    assert len(pcg_ivs) == 2 * cell.config["nIterations"]
    kernel_spans = [s for s in tr.host if s[0].startswith(PCG_SPANS)]
    assert kernel_spans
    assert all(_within(pcg_ivs, s, e) for _, s, e in kernel_spans)

    run = RunRecord(1.0, [], 1.0, tr, {"seconds": 1.0}, cell,
                    peaks_for(torch.cuda.get_device_name()))
    values = {m: reader(m)(run) for m in METRICS}
    print(CELL, values)
    assert all(v is not None and math.isfinite(v) for v in values.values())
    solve_idle = spans.idle_ms_per_solve(tr, lambda n: n == "opt.solve")
    assert values["bind_idle_ms"] + values["loop_idle_ms"] <= (
        solve_idle + 1e-9)
    assert values["pcg_kernel_share_pct"] >= 50
    assert 0 < values["graph_apply_roofline_pct"] < 100
    assert 0 < values["pcg_kernel_roofline_pct"] < 100
    assert pcg.apply_kernel_names(cell) == ("graph_hat_edge",
                                            "graph_hat_vertex")
