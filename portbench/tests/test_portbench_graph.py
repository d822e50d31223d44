"""The graph cell (arap262k_gn) on the CPU: its generator, the work it
counts by hand, the readers of its kernels and spans on hand-built traces,
and the plain graph reference's Jacobian against finite differences and a
dense J^T J.  At the small mesh the graph engine's kernel wrappers run
their plain versions (K9, K10, K11, K2)."""

import numpy as np
import pytest
import torch

from portbench_testlib import bench, small_cell
import bench as repo_bench  # the repository's bench.py, on the path now
from portbench.benchlib import pcg, window
from portbench.benchlib.profile import Trace
from portbench.benchlib.runner import RunRecord, counted_over
from portbench.benchlib.spec import load_cell, reader
from portbench.benchlib.work import (apply_call, bound, cell_calls,
                                     peaks_for, solve_calls)
from portbench.energies import arap_mesh_deformation as arap

CELL = "arap262k_gn"
H100 = peaks_for("NVIDIA H100 80GB HBM3")
N, E = 262_144, 1_568_770
BW = 3.35e12
GRAPHS = [w["name"] for w in bench(held=True)["workloads"]
          if getattr(load_cell(bench(held=True), w["name"], False).energy(),
                     "EDGE", None) is not None]


# -- the generator -----------------------------------------------------------

def test_mesh_is_the_triangulated_grid_of_bench():
    cell = load_cell(bench(held=True), CELL, False)
    assert cell.config["dims"] == [N, E]
    assert arap.side_of(cell.config["dims"]) == 512
    for got, want in zip(arap.tri_grid_graph(512, 512),
                         repo_bench.tri_grid_graph(512, 512)):
        assert got.dtype == np.int32 and np.array_equal(got, want)
    with pytest.raises(ValueError):
        arap.side_of([N, E + 1])
    with pytest.raises(ValueError):
        arap.side_of([N + 1, E])


def test_pool_is_one_mesh_with_seeded_handles():
    """Every entry holds the same topology and rest shape; the seed sets the
    frame: rows 0-1 at rest, the last two rows and the disc each moved by
    one vector in [-5, 5]^3, every other vertex free, the same vertices
    constrained in every entry; and the entries differ."""
    cell, _ = small_cell(CELL)
    big = 2 ** 31 + 4321
    pool = window.make_pool(cell, big)
    assert len(pool) == 4
    side = arap.side_of(cell.config["dims"])
    pinned, top, disc = arap.handles(side)
    assert disc.sum() > 0 and not (disc & (pinned | top)).any()
    first = pool[0]
    for x in pool:
        for k in ("v0", "v1"):
            assert np.array_equal(x["G"][k], first["G"][k])
        assert np.array_equal(x["UrShape"], first["UrShape"])
        ur, cons = x["UrShape"], x["Constraints"]
        assert np.array_equal(cons[pinned], ur[pinned])
        for handle in (top, disc):
            move = cons[handle] - ur[handle]
            assert np.allclose(move, move[0], atol=1e-5)
            assert np.all(np.abs(move) <= arap.MOVE + 1e-5)
        free = ~(pinned | top | disc)
        assert np.all(cons[free] == arap.FREE)
        assert np.all(np.abs(x["Offset"] - ur) < 0.1)
        assert not x["Angle"].any()
    assert len({x["Constraints"].tobytes() for x in pool}) == len(pool)
    again = window.make_pool(cell, big)
    assert all(np.array_equal(a["Constraints"], b["Constraints"])
               and np.array_equal(a["Offset"], b["Offset"])
               for a, b in zip(pool, again))


# -- the work the cell counts ------------------------------------------------

def test_work_arap262k_gn_by_hand():
    cell = load_cell(bench(held=True), CELL, False)
    assert counted_over(cell) == f"{N} vertices and {E} edges"
    calls = cell_calls(cell, H100["l2_bytes"])
    # vertices from dims[0], edges from dims[1]
    assert calls == solve_calls(arap.POINT, N, False, 8, 100,
                                H100["l2_bytes"], arap.EDGE, E)
    # the loop's working set: six 6.3 MB vectors, x and the constants (48
    # words a vertex) and 12.55 MB of indices, 62.9 MB, past the 50 MB L2:
    # each of the 8 x 100 iterations is a call
    assert N * 48 * 4 + E * 8 == 62_881_808
    its = [c for c in calls if c[0] == "pcg_iteration"]
    assert len(its) == 800 and len(calls) == 1 + 8 * 2 + 800
    # an iteration reads p, r, delta, pre (24 words) and what the apply needs
    # (Angle, UrShape, Constraints' channel 0: 7) a vertex, writes delta, r,
    # p (18), and reads the two index words an edge; K11's 27 partials an
    # edge are not counted
    assert its[1][1] == N * 49 * 4 + E * 2 * 4 == 63_930_384
    assert its[1][2] == N * (220 + 12 * 6) + E * 110
    assert its[0][1] == N * (12 + 7 + 18) * 4 + E * 8
    assert its[99][1] == N * (24 + 7 + 6) * 4 + E * 8
    per_it = 63_930_384 / BW
    assert per_it == pytest.approx(19.08e-6, rel=1e-3)
    assert its[1][2] / 67e12 < per_it / 3
    lin = [c for c in calls if c[0] == "linearize"]
    assert lin[0][1] == N * 24 * 4 + E * 8 == 37_715_984
    assert calls[0] == ("cost", N * 12 * 4 + E * 8, N * 165 + E * 33)
    assert pcg.pcg_bound_s(cell, H100) == pytest.approx(
        8 * (98 * per_it + (its[0][1] + its[99][1]) / BW), rel=1e-9)
    # the apply: p, the scaling and the apply's reads in, A_hat p out (25
    # words a vertex), the indices: 38.8 MB, 11.57 us; 800 a solve
    one = apply_call(arap.POINT, N, arap.EDGE, E)
    assert one[1] == N * 25 * 4 + E * 8 == 38_764_560
    assert bound([one], H100)["seconds"] == pytest.approx(11.571e-6,
                                                          rel=1e-3)
    assert pcg.apply_bound_s(cell, H100) == pytest.approx(
        800 * 38_764_560 / BW, rel=1e-9)
    assert bound(calls, H100)["bytes_share"] > 0.99


def test_work_arap262k_lm_by_hand():
    """LM on the configuration (no cell): ctc and b besides, and a reset's
    apply every 10th iteration, on the vertices and the edges."""
    cell = load_cell(bench(held=True), CELL, False)
    cell.traffic = dict(cell.traffic, solver="LMGPU")
    calls = cell_calls(cell, H100["l2_bytes"])
    its = [c for c in calls if c[0] == "pcg_iteration"]
    assert its[1][1] == N * 61 * 4 + E * 8
    assert its[9][2] == N * (220 + 72 + 220) + E * 220
    assert its[8][2] == N * (220 + 72) + E * 110
    assert pcg.apply_bound_s(cell, H100) == pytest.approx(
        880 * 38_764_560 / BW, rel=1e-9)


# -- the readers -------------------------------------------------------------

US = 1000  # ns


def _graph_trace(solves=2):
    """Each solve: K11's edge pass [0, 200] us and vertex pass [200, 300],
    K2 [300, 350], K9 [350, 400], torch's sum [400, 450], an HtoD copy
    [450, 550]; an opt.linearize span [340, 420] us; the solves 1 ms
    apart."""
    rows = [("void (anonymous namespace)::graph_hat_edge_kernel<3, 9>"
             "(EdgeGroup)", 0, 200, "kernel"),
            ("(anonymous namespace)::graph_hat_vertex_kernel(float const*)",
             200, 100, "kernel"),
            ("(anonymous namespace)::pcg_update_kernel(float const*)", 300,
             50, "kernel"),
            ("void (anonymous namespace)::graph_gather_kernel<float, 3>",
             350, 50, "kernel"),
            ("void at::native::reduce_kernel<512, 1>", 400, 50, "kernel"),
            ("Memcpy HtoD (Pageable -> Device)", 450, 100, "h2d")]
    device = [(n, (1000 * i + s) * US, d * US, k) for i in range(solves)
              for n, s, d, k in rows]
    host = [("opt.linearize", (1000 * i + 340) * US, (1000 * i + 420) * US)
            for i in range(solves)]
    return Trace(solves, 0.002, device, host)


def _record(trace, cell, work=True):
    return RunRecord(1.0, [], 1.0, trace, {"seconds": 1.0} if work else None,
                     cell, H100 if work else None)


@pytest.mark.parametrize("solves", [1, 2])
def test_graph_readers_read_the_apply_and_the_loop(solves):
    cell = load_cell(bench(held=True), CELL, True)
    tr = _graph_trace(solves)
    rec = _record(tr, cell)
    # K11 and K2: 350 us of 450 us of kernels
    assert reader("pcg_kernel_share_pct")(rec) == pytest.approx(
        100 * 350 / 450)
    assert reader("pcg_kernel_roofline_pct")(rec) == pytest.approx(
        100 * pcg.pcg_bound_s(cell, H100) / 350e-6)
    # the apply: K11's two passes alone, 300 us a solve
    assert reader("graph_apply_roofline_pct")(rec) == pytest.approx(
        100 * pcg.apply_bound_s(cell, H100) / 300e-6)
    assert reader("linearize_ms")(rec) == pytest.approx(0.08)


def test_graph_readers_are_none_where_there_is_nothing_to_read():
    cell = load_cell(bench(held=True), CELL, True)
    read = reader("graph_apply_roofline_pct")
    assert read(_record(None, cell)) is None
    assert read(_record(_graph_trace(), cell, work=False)) is None
    assert read(_record(_graph_trace(), None)) is None
    # a grid cell's energy names no apply kernels of its own
    assert read(_record(_graph_trace(),
                        load_cell(bench(held=True), "warp2048_gn", True))) is None
    tr = _graph_trace()
    tr.device = [ev for ev in tr.device if "graph_hat" not in ev[0]]
    assert read(_record(tr, cell)) is None
    tr.host = []
    assert reader("linearize_ms")(_record(tr, cell)) is None


# -- the plain graph reference -----------------------------------------------

def _linearized(name, seed):
    """The reference linearized at a perturbed point of a 12 x 12 mesh,
    small enough for a dense J, and a direction p."""
    cell, _ = small_cell(name)
    cell.config = dict(cell.config, dims=[144, 770])
    inputs = window.make_pool(cell, seed)[0]
    en = cell.reference().build(inputs, torch.float64, "cpu")
    g = torch.Generator().manual_seed(seed)
    x = en.x0 + 0.3 * torch.randn(en.x0.shape, generator=g,
                                  dtype=torch.float64)
    p = torch.randn(x.shape, generator=g, dtype=torch.float64)
    en.linearize(x)
    return en, x, p


def _dense_j(en, x):
    """J of every family's residuals at x, stacked, as a dense matrix."""
    def residuals(flat):
        xx = flat.view(x.shape)
        return torch.cat([en._residual(f, xx).reshape(-1)
                          for f in en.families])

    return torch.autograd.functional.jacobian(residuals, x.reshape(-1))


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_jtj_jtf_and_diag_match_a_dense_j(name):
    """J^T J p, J^T F and diag(J^T J) from the per-edge blocks against a
    dense J of the residuals at x (autograd over the whole residual
    vector): the gathers, the index_add_ scatters and the blocks agree."""
    en, x, p = _linearized(name, 11)
    J = _dense_j(en, x)
    F = torch.cat([r.reshape(-1) for _, r, _ in en._blocks])
    assert torch.allclose(en.jtj(p).reshape(-1), J.T @ (J @ p.reshape(-1)),
                          rtol=1e-12, atol=1e-10)
    assert torch.allclose(en.jtf().reshape(-1), J.T @ F, rtol=1e-12,
                          atol=1e-10)
    assert torch.allclose(en.diag().reshape(-1), (J * J).sum(0), rtol=1e-12,
                          atol=1e-10)
    # and each family's J p row by row
    jp = torch.cat([v.reshape(-1) for v in en._j(p)])
    assert torch.allclose(jp, J @ p.reshape(-1), rtol=1e-12, atol=1e-10)
    assert en.model_cost(p) == pytest.approx(
        0.5 * float(torch.sum((F + J @ p.reshape(-1)) ** 2)), rel=1e-12)
