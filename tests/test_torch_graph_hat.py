"""K11 graph_hat_apply's two passes on the CPU: the plain versions of the
edge pass (graph_hat_edge_plain: each edge's tangent once, then every
leaf's c_a as rows of one (E, L_s) buffer per slot) and of the vertex pass
(graph_hat_vertex_plain: the segmented sums of those rows over each
vertex's CSR runs, the pointwise vertex terms, p, A_hat p and the block
partials of <p, A_hat p>), which the card's checks hold the two kernels
against.  For arap_mesh_deformation, embedded_mesh_deformation and
robust_nonrigid_alignment on the 12 x 12 mesh of
tests/test_torch_graph_evaluate.py, GN and LM, with and without p_prev:

  * each slot's rows against an independent float64 einsum of D and the
    tangent (rtol 1e-6 of the largest row value);
  * the vertex pass's sums bit for bit against a loop over each vertex's
    run in edge order from zero;
  * the two passes composed against graph_hat_apply_plain (rtol 1e-6) and
    against sq J^T J (sq p) + scs p from the JAX package's funcs.linearize
    (rtol 1e-5, as tests/test_torch_graph.py holds the apply);
  * HatTables making the passes' scratch (c, partials) once;
  * a plan past the edge pass's slot or leaf limit solving on "torch"."""

import copy

import numpy as np
import pytest
import torch

from opt_tpu_torch.ops import graph_cuda
from tests.test_torch_cuda import irregular_graph_inputs
from tests.test_torch_graph_evaluate import ENERGIES, graph_inputs, make_plans

torch.set_num_threads(1)

BETA = 0.61


def _t32(a):
    return torch.as_tensor(np.array(a, np.float32))


def _operator(tplan, inputs):
    xf, data = tplan.bind(inputs)
    op = graph_cuda.GraphOperator(tplan.funcs, data, tplan.layout,
                                  tplan.config.uses_lambda,
                                  graph_cuda.plan_meta(tplan))
    op.outer(xf)
    return xf, op


@pytest.fixture(scope="module", params=ENERGIES)
def hat(request):
    """One energy's tables at a seeded point, seeded vectors, and the JAX
    package's J p and J^T at the same point."""
    name = request.param
    inputs = graph_inputs(name, seed=2)
    jplan, tplan = make_plans(name)
    xf, op = _operator(tplan, inputs)
    n = xf.numel()
    rng = np.random.RandomState(4)
    vec = dict(r=rng.randn(n), p_prev=rng.randn(n), sq=rng.rand(n),
               ctc=0.5 + rng.rand(n))
    jx, jdata = jplan.bind(inputs)
    _, jvp, jt = jplan.funcs.linearize(jx, jdata)
    return dict(name=name, tplan=tplan, op=op, tables=op.tables, vec=vec,
                jvp=jvp, jt=jt)


def _args(hat, lm, prev):
    """(sq, scs, r, p_prev, beta) as float32 tensors (scs, p_prev and beta
    None where absent)."""
    v = hat["vec"]
    sq = _t32(v["sq"])
    scs = sq * sq * _t32(v["ctc"]) if lm else None
    p_prev = _t32(v["p_prev"]) if prev else None
    beta = torch.tensor(BETA) if prev else None
    return sq, scs, _t32(v["r"]), p_prev, beta


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _composed(t, sq, scs, r, p_prev, beta):
    c = graph_cuda.graph_hat_edge_plain(t, sq, r, p_prev, beta)
    return graph_cuda.graph_hat_vertex_plain(t, c, sq, scs, r, p_prev, beta)


@pytest.mark.parametrize("prev", [False, True], ids=["r", "p_prev"])
def test_edge_rows_match_einsum(hat, prev):
    """Row e, column k of slot s's buffer is sum_cr D_a[cr, e] t[cr, e]
    for the slot's k-th leaf a, t = sum_a D_a ps[unk(a), idx_slot(a)[e]]."""
    t = hat["tables"]
    sq, _, r, p_prev, beta = _args(hat, False, prev)
    got = graph_cuda.graph_hat_edge_plain(t, sq, r, p_prev, beta)
    v = hat["vec"]
    p = v["r"].astype(np.float32).astype(np.float64)
    if prev:
        p = p + BETA * v["p_prev"].astype(np.float32)
    ps = v["sq"].astype(np.float32) * p
    flat = t.flat_index.numpy()
    assert len(got) == len(t.graph)
    for rows, (_, n_res, leaves, D, idx) in zip(got, t.graph):
        Dl = D.double().numpy().reshape(len(leaves), n_res, -1)
        idx = idx.numpy()
        x = np.stack([ps[flat[u, idx[s]]] for s, u in leaves])
        tan = np.einsum("arE,aE->rE", Dl, x)
        c = np.einsum("arE,rE->aE", Dl, tan)
        assert len(rows) == idx.shape[0]
        for s, cs in enumerate(rows):
            cols = [a for a, (ls, _) in enumerate(leaves) if ls == s]
            assert cs.shape == (idx.shape[1], len(cols))
            _close(cs.numpy(), c[cols].T, 1e-6,
                   f"{hat['name']} slot {s} rows")


def test_vertex_sums_are_an_edge_order_loop(hat):
    """The vertex pass's J^T of the rows, bit for bit: per group and slot,
    each vertex's run summed from zero in edge order, then added into its
    leaf's unknown channel, slot after slot; and the vertex twin's A_hat p
    is those sums where sq = 1 with no scs and no vertex terms."""
    t = hat["tables"]
    sq, _, r, _, _ = _args(hat, False, False)
    c = graph_cuda.graph_hat_edge_plain(t, sq, r)
    got = graph_cuda.hat_vertex_sums(t, c)
    n_verts = t.flat_index.shape[1]
    want = np.zeros(tuple(t.flat_index.shape), np.float32)
    for (_, _, leaves, _, _), rows, csr in zip(t.graph, c, t.incidence):
        for s, (cs, (order, rowptr)) in enumerate(zip(rows, csr)):
            cs, order, rowptr = cs.numpy(), order.numpy(), rowptr.numpy()
            unks = [u for ls, u in leaves if ls == s]
            for w in range(n_verts):
                for k, u in enumerate(unks):
                    acc = np.float32(0)
                    for j in range(rowptr[w], rowptr[w + 1]):
                        acc = np.float32(acc + cs[order[j], k])
                    want[u, w] = np.float32(want[u, w] + acc)
    np.testing.assert_array_equal(got.numpy(), want)
    bare = copy.copy(t)
    bare.fit = None
    _, ap, _ = graph_cuda.graph_hat_vertex_plain(bare, c, torch.ones_like(r),
                                                 None, r)
    np.testing.assert_array_equal(ap[t.flat_index].numpy(), want)


@pytest.mark.parametrize("prev", [False, True], ids=["r", "p_prev"])
@pytest.mark.parametrize("lm", [False, True], ids=["gn", "lm"])
def test_passes_compose_to_the_apply(hat, lm, prev):
    """Edge pass then vertex pass: graph_hat_apply_plain's p, A_hat p and
    <p, A_hat p> (the partials' sum), rtol 1e-6."""
    t = hat["tables"]
    args = _args(hat, lm, prev)
    sq, scs, r, p_prev, beta = args
    p, ap, parts = _composed(t, *args)
    want_p, want_ap, want_dot = graph_cuda.graph_hat_apply_plain(t, *args)
    assert parts.shape == t.partials.shape
    assert (p is r) == (not prev)
    _close(p, want_p, 1e-6, "p")
    _close(ap, want_ap, 1e-6, "A_hat p")
    _close(torch.sum(parts), want_dot, 1e-6, "<p, A_hat p>")
    # each partial is its block of vertices' share of the dot
    dots = torch.sum((p * ap)[t.flat_index], dim=0)
    block = graph_cuda.VERTEX_THREADS
    for b in range(parts.numel()):
        _close(parts[b], torch.sum(dots[b * block:(b + 1) * block]), 1e-6,
               f"partial {b}")


@pytest.mark.parametrize("prev", [False, True], ids=["r", "p_prev"])
@pytest.mark.parametrize("lm", [False, True], ids=["gn", "lm"])
def test_passes_compose_to_jax_linearize(hat, lm, prev):
    """Edge pass then vertex pass against sq J^T J (sq p) + scs p from the
    JAX package's linearize at the same point, rtol 1e-5."""
    t, tplan = hat["tables"], hat["tplan"]
    args = _args(hat, lm, prev)
    sq, scs, r, p_prev, beta = args
    p, ap, parts = _composed(t, *args)
    views = lambda v: {k: np.asarray(a)
                       for k, a in tplan.layout.views(v).items()}
    pack = lambda d: tplan.layout.pack({k: _t32(a) for k, a in d.items()})
    want = sq * pack(hat["jt"](hat["jvp"](views(sq * p))))
    if lm:
        want = want + scs * p
    _close(ap, want, 1e-5, f"{hat['name']} A_hat p")
    _close(torch.sum(parts), torch.dot(p, want), 1e-5, "<p, A_hat p>")


def test_tables_make_their_scratch_once(hat):
    """c and partials exist from HatTables' construction, each slot's rows a
    view of c at a 16-byte boundary, and an outer step (set_partials) or an
    apply keeps them; the host table is the device table."""
    op, t = hat["op"], hat["tables"]
    c, parts = t.c, t.partials
    n_verts = t.flat_index.shape[1]
    assert parts.numel() == -(-n_verts // graph_cuda.VERTEX_THREADS)
    for rows, (_, _, leaves, _, idx) in zip(t.c_rows, t.graph):
        for s, cs in enumerate(rows):
            width = sum(1 for ls, _ in leaves if ls == s)
            assert cs.shape == (idx.shape[1], width)
            off = (cs.data_ptr() - c.data_ptr()) // 4
            assert off % 4 == 0 and off + cs.numel() <= c.numel()
    np.testing.assert_array_equal(t.meta.numpy(), t.meta_host)
    xf, _ = hat["tplan"].bind(graph_inputs(hat["name"], seed=2))
    op.outer(xf)
    graph_cuda.graph_hat_apply(t, *_args(hat, True, True))
    assert t.c is c and t.partials is parts
    assert t.c.data_ptr() == c.data_ptr()


@pytest.mark.parametrize("lm", [False, True], ids=["gn", "lm"])
def test_passes_compose_on_an_irregular_graph(lm):
    """arap on a graph with an isolated vertex, a star vertex of 40 edges and
    E not a multiple of the edge pass's block: the composed passes against
    graph_hat_apply_plain, rtol 1e-6."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    inputs, dims = irregular_graph_inputs()
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(
        energies.arap_mesh_deformation, "LMGPU"), dims)
    xf, op = _operator(tplan, inputs)
    t = op.tables
    n = xf.numel()
    rng = np.random.RandomState(7)
    sq = _t32(rng.rand(n))
    args = (sq, sq * sq if lm else None, _t32(rng.randn(n)),
            _t32(rng.randn(n)), torch.tensor(BETA))
    p, ap, parts = _composed(t, *args)
    want = graph_cuda.graph_hat_apply_plain(t, *args)
    _close(ap, want[1], 1e-6, "A_hat p")
    _close(torch.sum(parts), want[2], 1e-6, "<p, A_hat p>")
    deg = [np.diff(rp.numpy()) for _, rp in t.incidence[0]]
    assert min(d.min() for d in deg) == 0 and max(d.max() for d in deg) >= 40


def _hyperedge_energy(n_slots, n_unknowns, width):
    """A linear energy on an n_slots graph whose one residual vector reads
    each of n_unknowns unknowns of width channels at every slot: a graph
    group of n_slots * n_unknowns * width leaves."""

    def energy(O):
        N = O.Dim("N", 0)
        n_edges = O.Dim("NUMEDGES", 1)
        kind = O.opt_float if width == 1 else getattr(O, f"opt_float{width}")
        xs = [O.Unknown(f"X{i}", kind, (N,), i) for i in range(n_unknowns)]
        slots = []
        for s in range(n_slots):
            slots += [f"v{s}", (N,), n_unknowns + s]
        G = O.Graph("G", (n_edges,), *slots)
        res = 0
        for i, x in enumerate(xs):
            for s in range(n_slots):
                res = res + (i + s + 1) * x(getattr(G, f"v{s}"))
        O.Energy(res - 1.0)

    return energy


@pytest.mark.parametrize("n_slots,n_unknowns,width,leaves", [
    (9, 1, 1, 9), (3, 3, 4, 36)], ids=["9_slots", "36_leaves"])
def test_plans_past_the_edge_pass_limits_solve_on_torch(
        monkeypatch, n_slots, n_unknowns, width, leaves):
    """A graph group of more than MAX_SLOTS slots or MAX_LEAVES leaves is
    refused by plan_meta for that limit alone (raised, the plan holds),
    engine="graph" raises, and engine="auto" solves it on "torch" to a
    finite cost."""
    import opt_tpu_torch

    n, n_edges = 30, 40
    rng = np.random.RandomState(3)
    inputs = {f"X{i}": rng.randn(n, width).astype(np.float32)
              for i in range(n_unknowns)}
    inputs["G"] = {f"v{s}": rng.randint(0, n, n_edges).astype(np.int32)
                   for s in range(n_slots)}
    ts = opt_tpu_torch.NewState(device="cpu")
    plan = ts.problem_plan(ts.problem_define(
        _hyperedge_energy(n_slots, n_unknowns, width), "gaussNewtonGPU"),
        [n, n_edges])
    assert graph_cuda.plan_meta(plan) is None
    assert not graph_cuda.supports_plan(plan)
    with monkeypatch.context() as m:
        m.setattr(graph_cuda, "MAX_SLOTS", 64)
        m.setattr(graph_cuda, "MAX_LEAVES", 64)
        (group,) = graph_cuda.plan_meta(plan)["graph_groups"]
    assert (len(group["slots"]), len(group["leaves"])) == (n_slots, leaves)
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 5)
    with pytest.raises(ValueError, match="32 leaves on 8 slots"):
        plan.solve(inputs, engine="graph")
    cost = plan.solve(inputs)
    assert plan.engine == "torch" and np.isfinite(cost)
