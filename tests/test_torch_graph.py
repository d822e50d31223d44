"""The port's "graph" engine (ops/graph_cuda.py) on the CPU, through the
plain versions of K9 graph_gather, K10 graph_scatter and K11
graph_hat_apply, against the JAX package:

  * K9 and K10 against jnp.take and jax.ops.segment_sum, and against the
    TPU kernels they replace, onehot_gather_blocks and
    onehot_scatter_windows in interpret mode, on the banded operands
    tests/test_graph_banded.py builds, mapped to flat vertex indices as
    opt_tpu/runtime/api.py:517-521 maps them;
  * K11 against sq J^T J (sq p) + scs p from the JAX package's
    funcs.linearize (rtol 1e-5);
  * whole solves, GN and LM, on engine="graph" and engine="torch", for
    arap_mesh_deformation, embedded_mesh_deformation and
    robust_nonrigid_alignment on a 12 x 12 mesh, 2 outer x 10 PCG with the
    LM residual reset at PCG iteration 5, against the JAX package's
    plan.solve (take mode) and GraphPcgKernel(plan).solve in interpret
    mode (banded mode, as tests/test_graph_pcg_kernel.py runs it), at
    rtol 1e-4, the bound for re-associated inner loops;
  * the engine pick, and a kernel that fails on launch raising through
    Plan.solve with no fallback."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import opt_tpu
from opt_tpu.ops import graph_banded as gb
from opt_tpu.ops import graph_pcg_kernel as gpk
from opt_tpu.ops import onehot_pallas
from opt_tpu_torch.ops import build, graph_cuda
from tests.test_graph_banded import _mesh_graph
from tests.test_torch_graph_evaluate import (ENERGIES, W, close, graph_inputs,
                                             make_plans)
from tests.test_torch_stream import _FailingLibrary

torch.set_num_threads(1)

PARAMS = (("nIterations", 2), ("lIterations", 10),
          ("residual_reset_period", 5))


def test_mesh_inputs_are_bench_copies():
    for w, h in ((12, 12), (7, 5)):
        for a, b in zip(chip_smoke.tri_grid_graph(w, h),
                        bench.tri_grid_graph(w, h)):
            np.testing.assert_array_equal(a, b)
    rigid = chip_smoke.arap_inputs(20, rigid=True)
    moved = rigid["Constraints"] > -1e6
    assert moved.all(axis=1).sum() == 200
    np.testing.assert_array_equal(
        rigid["Constraints"][moved],
        (rigid["UrShape"] + np.float32(0.1))[moved])


@pytest.mark.parametrize("c", [1, 6])
def test_gather_and_scatter_match_take_and_segment_sum(c):
    v0, v1 = chip_smoke.tri_grid_graph(9, 7)
    n = 63
    rng = np.random.RandomState(3)
    v = rng.randn(n, c).astype(np.float32)
    x = rng.randn(len(v0), c).astype(np.float32)
    idx = np.stack([v0, v1])
    got = graph_cuda.graph_gather(torch.as_tensor(v), torch.as_tensor(idx))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.take(jnp.asarray(v), idx, axis=0)))
    order, rowptr = (torch.as_tensor(a) for a in graph_cuda.incidence(v1, n))
    out = graph_cuda.graph_scatter(torch.as_tensor(x), torch.as_tensor(v1),
                                   order, rowptr)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(v1),
                               num_segments=n)
    close(out, want, "scatter")


def test_incidence_is_csr_in_edge_order():
    idx = np.array([3, 0, 3, 1, 0, 3], np.int32)
    order, rowptr = graph_cuda.incidence(idx, 5)
    np.testing.assert_array_equal(order, [1, 4, 3, 0, 2, 5])
    np.testing.assert_array_equal(rowptr, [0, 2, 3, 3, 6, 6])


def test_gather_and_scatter_match_onehot_kernels():
    """The TPU's one-hot kernels (interpret mode) on banded operands
    against K9 and K10 on the same values at the flat indices the banding
    stands for: window row loc of vertex block b is padded vertex
    (b - 1) vb + loc."""
    slots, n = _mesh_graph()
    vb = gb.plan_vertex_banding({"G": slots}, n, force=True)
    g = vb.graphs["G"]
    rng = np.random.RandomState(17)
    c = 2
    vals = rng.randn(n, c).astype(np.float32)
    pb = jnp.pad(jnp.asarray(vals), ((0, g.n_vblk * g.vb - n), (0, 0)))
    ws = gb._split3(gb._windows(pb.reshape(g.n_vblk, g.vb, c)))
    loc = np.asarray(g.loc["v1"])
    real = loc >= 0
    flat = (loc + (np.arange(g.n_vblk)[:, None] - 1) * g.vb)[real]
    flat = torch.as_tensor(flat.astype(np.int32))

    got = gb._recomb(np.asarray(onehot_pallas.onehot_gather_blocks(
        jnp.asarray(loc), ws, interpret=True)), c)
    mine = graph_cuda.graph_gather(torch.as_tensor(np.asarray(pb)), flat)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(got)[real])

    e = rng.randn(g.n_vblk, g.eb, c).astype(np.float32)
    win = gb._recomb(np.asarray(onehot_pallas.onehot_scatter_windows(
        jnp.asarray(loc), gb._split3(jnp.asarray(e)), 3 * g.vb,
        interpret=True)), c)
    n_pad = g.n_vblk * g.vb
    folded = np.zeros((n_pad + 2 * g.vb, c), np.float32)
    for b in range(g.n_vblk):  # window b starts at padded row (b - 1) vb
        folded[b * g.vb:(b + 3) * g.vb] += win[b]
    order, rowptr = (torch.as_tensor(a)
                     for a in graph_cuda.incidence(flat.numpy(), n_pad))
    mine = graph_cuda.graph_scatter(torch.as_tensor(e[real]), flat, order,
                                    rowptr)
    close(mine, folded[g.vb:g.vb + n_pad], "scatter vs one-hot windows")


def _graph_operator(tplan, inputs):
    xf, data = tplan.bind(inputs)
    op = graph_cuda.GraphOperator(tplan.funcs, data, tplan.layout,
                                  tplan.config.uses_lambda,
                                  graph_cuda.plan_meta(tplan))
    return xf, op


@pytest.mark.parametrize("name", ENERGIES)
def test_hat_apply_matches_jax_linearize(name):
    """K11's plain version over the materialized partials against
    sq J^T J (sq p) + scs p from JAX's linearize at the same point, with
    and without p_prev and scs."""
    inputs = graph_inputs(name, seed=2)
    jplan, tplan = make_plans(name)
    xf, op = _graph_operator(tplan, inputs)
    op.outer(xf)
    n = xf.numel()
    rng = np.random.RandomState(4)
    r, p_prev = rng.randn(n), rng.randn(n)
    sq, ctc = rng.rand(n), 0.5 + rng.rand(n)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    beta = 0.61

    jx, jdata = jplan.bind(inputs)
    _, jvp, jt = jplan.funcs.linearize(jx, jdata)
    views = lambda v: {k: np.asarray(a) for k, a in
                       tplan.layout.views(t32(v)).items()}
    pack = lambda d: tplan.layout.pack({k: t32(a) for k, a in d.items()})
    for lm in (False, True):
        for prev in (False, True):
            p = t32(r) + np.float32(beta) * t32(p_prev) if prev else t32(r)
            want = t32(sq) * pack(jt(jvp(views(t32(sq) * p))))
            scs = t32(sq) * t32(sq) * t32(ctc) if lm else None
            if lm:
                want = want + scs * p
            extra = (t32(p_prev), torch.tensor(beta)) if prev else ()
            got_p, got, dot = graph_cuda.graph_hat_apply(
                op.tables, t32(sq), scs, t32(r), *extra)
            close(got_p, p, f"{name} p")
            close(got, want, f"{name} A_hat p (lm={lm}, p_prev={prev})")
            close(dot, torch.dot(p, want), f"{name} <p, A_hat p>")


@pytest.fixture(scope="module", params=[(e, k) for e in ENERGIES
                                        for k in ("gaussNewtonGPU", "LMGPU")],
                ids=lambda c: f"{c[0]}-{c[1]}")
def jax_solved(request):
    """The JAX package's final costs: plan.solve in take mode, and
    GraphPcgKernel's solve in interpret mode on the banded layout."""
    name, kind = request.param
    inputs = graph_inputs(name, seed=5)
    jplan, _ = make_plans(name, kind=kind)
    for key, value in PARAMS:
        jplan.set_solver_parameter(key, value)
    take = jplan.solve(inputs)
    js = opt_tpu.NewState(graph_mode="banded")
    bplan = js.problem_plan(js.problem_define(
        getattr(__import__("opt_tpu").energies, name), kind), jplan.dims)
    for key, value in PARAMS:
        bplan.set_solver_parameter(key, value)
    bplan.bind(inputs)
    assert gpk.supports(bplan)
    kernel = gpk.GraphPcgKernel(bplan).solve(inputs)["final_cost"]
    return name, kind, inputs, take, kernel


@pytest.mark.parametrize("engine", ["graph", "torch"])
def test_graph_solves_match_jax(jax_solved, engine):
    name, kind, inputs, take, kernel = jax_solved
    _, tplan = make_plans(name, kind=kind)
    for key, value in PARAMS:
        tplan.set_solver_parameter(key, value)
    cost = tplan.solve(inputs, engine=engine)
    assert tplan.engine == engine
    assert tplan.variant == ("classic" if engine == "graph" else None)
    assert np.isfinite(cost)
    assert cost == pytest.approx(take, rel=1e-4)
    assert cost == pytest.approx(kernel, rel=1e-4)
    for arr in tplan.unknowns().values():
        assert np.isfinite(arr).all()


@pytest.mark.parametrize("name", ENERGIES)
def test_auto_picks_graph_on_a_cuda_plan(name):
    """engine="auto" gives "graph" for a float32 plan on a CUDA device that
    K11 holds, and "torch" on the CPU and in float64.  The plans are made
    on the CPU and then named cuda: the route reads only the plan."""
    _, tplan = make_plans(name)
    assert graph_cuda.supports_plan(tplan)
    assert tplan._pick_engine("auto") == "torch"
    tplan.device = torch.device("cuda")
    assert tplan._pick_engine("auto") == "graph"
    assert tplan._pick_engine("graph") == "graph"
    ts = opt_tpu_torch_state(double_precision=True)
    dplan = ts.problem_plan(ts.problem_define(
        getattr(__import__("opt_tpu_torch").energies, name),
        "gaussNewtonGPU"), tplan.dims)
    dplan.device = torch.device("cuda")
    assert dplan._pick_engine("auto") == "torch"
    with pytest.raises(ValueError, match="engine='graph'"):
        dplan._pick_engine("graph")


def opt_tpu_torch_state(**kw):
    import opt_tpu_torch

    return opt_tpu_torch.NewState(device="cpu", **kw)


def test_graph_engine_rejects_grid_energies():
    from opt_tpu_torch import energies

    ts = opt_tpu_torch_state()
    plan = ts.problem_plan(ts.problem_define(energies.image_warping,
                                             "gaussNewtonGPU"), [16, 16])
    assert graph_cuda.plan_meta(plan) is None
    plan.device = torch.device("cuda")
    assert plan._pick_engine("auto") == "cuda"
    with pytest.raises(ValueError, match="engine='graph'"):
        plan._pick_engine("graph")


class _OneFailing(_FailingLibrary):
    """A kernel library whose one named graph kernel reports
    cudaErrorLaunchFailure and whose other graph kernels launch nothing."""

    def __init__(self, failing):
        self.failing = failing

    def __getattr__(self, name):
        if name.startswith("opt_graph_") and not name.endswith("_blocks"):
            if name != self.failing:
                return lambda *args: 0
        return super().__getattr__(name)


@pytest.mark.parametrize("failing", [
    "opt_graph_gather", "opt_graph_scatter", "opt_graph_hat_apply"])
def test_failed_launch_raises_with_no_fallback(monkeypatch, failing):
    """K9, K10 or K11 failing on launch raises out of Plan.solve: no engine
    catches it and carries on with another."""
    lib = _OneFailing(failing)
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "all_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(build, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream", lambda: ctypes.c_void_p(0))
    _, tplan = make_plans("arap_mesh_deformation")
    for key, value in PARAMS:
        tplan.set_solver_parameter(key, value)
    name = failing[len("opt_"):]
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 719"):
        tplan.solve(graph_inputs("arap_mesh_deformation"), engine="graph")
    assert tplan.engine == "graph"
