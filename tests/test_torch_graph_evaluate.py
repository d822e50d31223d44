"""The port's graph reads and graph term groups (compile/evaluate.py,
compile/plan_fns.py) against the JAX package's take mode
(NewState(graph_mode="take")), on the same seeded inputs: for
arap_mesh_deformation, embedded_mesh_deformation and
robust_nonrigid_alignment on a 12 x 12 triangulated mesh (144 vertices,
726 edges), the cost, J^T F, diag(J^T J), every per-leaf partial D_a and
J^T J p on a random p, at rtol 1e-5 of each quantity's largest magnitude
(whole-grid quantities, docs/GUIDE.md:204-207).  Also the graph input
checks of Plan.bind and the rejection of InBounds and Index in a graph
residual."""

import numpy as np
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu_torch import energies
from chip_smoke import tri_grid_graph

torch.set_num_threads(1)

W = 12
RTOL = 1e-5
ENERGIES = ["arap_mesh_deformation", "embedded_mesh_deformation",
            "robust_nonrigid_alignment"]


def graph_inputs(name, w=W, seed=0):
    """Seeded inputs for one graph energy on a w x w mesh: half of the
    vertices constrained (the rest free, -1e7), unknowns away from their
    trivial values so every partial is exercised."""
    v0, v1 = tri_grid_graph(w, w)
    n = w * w
    rng = np.random.RandomState(seed)
    ur = rng.randn(n, 3).astype(np.float32)
    cons = np.full((n, 3), -1e7, np.float32)
    sel = rng.choice(n, n // 2, replace=False)
    cons[sel] = ur[sel] + 0.2 * rng.randn(len(sel), 3).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    inputs = {"Offset": f32(ur + 0.1 * rng.randn(n, 3)), "UrShape": ur,
              "Constraints": cons, "w_fitSqrt": 2.0, "w_regSqrt": 1.0,
              "G": {"v0": v0, "v1": v1}}
    if name == "embedded_mesh_deformation":
        rot = np.tile(np.eye(3).reshape(1, 9), (n, 1))
        inputs["RotMatrix"] = f32(rot + 0.1 * rng.randn(n, 9))
        inputs["w_rotSqrt"] = 0.5
    else:
        inputs["Angle"] = f32(0.3 * rng.randn(n, 3))
    if name == "robust_nonrigid_alignment":
        nrm = rng.randn(n, 3)
        inputs["ConstraintNormals"] = f32(
            nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
        inputs["RobustWeights"] = f32(1.0 + 0.1 * rng.randn(n, 1))
    return inputs


def make_plans(name, w=W, kind="gaussNewtonGPU"):
    v0, _ = tri_grid_graph(w, w)
    dims = [w * w, len(v0)]
    js = opt_tpu.NewState(graph_mode="take")
    jplan = js.problem_plan(js.problem_define(
        getattr(jax_energies, name), kind), dims)
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(getattr(energies, name), kind),
                            dims)
    return jplan, tplan


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


def close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.fixture(scope="module", params=ENERGIES)
def both(request):
    """Every quantity of one energy from both packages at one point."""
    name = request.param
    inputs = graph_inputs(name)
    jplan, tplan = make_plans(name)
    out = {}

    jx, jdata = jplan.bind(inputs)
    jf = jplan.funcs
    rng = np.random.RandomState(1)
    p = {n: rng.randn(*s).astype(np.float32)
         for n, s in tplan.funcs.unknown_shapes.items()}
    r0, jvp, jt = jf.linearize(jx, jdata)
    out["jax"] = dict(
        cost=jf.cost(jx, jdata), jtf=jt(r0), diag=jf.diag_jtj(jx, jdata),
        partials=[D for _, _, D in jf.leaf_partials(jx, jdata)],
        jtjp=jt(jvp({n: np.asarray(v) for n, v in p.items()})))

    xf, data = tplan.bind(inputs)
    x = tplan.layout.views(xf)
    tf = tplan.funcs
    r0, jvp, jt = tf.linearize(x, data)
    out["torch"] = dict(
        cost=tf.cost(x, data), jtf=jt(r0), diag=tf.diag_jtj(x, data),
        partials=[D for _, _, D in tf.leaf_partials(x, data)],
        jtjp=jt(jvp({n: torch.as_tensor(v) for n, v in p.items()})))
    return name, out


def test_graph_cost_matches_jax(both):
    name, out = both
    close(out["torch"]["cost"], out["jax"]["cost"], f"{name} cost")


@pytest.mark.parametrize("what", ["jtf", "diag", "jtjp"])
def test_graph_unknown_quantities_match_jax(both, what):
    """J^T F, diag(J^T J) and J^T J p, unknown by unknown."""
    name, out = both
    got, want = out["torch"][what], out["jax"][what]
    assert set(got) == set(want)
    for n in want:
        close(got[n], want[n], f"{name} {what} {n}")


def test_graph_leaf_partials_match_jax(both):
    name, out = both
    got, want = out["torch"]["partials"], out["jax"]["partials"]
    assert [len(D) for D in got] == [len(D) for D in want]
    for k, (Dg, Dw) in enumerate(zip(got, want)):
        for a, (dg, dw) in enumerate(zip(Dg, Dw)):
            close(dg, dw, f"{name} group {k} leaf {a}")


def test_graph_indices_as_dotted_keys():
    """"G.v0" / "G.v1" keys bind as {"G": {...}} does."""
    inputs = graph_inputs("arap_mesh_deformation")
    _, tplan = make_plans("arap_mesh_deformation")
    g = inputs.pop("G")
    dotted = dict(inputs, **{"G.v0": g["v0"], "G.v1": g["v1"]})
    _, a = tplan.bind(dict(inputs, G=g))
    _, b = tplan.bind(dotted)
    for s in ("v0", "v1"):
        assert torch.equal(a["graph_indices"]["G"][s],
                           b["graph_indices"]["G"][s])
        assert a["graph_indices"]["G"][s].dtype == torch.int32
        for u, v in zip(a["graph_incidence"]["G"][s],
                        b["graph_incidence"]["G"][s]):
            assert torch.equal(u, v)


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing graph indices G.v1"),
    ("range", "out of range"),
    ("negative", "out of range"),
    ("length", "slot length mismatch"),
])
def test_graph_bind_errors(fault, match):
    inputs = graph_inputs("arap_mesh_deformation")
    _, tplan = make_plans("arap_mesh_deformation")
    v0, v1 = inputs["G"]["v0"].copy(), inputs["G"]["v1"].copy()
    if fault == "missing":
        inputs["G"] = {"v0": v0}
    elif fault == "range":
        v1[3] = W * W
        inputs["G"] = {"v0": v0, "v1": v1}
    elif fault == "negative":
        v0[0] = -1
        inputs["G"] = {"v0": v0, "v1": v1}
    else:
        inputs["G"] = {"v0": v0, "v1": v1[:-1]}
    with pytest.raises((KeyError, ValueError), match=match):
        tplan.bind(inputs)


@pytest.mark.parametrize("guard", ["InBounds", "Index"])
def test_bounds_and_index_rejected_in_graph_residuals(guard):
    def energy(O):
        N = O.Dim("N", 0)
        E = O.Dim("E", 1)
        X = O.Unknown("X", O.opt_float, (N,), 0)
        G = O.Graph("G", (E,), "v0", (N,), 1, "v1", (N,), 2)
        r = X(G.v0) - X(G.v1)
        if guard == "InBounds":
            O.Energy(O.Select(O.InBounds(0), r, 0.0))
        else:
            O.Energy(r * O.Index(0))

    ts = opt_tpu_torch.NewState(device="cpu")
    plan = ts.problem_plan(ts.problem_define(energy, "gaussNewtonGPU"),
                           [5, 4])
    xf, data = plan.bind({"X": np.ones(5, np.float32),
                          "G": {"v0": np.arange(4), "v1": np.arange(1, 5)}})
    with pytest.raises(ValueError, match=f"{guard} used in a graph residual"):
        plan.funcs.cost(plan.layout.views(xf), data)
