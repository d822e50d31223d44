"""Levenberg-Marquardt and pipelined PCG in the port's solver, held against
opt_tpu on the same numpy inputs: whole solves through the port's "torch"
engine (the plain engine) and its "cuda" engine (whose kernel wrappers run
their closed-form plain versions on CPU tensors), the predicated loops
against the JAX while loops where the zeta exit and the `done` flag fire,
LM's model cost, and the closed forms' LM additions (CtC, model cost).

Whole solves are held at rtol 1e-4, the bound for re-associated inner
loops (docs/GUIDE.md:204-207); one-shot quantities at rtol 1e-5 in f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu_torch import energies
from opt_tpu_torch.ops import warp_cuda
from tests.test_solver_dense import warp_inputs
from tests.test_torch_evaluate import assert_close, poisson_inputs
from tests.test_torch_plan_fns import pack

torch.set_num_threads(1)

NAMES = ("Offset", "Angle")
# a 64x48 LM solve with the residual reset inside each PCG solve
LM_CASE = dict(W=64, H=48, n=4, l=15, period=10, seed=4)


def make_plans(energy, kind, W, H, n, l, params=(), **state_kwargs):
    """(opt_tpu plan, opt_tpu_torch plan) of one problem with the same
    state options and solver parameters."""
    js = opt_tpu.NewState(**state_kwargs)
    jplan = js.problem_plan(js.problem_define(
        getattr(jax_energies, energy), kind), [W, H])
    ts = opt_tpu_torch.NewState(device="cpu", **state_kwargs)
    tplan = ts.problem_plan(ts.problem_define(getattr(energies, energy),
                                              kind), [W, H])
    for plan in (jplan, tplan):
        plan.set_solver_parameter("nIterations", n)
        plan.set_solver_parameter("lIterations", l)
        for name, value in params:
            plan.set_solver_parameter(name, value)
    return jplan, tplan


def jax_solve(jplan, inputs):
    cost = jplan.solve(inputs, engine="xla")
    return cost, {k: np.asarray(v) for k, v in jplan.unknowns().items()}


def assert_solve_matches(tplan, inputs, engine, want, rtol=1e-4):
    cost, x_want = want
    got = tplan.solve(inputs, engine=engine)
    assert tplan.engine == engine
    assert np.isfinite(got)
    assert got == pytest.approx(cost, rel=rtol)
    for n, arr in tplan.unknowns().items():
        np.testing.assert_allclose(arr, x_want[n], rtol=10 * rtol,
                                   atol=rtol, err_msg=n)
    return got


@pytest.fixture(scope="module")
def lm_64x48():
    c = LM_CASE
    inputs = warp_inputs(c["W"], c["H"], seed=c["seed"])
    jplan, _ = make_plans("image_warping", "LMGPU", c["W"], c["H"], c["n"],
                          c["l"], (("residual_reset_period", c["period"]),))
    return inputs, jax_solve(jplan, inputs)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_lm_solve_matches_xla(lm_64x48, engine):
    """LM 64x48, 4 outer x 15 PCG with the exact residual reset at PCG
    iteration 10, on both engines."""
    inputs, want = lm_64x48
    c = LM_CASE
    _, tplan = make_plans("image_warping", "LMGPU", c["W"], c["H"], c["n"],
                          c["l"], (("residual_reset_period", c["period"]),))
    assert tplan.config.uses_lambda
    assert_solve_matches(tplan, inputs, engine, want)
    assert tplan._state["ssq"].shape == tplan._state["x"].shape


# the early exits: a q_tolerance that the zeta test passes within a few PCG
# iterations, and a function_tolerance that the first accepted step meets
EXITS = {
    "zeta": (("q_tolerance", 0.05),),
    "ftol": (("function_tolerance", 0.5),),
}


@pytest.fixture(scope="module", params=sorted(EXITS))
def lm_exit(request):
    """The JAX while loops' result where an exit fires, and the result
    without the exit, so the test can show that it fired."""
    params = EXITS[request.param]
    inputs = warp_inputs(24, 16, seed=8)
    jplan, _ = make_plans("image_warping", "LMGPU", 24, 16, 4, 20, params)
    want = jax_solve(jplan, inputs)
    stop = bool(jplan._state["done"]), int(jplan._state["n_iter"])
    jplain, _ = make_plans("image_warping", "LMGPU", 24, 16, 4, 20)
    return request.param, params, inputs, want, stop, jax_solve(jplain,
                                                                inputs)


@pytest.mark.parametrize("engine", ["cuda", "stream"])
def test_lm_predicated_exits_match_while_loops(lm_exit, engine):
    """The port runs a fixed trip count and freezes delta after the zeta
    exit, and the whole state after `done`; the JAX package stops its
    while loops.  Both give the same final cost and unknowns, and the
    same `done` and n_iter (the ftol exit stops the JAX solve after 3 of
    its 4 outer steps and publishes the pre-step cost)."""
    name, params, inputs, want, jax_stop, unexited = lm_exit
    assert want[0] != unexited[0]  # the exit changed the result
    assert jax_stop == ((True, 3) if name == "ftol" else (False, 4))
    _, tplan = make_plans("image_warping", "LMGPU", 24, 16, 4, 20, params)
    assert_solve_matches(tplan, inputs, engine, want)
    assert (bool(tplan._state["done"]),
            int(tplan._state["n_iter"])) == jax_stop


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_pipelined_pcg_matches_jax(engine):
    """GN with pcg_variant="pipelined": the port's pcg_pipelined against
    the JAX package's on its XLA engine."""
    inputs = warp_inputs(32, 24, seed=11)
    jplan, tplan = make_plans("image_warping", "gaussNewtonGPU", 32, 24, 2,
                              20, pcg_variant="pipelined")
    assert tplan.config.pcg_variant == "pipelined"
    assert_solve_matches(tplan, inputs, engine, jax_solve(jplan, inputs))


@pytest.fixture(scope="module")
def linearized():
    """JAX's r0, J delta, masks and model cost at a point with an excluded
    pixel, and the port's operators bound to the same inputs."""
    W, H = 20, 14
    inputs = warp_inputs(W, H, seed=12)
    jplan, tplan = make_plans("image_warping", "LMGPU", W, H, 1, 1)
    f = jplan.funcs
    jx, jdata = jplan.bind(inputs)
    rng = np.random.RandomState(13)
    masks = f.unknown_masks(jx, jdata)
    delta = f.mask_unknown_tree(
        {n: jnp.asarray(rng.randn(*s).astype(np.float32))
         for n, s in f.unknown_shapes.items()}, masks)
    ctc = {n: jnp.asarray(rng.rand(*s).astype(np.float32))
           for n, s in f.unknown_shapes.items()}
    r0, jvp, jt = f.linearize(jx, jdata)
    apply = f.mask_unknown_tree(
        {n: v + ctc[n] * delta[n] for n, v in jt(jvp(delta)).items()}, masks)
    ref = {
        "model_cost": float(f.model_cost(r0, jvp, delta, jx, jdata)),
        "delta": pack(delta, NAMES),
        "ctc": pack(ctc, NAMES),
        "apply": pack(apply, NAMES),
    }
    tx, tdata = tplan.bind(inputs)
    return tplan, tx, tdata, ref


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_model_cost_matches_jax(linearized, engine):
    tplan, x, data, ref = linearized
    op = tplan._operator(engine, data)
    op.outer(x)
    got = op.model_cost(torch.as_tensor(ref["delta"]))
    assert float(got) == pytest.approx(ref["model_cost"], rel=1e-5)


def test_warp_closed_forms_lm_terms_match_jax(linearized):
    """K1's ctc term and K3's model-cost mode, in their plain closed
    forms, against JAX's linearize: mask(J^T J d + ctc d) and
    0.5 sum mask(r0 + J d)^2."""
    tplan, x, data, ref = linearized
    op = warp_cuda.WarpOperator(data)
    d = torch.as_tensor(ref["delta"])
    ap, dap = warp_cuda.warp_jtj_apply_plain(
        x, d, op.ur, op.cons, op.mask_img, op.params,
        torch.as_tensor(ref["ctc"]))
    assert_close(ap.numpy(), ref["apply"], 1e-5, "J^T J d + ctc d")
    assert float(dap) == pytest.approx(float(ref["delta"] @ ref["apply"]),
                                       rel=1e-5)
    jtf, diag, cost = warp_cuda.warp_linearize_plain(
        x, op.ur, op.cons, op.mask_img, op.params, delta=d)
    assert jtf is None and diag is None
    assert float(cost) == pytest.approx(ref["model_cost"], rel=1e-5)


# The fault probe with LM: the solver's options and the engines' masking,
# each against the JAX package at 24x16, LM 3x12 (rtol 1e-4).
PROBES = {
    "ceres": ("image_warping", "cuda", {}),
    "modified_ceres": ("image_warping", "cuda",
                       {"guarded_invert_type": "MODIFIED_CERES"}),
    "epsilon_add": ("image_warping", "cuda",
                    {"guarded_invert_type": "EPSILON_ADD"}),
    "scaling_every_iteration": ("image_warping", "cuda",
                                {"jacobi_scaling": "EVERY_ITERATION"}),
    "scaling_none": ("image_warping", "cuda", {"jacobi_scaling": "NONE"}),
    "f64": ("image_warping", "torch", {"double_precision": True}),
    "masked_stream": ("image_warping", "stream", {}),
    "poisson_exclude": ("poisson_image_editing", "torch", {}),
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_lm_fault_probe(probe):
    energy, engine, kwargs = PROBES[probe]
    W, H = 24, 16
    if energy == "image_warping":
        inputs = warp_inputs(W, H, seed=21)
        inputs["Mask"][3:5, 9] = 1.0  # three excluded pixels in all
    else:
        inputs = poisson_inputs(W, H)
    jplan, tplan = make_plans(energy, "LMGPU", W, H, 3, 12, **kwargs)
    assert_solve_matches(tplan, inputs, engine, jax_solve(jplan, inputs))


def test_lm_init_step_current_cost_match_jax():
    """The host-stepped LM lifecycle: init, step until it returns 0, then
    final_cost and current_cost, step by step against the JAX package."""
    inputs = warp_inputs(20, 12, seed=22)
    jplan, tplan = make_plans("image_warping", "LMGPU", 20, 12, 3, 10)
    jplan.init(inputs)
    tplan.init(inputs, engine="cuda")
    assert tplan.current_cost() == pytest.approx(jplan.current_cost(),
                                                 rel=1e-5)
    while True:
        more = jplan.step()
        assert tplan.step() == more
        if not more:
            break
        assert tplan.final_cost() == pytest.approx(jplan.final_cost(),
                                                   rel=1e-4)
    assert tplan.current_cost() == pytest.approx(jplan.current_cost(),
                                                 rel=1e-4)


def test_lm_jax_checkpoint_resumes_in_port(tmp_path):
    """An LM checkpoint carries the saved diagonal ssq per unknown; the
    port reads it, resumes, and writes it back in the same format."""
    inputs = warp_inputs(16, 12, seed=23)
    jplan, tplan = make_plans("image_warping", "LMGPU", 16, 12, 1, 10)
    jplan.init(inputs)
    while jplan.step():
        pass
    path = tmp_path / "lm.npz"
    jplan.save_state(path)
    assert {"ssq.Offset", "ssq.Angle"} <= set(np.load(path).files)
    jplan.set_solver_parameter("nIterations", 3)
    while jplan.step():
        pass

    tplan.set_solver_parameter("nIterations", 3)
    tplan.init(inputs, engine="cuda")
    tplan.load_state(path)
    assert tplan._state["ssq"].shape == tplan._state["x"].shape
    while tplan.step():
        pass
    assert tplan.final_cost() == pytest.approx(jplan.final_cost(), rel=1e-4)
    out = tmp_path / "port.npz"
    tplan.save_state(out)
    saved = np.load(out)
    assert saved["ssq.Offset"].shape == (12, 16, 2)
    assert saved["ssq.Angle"].shape == (12, 16, 1)
