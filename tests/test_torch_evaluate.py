"""Residual evaluation: opt_tpu_torch.compile.evaluate / residual_fields
against opt_tpu's on the same numpy inputs (16x12, f32).

Tolerance: rtol 1e-5 of each field's largest entry -- the same f32 ops in
another order (XLA fuses and re-associates; torch runs eagerly)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.compile import evaluate as jev
from opt_tpu_torch import energies
from opt_tpu_torch.compile import evaluate as tev
from tests.test_poisson_pallas import make_inputs as poisson_inputs
from tests.test_solver_dense import warp_inputs

torch.set_num_threads(1)

RTOL = 1e-5


def assert_close(got, want, rtol=RTOL, err_msg=""):
    """Elementwise rtol, with an absolute floor of rtol x the largest
    |want| so entries near zero are held to the array's own scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=err_msg)


def plans(energy_name, dims):
    js = opt_tpu.NewState()
    jplan = js.problem_plan(js.problem_define(
        getattr(jax_energies, energy_name), "gaussNewtonGPU"), dims)
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(
        getattr(energies, energy_name), "gaussNewtonGPU"), dims)
    return jplan, tplan


CASES = {
    "image_warping": lambda W, H: warp_inputs(W, H, seed=5),
    "poisson_image_editing": poisson_inputs,
}


@pytest.mark.parametrize("energy", sorted(CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_residual_fields_match_jax(energy, masked):
    W, H = 16, 12
    inputs = CASES[energy](W, H)
    jplan, tplan = plans(energy, [W, H])
    jx, jdata = jplan.bind(inputs)
    tx, tdata = tplan.bind(inputs)
    want = jplan.funcs.residual_fields(jx, jdata, masked=masked)
    got = tplan.funcs.residual_fields(tplan.layout.views(tx), tdata,
                                      masked=masked)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("offsets", [(1, 0), (-1, 0), (0, 2), (-2, -1),
                                     (0, 0)])
def test_shift_read_and_scatter_match_jax(offsets):
    a = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    np.testing.assert_array_equal(
        tev.shift_read(torch.as_tensor(a), offsets).numpy(),
        np.asarray(jev.shift_read(jnp.asarray(a), offsets)))
    np.testing.assert_array_equal(
        tev.scatter_shift(torch.as_tensor(a), offsets).numpy(),
        np.asarray(jev.scatter_shift(jnp.asarray(a), offsets)))


@pytest.mark.parametrize("mins,maxs", [((1, 0), (1, 0)), ((-1, 0), (-1, 0)),
                                       ((0, -1), (0, 1)), ((), ())])
def test_bounds_mask_matches_jax(mins, maxs):
    shape = (6, 9)
    np.testing.assert_array_equal(
        tev.bounds_mask(shape, mins, maxs, torch.device("cpu")).numpy(),
        np.asarray(jev.bounds_mask(shape, mins, maxs)))


def _energy_with(op):
    def energy(O):
        W, H = O.Dim("W", 0), O.Dim("H", 1)
        X = O.Unknown("X", O.opt_float, (W, H), 0)
        O.Energy(op(O, X))
    return energy


@pytest.mark.parametrize("op,item", [
    (lambda O, X: O.sqrt(X(0, 0)), "item 2"),
    (lambda O, X: X(0, 0) / (X(1, 0) + 1.0), "item 2"),
    (lambda O, X: O.log(X(0, 0)), "item 2"),
])
def test_unported_ops_raise_not_implemented(op, item):
    ts = opt_tpu_torch.NewState(device="cpu")
    plan = ts.problem_plan(ts.problem_define(_energy_with(op),
                                             "gaussNewtonGPU"), [4, 3])
    x, data = plan.bind({"X": np.ones((3, 4), np.float32)})
    with pytest.raises(NotImplementedError, match=item):
        plan.funcs.residual_fields(plan.layout.views(x), data, masked=False)


@pytest.mark.parametrize("name", ["cotangent_mesh_smoothing",
                                  "optical_flow",
                                  "intrinsic_image_decomposition"])
def test_unported_energies_raise_not_implemented(name):
    ts = opt_tpu_torch.NewState(device="cpu")
    dims = [8, 6] if name != "cotangent_mesh_smoothing" else [8, 12]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan = ts.problem_plan(ts.problem_define(
            getattr(energies, name), "gaussNewtonGPU"), dims)
        plan.funcs.cost(*_zeros(plan))


def _zeros(plan):
    inputs = {n: np.zeros(im.ispace.shape + (im.channels,), np.float32)
              for n, im in plan.spec.images.items()}
    inputs.update({n: 1.0 for n in plan.spec.params})
    for gname, g in plan.spec.graphs.items():
        for sname in g.slots:
            inputs[f"{gname}.{sname}"] = np.zeros(plan.dims[1], np.int32)
    x, data = plan.bind(inputs)
    return plan.layout.views(x), data
