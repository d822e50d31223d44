"""The port's "stream3d" engine (ops/stream3d_cuda.py) on the CPU, through
the plain versions of its kernels, against the JAX module that holds the
TPU kernels, StreamSolver3D, run in interpret mode as
tests/test_stream3d.py runs it: GN and LM, each on the pipelined and the
classic backend, at 16x8x6, 2 outer x 10 PCG, with the LM residual reset
at PCG iteration 5 (about 15 s per JAX solve on the CPU).  Whole solves
are held at rtol 1e-4 on the final cost, the bound for re-associated inner
loops (opt_tpu/ops/stream_solver.py:25-28), and at rtol 1e-3, atol 1e-4
on the unknowns.

Also: engine="auto" against the JAX package's route, the port's own
variant pick (classic, where the JAX package picks pipelined) and its
solves against the pipelined loop's, and a kernel that fails on launch
raising through Plan.solve with no fallback."""

import ctypes

import numpy as np
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.ops import stream3d as s3d
from opt_tpu_torch import energies
from opt_tpu_torch.ops import build, stream3d_cuda
from tests.test_torch_stream import _FailingLibrary

torch.set_num_threads(1)

W, H, D = 16, 8, 6
CASES = [("gaussNewtonGPU", "pipelined"), ("gaussNewtonGPU", "classic"),
         ("LMGPU", "pipelined"), ("LMGPU", "classic")]
PARAMS = (("nIterations", 2), ("lIterations", 10),
          ("residual_reset_period", 5))


def vol_inputs(W, H, D, seed=0):
    """A regular grid pinned on its H = 0 face and pulled on its H = H - 1
    face (the rest unconstrained, -inf), with angles ~0.1 rad."""
    rng = np.random.RandomState(seed)
    dd, hh, ww = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                             indexing="ij")
    grid = np.stack([dd, hh, ww], axis=-1).astype(np.float32)
    cons = np.full_like(grid, -np.inf)
    cons[:, 0] = grid[:, 0]
    cons[:, -1] = grid[:, -1] + np.array([1.5, -1.0, 0.5], np.float32)
    return {
        "Offset": grid + 0.01 * rng.randn(*grid.shape).astype(np.float32),
        "UrShape": grid.copy(),
        "Angle": (0.1 * rng.randn(*grid.shape)).astype(np.float32),
        "Constraints": cons,
        "w_fitSqrt": np.sqrt(1.0),
        "w_regSqrt": np.sqrt(0.5),
    }


def make_plans(kind, dims, params=PARAMS):
    js = opt_tpu.NewState()
    jplan = js.problem_plan(js.problem_define(
        jax_energies.volumetric_mesh_deformation, kind), list(dims))
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(
        energies.volumetric_mesh_deformation, kind), list(dims))
    for plan in (jplan, tplan):
        for name, value in params:
            plan.set_solver_parameter(name, value)
    return jplan, tplan


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-{c[1]}")
def solved(request):
    """StreamSolver3D's solve in interpret mode."""
    kind, variant = request.param
    inputs = vol_inputs(W, H, D)
    jplan, _ = make_plans(kind, (W, H, D))
    solver = s3d.StreamSolver3D(jplan, variant=variant)
    assert solver.variant == variant
    out = solver.solve(dict(inputs), interpret=True)
    return kind, variant, inputs, out


def test_stream3d_engine_matches_stream_solver3d(solved):
    kind, variant, inputs, out = solved
    _, tplan = make_plans(kind, (W, H, D))
    tplan.stream_variant = variant
    cost = tplan.solve(inputs, engine="stream3d")
    assert (tplan.engine, tplan.variant) == ("stream3d", variant)
    assert np.isfinite(cost)
    assert cost == pytest.approx(out["final_cost"], rel=1e-4)
    for n, arr in tplan.unknowns().items():
        np.testing.assert_allclose(arr, np.asarray(out["x"][n]), rtol=1e-3,
                                   atol=1e-4, err_msg=n)


# (W, H, D): both sides of the 64^3-voxel threshold
ROUTE_DIMS = [(64, 64, 64), (63, 64, 64), (128, 128, 128), (32, 32, 32),
              (256, 64, 16)]


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_auto_route_matches_jax(kind):
    """engine="auto" on a CUDA plan against the JAX package's: "stream3d"
    from 64^3 voxels, else the plain engine (the JAX package's "xla").
    The port's plans are made on the CPU and then named cuda: the route
    reads only the plan."""
    route_map = {"stream3d": "stream3d", "xla": "torch"}
    for dims in ROUTE_DIMS:
        jplan, tplan = make_plans(kind, dims, ())
        tplan.device = torch.device("cuda")
        want = route_map[jplan._pick_engine("auto")]
        assert tplan._pick_engine("auto") == want, (kind, dims)
    assert (stream3d_cuda.AUTO_STREAM3D_MIN_VOXELS
            == s3d.AUTO_STREAM3D_MIN_VOXELS)


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_variant_pick_matches_jax(kind):
    """The port's own pick at 128^3: classic for GN and LM, where
    StreamSolver3D picks pipelined.  The JAX package's choice is a TPU
    finding (one barrier an iteration); on an H100 the classic loop's K6 +
    K2 iteration beats K7's pipelined sweep by 23-29% a solve and ends
    nearer the float64 reference (PERF.md).  Plan.stream_variant names
    pipelined; any other name raises."""
    jplan, tplan = make_plans(kind, (128, 128, 128), ())
    assert s3d._pick_variant3d(jplan) == "pipelined"
    data = bound_data()
    lm = tplan.config.uses_lambda
    assert stream3d_cuda.Stream3DOperator(data, lm).variant == "classic"
    op = stream3d_cuda.Stream3DOperator(data, lm, "pipelined")
    assert op.variant == "pipelined"
    with pytest.raises(ValueError, match="variant"):
        stream3d_cuda.Stream3DOperator(data, lm, "fancy")


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_stream3d_takes_classic_unless_asked(kind):
    """engine="stream3d" with no variant asked runs the classic loop and
    ends where the pipelined loop, asked for by name, ends: rtol 1e-4 on
    the final cost, rtol 1e-3, atol 1e-4 on the unknowns."""
    inputs = vol_inputs(W, H, D)
    _, tplan = make_plans(kind, (W, H, D))
    cost = tplan.solve(inputs, engine="stream3d")
    assert (tplan.engine, tplan.variant) == ("stream3d", "classic")
    _, pplan = make_plans(kind, (W, H, D))
    pplan.stream_variant = "pipelined"
    want = pplan.solve(inputs, engine="stream3d")
    assert pplan.variant == "pipelined"
    assert np.isfinite(cost)
    assert cost == pytest.approx(want, rel=1e-4)
    want_x = pplan.unknowns()
    for n, arr in tplan.unknowns().items():
        np.testing.assert_allclose(arr, want_x[n], rtol=1e-3, atol=1e-4,
                                   err_msg=n)


def bound_data():
    _, tplan = make_plans("gaussNewtonGPU", (4, 3, 2), ())
    return tplan.bind(vol_inputs(4, 3, 2))[1]


class _OneFailing(_FailingLibrary):
    """A kernel library whose one named volume kernel reports
    cudaErrorLaunchFailure and whose others launch nothing."""

    def __init__(self, failing):
        self.failing = failing

    def __getattr__(self, name):
        if name.startswith("opt_vol_") and not name.endswith("_blocks"):
            if name != self.failing:
                return lambda *args: 0
        return super().__getattr__(name)


@pytest.mark.parametrize("failing,kind", [
    ("opt_vol_linearize", "gaussNewtonGPU"),
    ("opt_vol_hat_apply", "gaussNewtonGPU"),
    ("opt_vol_pipelined_sweep", "LMGPU"),
])
def test_failed_launch_raises_with_no_fallback(monkeypatch, failing, kind):
    """K8, K6 or K7 (the pipelined loop's, asked for by name) failing on
    launch raises out of Plan.solve: no engine catches it and carries on
    with another."""
    lib = _OneFailing(failing)
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "all_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(build, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream", lambda: ctypes.c_void_p(0))
    _, tplan = make_plans(kind, (6, 5, 4))
    if failing == "opt_vol_pipelined_sweep":
        tplan.stream_variant = "pipelined"
    name = failing[len("opt_"):]
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 719"):
        tplan.solve(vol_inputs(6, 5, 4), engine="stream3d")
    assert tplan.engine == "stream3d"
