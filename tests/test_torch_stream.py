"""The port's "stream" engine (ops/stream_cuda.py) on the CPU, through the
plain versions of its kernels, against the JAX package's StreamSolverHBM
run in interpret mode as tests/test_stream_solver.py runs it: GN on the
pipelined backend and LM on the classic one, at 128x24 with tile 8
(about 6 s each on the CPU).  Whole solves are held at rtol 1e-4, the
bound for the scaled-space PCG's reordered float ops
(opt_tpu/ops/stream_solver.py:25-28); the first A_hat apply at rtol 1e-5.

Also: engine="auto" against the JAX package's route, and a kernel that
fails on launch raising through Plan.solve with no fallback."""

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.ops import stream_solver as ssv
from opt_tpu_torch import energies
from opt_tpu_torch.ops import build, stream_cuda
from tests.test_stream_solver import _warp_inputs
from tests.test_torch_evaluate import assert_close
from tests.test_torch_lm import make_plans
from tests.test_torch_plan_fns import pack

torch.set_num_threads(1)

W, H = 128, 24
NAMES = ("Offset", "Angle")
KINDS = {"pipelined": "gaussNewtonGPU", "classic": "LMGPU"}


@pytest.fixture(scope="module", params=sorted(KINDS))
def hbm(request):
    """StreamSolverHBM's solve in interpret mode, 2 outer x 12 PCG, with
    one excluded pixel and the LM residual reset at PCG iteration 5."""
    variant = request.param
    inputs = _warp_inputs(W, H)
    inputs["Mask"][7, 40] = 1.0
    params = (("residual_reset_period", 5),)
    jplan, _ = make_plans("image_warping", KINDS[variant], W, H, 2, 12,
                          params)
    solver = ssv.StreamSolverHBM(jplan, tile=8)
    assert solver.variant == variant
    out = solver.solve(inputs)
    return variant, params, inputs, out


def test_stream_engine_matches_stream_solver_hbm(hbm):
    variant, params, inputs, out = hbm
    _, tplan = make_plans("image_warping", KINDS[variant], W, H, 2, 12,
                          params)
    tplan.stream_variant = variant
    cost = tplan.solve(inputs, engine="stream")
    assert (tplan.engine, tplan.variant) == ("stream", variant)
    assert cost == pytest.approx(out["final_cost"], rel=1e-4)
    for n, arr in tplan.unknowns().items():
        np.testing.assert_allclose(arr, np.asarray(out["x"][n]), rtol=1e-3,
                                   atol=1e-4, err_msg=n)
    # the excluded pixel never moves
    for n, arr in tplan.unknowns().items():
        np.testing.assert_array_equal(arr[7, 40], inputs[n][7, 40])


@pytest.mark.parametrize("variant", ["classic", "pipelined"])
def test_stream_gn_variants_agree_with_xla(variant):
    """GN on either backend (the classic kernel runs GN too) against the
    JAX package's XLA engine."""
    inputs = _warp_inputs(64, 16)
    jplan, tplan = make_plans("image_warping", "gaussNewtonGPU", 64, 16, 2,
                              15)
    want = jplan.solve(inputs, engine="xla")
    tplan.stream_variant = variant
    assert tplan.solve(inputs, engine="stream") == pytest.approx(want,
                                                                 rel=1e-4)
    assert tplan.variant == variant


def test_first_hat_apply_matches_jax():
    """The plain A_hat apply, sq . J^T J (sq . p) + scs . p, against the
    same product built from the JAX package's linearize, with sq and scs
    as the LM solver forms them (zero at the excluded pixel)."""
    inputs = _warp_inputs(32, 16)
    inputs["Mask"][5, 9] = 1.0
    inputs["Angle"] = (0.3 * np.random.RandomState(3).randn(16, 32, 1)
                       ).astype(np.float32)
    jplan, tplan = make_plans("image_warping", "LMGPU", 32, 16, 1, 1)
    f = jplan.funcs
    jx, jdata = jplan.bind(inputs)
    masks = f.unknown_masks(jx, jdata)
    rng = np.random.RandomState(14)
    rand = lambda: {n: jnp.asarray(rng.rand(*s).astype(np.float32))
                    for n, s in f.unknown_shapes.items()}
    sq = f.mask_unknown_tree(rand(), masks)
    ctc, p = rand(), rand()
    scs = {n: sq[n] * sq[n] * ctc[n] for n in sq}
    _, jvp, jt = f.linearize(jx, jdata)
    jtj = jt(jvp({n: sq[n] * p[n] for n in p}))
    want = pack({n: sq[n] * jtj[n] + scs[n] * p[n] for n in p}, NAMES)

    tx, tdata = tplan.bind(inputs)
    op = stream_cuda.StreamOperator(tdata, uses_lambda=True)
    t = lambda tree: torch.as_tensor(pack(tree, NAMES))
    got_p, ap, pap = stream_cuda.warp_hat_apply_plain(
        tx, op.ur, op.cons, op.mask_img, op.params, t(sq), t(scs), t(p))
    assert torch.equal(got_p, t(p))
    assert_close(ap.numpy(), want, 1e-5, "A_hat p")
    assert float(pap) == pytest.approx(float(pack(p, NAMES) @ want),
                                       rel=1e-5)


# the JAX route's engines, as the port names them for image_warping
ROUTE_MAP = {"vmem": "cuda", "stream_hbm": "stream", "xla": "cuda"}
# 2-D grids with W a multiple of 128 and H of 8: where the JAX package's
# TPU-only gates (lane alignment, the VMEM budget model between 512^2 and
# its LM limit of about 393,216 pixels) do not decide, since the port
# carries neither
ROUTE_SIZES = [(128, 64), (256, 256), (512, 512), (1024, 256), (1024, 512),
               (1024, 1024), (2048, 1024), (2048, 2040), (2048, 2048),
               (4096, 1024)]


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_auto_route_matches_jax(monkeypatch, kind):
    """engine="auto" on a CUDA plan against the JAX package's on the TPU
    (its TPU gate monkeypatched, as tests/test_stream_solver.py:287
    does).  The port's plans are made on the CPU and their device is then
    named cuda: the route reads only the plan."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    js = opt_tpu.NewState()
    ts = opt_tpu_torch.NewState(device="cpu")
    for dims in ROUTE_SIZES:
        jplan = js.problem_plan(js.problem_define(
            jax_energies.image_warping, kind), list(dims))
        tplan = ts.problem_plan(ts.problem_define(energies.image_warping,
                                                  kind), list(dims))
        tplan.device = torch.device("cuda")
        want = ROUTE_MAP[jplan._pick_engine("auto")]
        assert tplan._pick_engine("auto") == want, (kind, dims)
    # every other energy keeps the plain engine
    poisson = ts.problem_plan(ts.problem_define(
        energies.poisson_image_editing, kind), [2048, 2048])
    poisson.device = torch.device("cuda")
    assert poisson._pick_engine("auto") == "torch"


def test_variant_choice():
    assert stream_cuda.pick_variant() == "classic"
    assert stream_cuda.pick_variant("classic") == "classic"
    # the pipelined kernel (GN, and its LM mode): on request only
    assert stream_cuda.pick_variant("pipelined") == "pipelined"
    with pytest.raises(ValueError, match="variant"):
        stream_cuda.pick_variant("fancy")


@pytest.mark.parametrize("kind,its", [("gaussNewtonGPU", 12),
                                      ("gaussNewtonGPU", 101),
                                      ("LMGPU", 12)])
def test_plan_runs_the_classic_loop_unless_asked(kind, its):
    """A plan on the stream engine runs the classic loop for GN and LM at
    any PCG iteration count and holds the JAX package's XLA solve there;
    Plan.stream_variant still picks the pipelined loop."""
    inputs = _warp_inputs(24, 16)
    jplan, tplan = make_plans("image_warping", kind, 24, 16, 1, its)
    cost = tplan.solve(inputs, engine="stream")
    assert (tplan.engine, tplan.variant) == ("stream", "classic")
    assert cost == pytest.approx(jplan.solve(inputs, engine="xla"),
                                 rel=1e-4)
    tplan.stream_variant = "pipelined"
    tplan.solve(inputs, engine="stream")
    assert tplan.variant == "pipelined"


def test_pipelined_lm_matches_stream_solver_hbm():
    """LM on the pipelined backend (K5's LM mode: scs, the per-sweep q,
    the zeta exit and the residual replacement at PCG iteration 5) against
    StreamSolverHBM's pipelined kernel in LM mode, in interpret mode."""
    inputs = _warp_inputs(W, H)
    inputs["Mask"][7, 40] = 1.0
    params = (("residual_reset_period", 5),)
    jplan, tplan = make_plans("image_warping", "LMGPU", W, H, 2, 12, params)
    solver = ssv.StreamSolverHBM(jplan, tile=8, variant="pipelined")
    assert solver.variant == "pipelined"
    out = solver.solve(inputs)
    tplan.stream_variant = "pipelined"
    cost = tplan.solve(inputs, engine="stream")
    assert (tplan.engine, tplan.variant) == ("stream", "pipelined")
    assert cost == pytest.approx(out["final_cost"], rel=1e-4)
    for n, arr in tplan.unknowns().items():
        np.testing.assert_allclose(arr, np.asarray(out["x"][n]), rtol=1e-3,
                                   atol=1e-4, err_msg=n)


class _FailingLibrary:
    """A kernel library whose launches all report cudaErrorLaunchFailure."""

    LAUNCH_FAILURE = 719

    def __getattr__(self, name):
        if name.endswith("_blocks"):
            return lambda *args: 1
        if name == "opt_cuda_error_string":
            return lambda code: b"unspecified launch failure"
        return lambda *args: self.LAUNCH_FAILURE


def test_failed_launch_raises_with_no_fallback(monkeypatch):
    """A kernel whose launch fails raises out of Plan.solve: no engine
    catches it and carries on with another."""
    lib = _FailingLibrary()
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "all_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(build, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream", lambda: ctypes.c_void_p(0))
    inputs = _warp_inputs(32, 8)
    for kind, engine in (("gaussNewtonGPU", "stream"), ("LMGPU", "cuda")):
        _, tplan = make_plans("image_warping", kind, 32, 8, 1, 2)
        with pytest.raises(RuntimeError, match="CUDA error 719"):
            tplan.solve(inputs, engine=engine)
        assert tplan.engine == engine
