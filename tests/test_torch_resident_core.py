"""The two-sync resident PCG core (csrc/resident_pcg.cuh) on the CPU: its
phase order rendered in torch (stream_cuda.resident_pcg_phases_plain,
K13's plain path) against the classic loop (resident_pcg_plain), bit for
bit; the "cuda" engine's Gauss-Newton PCG on K13 (its plain path) against
the JAX package's Plan.solve; which plans give WarpOperator K13 as its
pcg_backend; and K12's plain loop against the JAX kernel
poisson_cg_vmem in interpret mode at the card checks' ragged grid and
iteration count.

Tolerances: the phase order is the classic loop's arithmetic in another
order, so bit for bit; the solve rtol 1e-4 for the cost and
tests/test_torch_lm.assert_solve_matches's for the unknowns, the bound
for a re-associated inner loop (docs/GUIDE.md:204-207: the hat-space loop
scales by sq where the JAX solve applies pre); K12 rtol 1e-5 of an
element's scale (the JAX kernel's arithmetic, sums in another order)."""

import numpy as np
import pytest
import torch

import chip_smoke
import opt_tpu_torch
from opt_tpu_torch import energies
from opt_tpu_torch.ops import poisson_cuda, stream_cuda, warp_cuda
from opt_tpu_torch.runtime.trace import LAUNCHES
from tests.test_torch_evaluate import assert_close
from tests.test_torch_lm import assert_solve_matches, jax_solve, make_plans
from tests.test_torch_poisson import _jax_cg

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = chip_smoke.SMALL_POISSON  # 37 x 23, the card checks' ragged grid
W, H = 48, 32
N_OUTER, N_LINEAR = 3, 40


@pytest.mark.parametrize("n_iters", [1, 2, chip_smoke.RESIDENT_CHECK_ITERS])
@pytest.mark.parametrize("energy", ["warp", "poisson"])
def test_phase_order_matches_the_classic_loop_bit_for_bit(energy, n_iters):
    """With excluded pixels (sq = 0: the warp grid's excluded pixel,
    poisson's frame and one inner pixel); the wrapper's CPU path is the
    phase order."""
    hat, sq, b_hat = chip_smoke.resident_operands(torch, energy, *SMALL, CPU)
    got = stream_cuda.resident_pcg_phases_plain(hat, sq, b_hat, n_iters)
    assert torch.equal(got, stream_cuda.resident_pcg_plain(hat, sq, b_hat,
                                                           n_iters))
    assert torch.equal(stream_cuda.resident_pcg(hat, sq, b_hat, n_iters),
                       got)
    assert got.any() and not got[sq == 0].any()


def test_poisson_hat_planes_round_trip():
    """K13's poisson mode runs on (C, H, W) planes: the wrapper's
    transposes in and out are each other's inverse."""
    hat = stream_cuda.PoissonHat(5, 3, 4)
    v = torch.arange(60, dtype=torch.float32)
    planes = hat.planes(v)
    assert planes.shape == (4, 5, 3) and planes.is_contiguous()
    assert planes[2, 4, 1] == v[(4 * 3 + 1) * 4 + 2]
    assert torch.equal(hat.flat(planes), v)


def _masked_warp_inputs():
    inputs = chip_smoke.warp_inputs(W, H, seed=11)
    inputs["Mask"][5:8, 20] = 1.0
    inputs["Mask"][H - 1, 0] = 1.0
    return inputs


@pytest.fixture(scope="module")
def jax_gn():
    inputs = _masked_warp_inputs()
    jplan, _ = make_plans("image_warping", "gaussNewtonGPU", W, H, N_OUTER,
                          N_LINEAR)
    return inputs, jax_solve(jplan, inputs)


def test_cuda_engine_gn_on_k13_matches_jax(jax_gn):
    """Plan.solve(engine="cuda") for image_warping GN, whose PCG is K13's
    (its plain path on CPU tensors), against the JAX package's solve;
    excluded pixels do not move."""
    inputs, want = jax_gn
    _, tplan = make_plans("image_warping", "gaussNewtonGPU", W, H, N_OUTER,
                          N_LINEAR)
    launches = LAUNCHES["K13.resident_pcg"]
    assert_solve_matches(tplan, inputs, "cuda", want)
    assert tplan._op.pcg_backend is not None
    assert LAUNCHES["K13.resident_pcg"] == launches  # plain on CPU
    excl = inputs["Mask"][..., 0] != 0
    for n, arr in tplan.unknowns().items():
        np.testing.assert_array_equal(arr[excl], inputs[n][excl], err_msg=n)


@pytest.mark.parametrize("kind,variant,resident", [
    ("gaussNewtonGPU", "classic", True),
    ("gaussNewtonGPU", "pipelined", False),
    ("LMGPU", "classic", False),
])
def test_cuda_engine_takes_k13_for_gn_classic_only(kind, variant, resident):
    """GN with the classic pcg_variant (the default) runs K13 as
    WarpOperator's pcg_backend; LM and pcg_variant="pipelined" keep K1 and
    K2 (pcg_backend None)."""
    st = opt_tpu_torch.NewState(device="cpu", pcg_variant=variant)
    plan = st.problem_plan(st.problem_define(energies.image_warping, kind),
                           [16, 12])
    plan.init(chip_smoke.warp_inputs(16, 12, seed=3), engine="cuda")
    assert plan.engine == "cuda"
    assert isinstance(plan._op, warp_cuda.WarpOperator)
    assert (plan._op.pcg_backend is not None) == resident
    assert warp_cuda.WarpOperator.pcg_backend is None


def test_poisson_cg_plain_matches_poisson_cg_vmem_at_the_card_checks():
    """K12's plain loop at 37x23 with an excluded frame and inner pixel,
    four channels, one all zero, after RESIDENT_CHECK_ITERS iterations."""
    Ws, Hs = SMALL
    n = chip_smoke.RESIDENT_CHECK_ITERS
    rng = np.random.RandomState(23)
    keep = np.zeros((Hs, Ws), np.float32)
    keep[3:-3, 4:-4] = 1.0
    keep[11, 17] = 0.0
    b = rng.randn(4, Hs, Ws).astype(np.float32)
    b[2] = 0.0
    got = poisson_cuda.poisson_cg(torch.as_tensor(b), torch.as_tensor(keep),
                                  n).numpy()
    assert_close(got, _jax_cg(b, keep, n), 1e-5)
    assert not got[2].any() and not got[:, keep == 0].any()
