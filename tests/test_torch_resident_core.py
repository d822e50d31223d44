"""The two-sync resident PCG core (csrc/resident_pcg.cuh) on the CPU: K13's
plain path (stream_cuda.resident_pcg_plain, solver/hat_pcg.py's classic
loop in the kernel's phase order) against a textbook classic CG written
here, bit for bit; the "cuda" engine's Gauss-Newton PCG on K13 (its plain path) against
the JAX package's Plan.solve; which plans give WarpOperator K13 as its
pcg_backend; which grids take K13's on-chip form on an H100
(stream_cuda.onchip_tiles); and K12's plain loop against the JAX kernel
poisson_cg_vmem in interpret mode at the card checks' ragged grid and
iteration count.

Tolerances: the phase order is the textbook loop's arithmetic in another
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
from opt_tpu_torch.solver.core import safe_div
from tests.test_torch_evaluate import assert_close
from tests.test_torch_lm import assert_solve_matches, jax_solve, make_plans
from tests.test_torch_poisson import _jax_cg

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = chip_smoke.SMALL_POISSON  # 37 x 23, the card checks' ragged grid
W, H = 48, 32
N_OUTER, N_LINEAR = 3, 40


def textbook_cg(hat, sq, b_hat, n_iters):
    """Classic CG on A_hat d = b_hat from r = p = b_hat, p formed at the
    end of each iteration, alpha = an / <p, A_hat p> where that is not 0
    and beta = bn / an where an is not 0, no early exit."""
    delta = torch.zeros_like(b_hat)
    r = p = b_hat
    an = torch.dot(r, r)
    for _ in range(n_iters):
        ap = hat.apply_plain(sq, p)
        alpha = safe_div(an, torch.dot(p, ap))
        delta = delta + alpha * p
        r = r - alpha * ap
        bn = torch.dot(r, r)
        p = r + safe_div(bn, an) * p
        an = bn
    return delta


def random_poisson_operands():
    """A poisson hat on a 12 x 10 x 4 grid with a random fifth of sq 0."""
    rng = np.random.RandomState(5)
    Hs, Ws, C = 12, 10, 4
    sq = torch.as_tensor((rng.rand(Hs * Ws * C) > 0.2).astype(np.float32))
    b_hat = sq * torch.as_tensor(rng.randn(Hs * Ws * C).astype(np.float32))
    return stream_cuda.PoissonHat(Hs, Ws, C), sq, b_hat


@pytest.mark.parametrize("energy,n_iters", [
    *((e, n) for e in ("warp", "poisson")
      for n in (1, 2, chip_smoke.RESIDENT_CHECK_ITERS)),
    ("random_poisson", 20)])
def test_phase_order_matches_the_classic_loop_bit_for_bit(energy, n_iters):
    """K13's plain path, which is the shared classic loop with p formed
    where the apply reads it, and the wrapper's CPU path against the
    textbook loop.  With excluded pixels (sq = 0: the warp grid's excluded
    pixel, poisson's frame and one inner pixel, or a random fifth)."""
    if energy == "random_poisson":
        hat, sq, b_hat = random_poisson_operands()
    else:
        hat, sq, b_hat = chip_smoke.resident_operands(torch, energy, *SMALL,
                                                      CPU)
    got = stream_cuda.resident_pcg_plain(hat, sq, b_hat, n_iters)
    assert torch.equal(got, textbook_cg(hat, sq, b_hat, n_iters))
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


# an H100's SMs and the shared memory a block may take (opted in)
H100 = (132, 232_448)


@pytest.mark.parametrize("H,W,tiles", [
    (512, 512, 128),   # the main path: 16 x 8 tiles of 32 x 64
    (23, 37, 1),       # the card checks' ragged grid, one ragged tile
    (576, 448, 126),   # 18 x 7
    (608, 448, 0),     # 19 x 7 = 133 tiles, one past the SMs
    (1024, 1024, 0),   # 512 tiles
    (2048, 2048, 0),   # the cuda engine's explicit GN there
])
def test_onchip_form_by_shape_on_an_h100(H, W, tiles):
    """K13's on-chip form runs where the grid's tiles number no more than
    the SMs; past that the grid takes the L2 form (0 tiles)."""
    assert stream_cuda.onchip_tiles(H, W, *H100) == tiles


def test_onchip_form_needs_a_tiles_state_in_a_block():
    need = stream_cuda.ONCHIP_SMEM_BYTES
    assert need == 16 * (3 * 34 * 66 + 5) < H100[1]
    assert stream_cuda.onchip_tiles(512, 512, 132, need) == 128
    assert stream_cuda.onchip_tiles(512, 512, 132, need - 1) == 0
    assert stream_cuda.onchip_tiles(512, 512, 128, need) == 128
    assert stream_cuda.onchip_tiles(512, 512, 127, need) == 0
    # the barrier reads ONCHIP_MAX_TILES blocks' partials at most
    assert stream_cuda.onchip_tiles(512, 1024, 1000, need) == 256
    assert stream_cuda.onchip_tiles(544, 1024, 1000, need) == 0


@pytest.mark.parametrize("H,W,onchip", [(512, 512, True), (608, 448, False),
                                        (2048, 2048, False)])
def test_warp_hat_takes_the_form_of_its_shape(H, W, onchip):
    """WarpHat.form gives the on-chip form, on the same operands, where the
    rule holds, and the L2 form (itself) elsewhere; poisson keeps its
    one form."""
    mask = torch.zeros(H, W, 1)
    hat = stream_cuda.WarpHat(torch.zeros(3 * H * W), torch.zeros(H, W, 2),
                              torch.zeros(H, W, 2), mask, torch.ones(2))
    form = hat.form(H100)
    assert isinstance(form, stream_cuda.OnChipWarpHat) == onchip
    assert (form is hat) != onchip
    assert form.operands == hat.operands and (form.H, form.W) == (H, W)
    assert form.form(H100) is form
    poisson = stream_cuda.PoissonHat(H, W, 4)
    assert poisson.form(H100) is poisson


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
