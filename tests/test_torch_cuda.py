"""The port's CUDA kernels on the card: each against its plain version,
and the engines' whole solves against each other.  Marked `cuda`; they
skip where torch sees no CUDA device.  They import no JAX, so they also
run on a machine with the card and no JAX, without tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from opt_tpu_torch.ops import pcg_update as k2
from opt_tpu_torch.ops import stream_cuda, warp_cuda

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# kernel vs plain: f32 sums in another order and FMA contraction
RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(W, H, dev):
    inp, vecs = chip_smoke.kernel_inputs(W, H, seed=4)
    x = torch.cat([torch.as_tensor(inp[n]).reshape(-1)
                   for n in ("Offset", "Angle")]).to(dev)
    ur, cons, mask = (torch.as_tensor(inp[n], device=dev)
                      for n in ("UrShape", "Constraints", "Mask"))
    params = torch.tensor([inp["w_fitSqrt"], inp["w_regSqrt"]],
                          dtype=torch.float32, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in vecs.items()}
    keep = warp_cuda._flat_keep(mask.view(H, W) == 0)
    t["p"] = torch.where(keep, t["p"], torch.zeros((), device=dev))
    return x, ur, cons, mask, params, t


def _close(got, want):
    for g, w in zip(got, want):
        if g is None:
            assert w is None
            continue
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= RTOL * scale


# odd sizes leave ragged 32x8 blocks at the right and bottom edges
SIZES = [(37, 23), (512, 512)]


@pytest.mark.parametrize("W,H", SIZES)
def test_jtj_apply_kernel_matches_plain(dev, W, H):
    x, ur, cons, mask, params, t = _operands(W, H, dev)
    n = warp_cuda.warp_jtj_apply.launches
    got = warp_cuda.warp_jtj_apply(x, t["p"], ur, cons, mask, params)
    assert warp_cuda.warp_jtj_apply.launches == n + 1
    _close(got, warp_cuda.warp_jtj_apply_plain(x, t["p"], ur, cons, mask,
                                               params))


@pytest.mark.parametrize("cost_only", [False, True])
@pytest.mark.parametrize("W,H", SIZES)
def test_linearize_kernel_matches_plain(dev, W, H, cost_only):
    x, ur, cons, mask, params, _ = _operands(W, H, dev)
    got = warp_cuda.warp_linearize(x, ur, cons, mask, params, cost_only)
    _close(got, warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                               cost_only))


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", SIZES)
def test_pcg_update_kernel_matches_plain(dev, W, H, lm):
    _, _, _, _, _, t = _operands(W, H, dev)
    alpha = torch.tensor(-0.8, dtype=torch.float32, device=dev)
    args = (alpha, t["p"], t["ap"], t["delta"], t["r"], t["pre"],
            t["b"] if lm else None)
    _close(k2.pcg_update(*args), k2.pcg_update_plain(*args))


# the slice-2 kernels and modes: ragged blocks, and the 2048^2 grid
HAT_SIZES = [(37, 23), (2048, 2048)]


@pytest.mark.parametrize("W,H", HAT_SIZES)
def test_lm_modes_of_k1_k3_match_plain(dev, W, H):
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed=5)
    _close(warp_cuda.warp_jtj_apply(x, t["p"], ur, cons, mask, params,
                                    t["ctc"]),
           warp_cuda.warp_jtj_apply_plain(x, t["p"], ur, cons, mask, params,
                                          t["ctc"]))
    _close(warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                    delta=t["delta"]),
           warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                          delta=t["delta"]))


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", HAT_SIZES)
def test_pcg_update_hat_mode_matches_plain(dev, W, H, lm):
    _, _, _, _, _, t = chip_smoke.kernel_operands(torch, W, H, dev, seed=5)
    alpha = torch.tensor(0.3, dtype=torch.float32, device=dev)
    args = (alpha, t["p"], t["ap"], t["delta"], t["r"], None,
            t["b"] if lm else None)
    got = k2.pcg_update(*args)
    assert got[2] is got[1]  # z' is r' itself in hat mode
    _close(got, k2.pcg_update_plain(*args))


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", HAT_SIZES)
def test_hat_apply_kernel_matches_plain(dev, W, H, lm):
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed=5)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    scs = t["scs"] if lm else None
    args = (x, ur, cons, mask, params, t["sq"], scs, t["r"])
    n = stream_cuda.warp_hat_apply.launches
    _close(stream_cuda.warp_hat_apply(*args, t["p"], beta),
           stream_cuda.warp_hat_apply_plain(*args, t["p"], beta))
    _close(stream_cuda.warp_hat_apply(*args),
           stream_cuda.warp_hat_apply_plain(*args))
    assert stream_cuda.warp_hat_apply.launches == n + 2


@pytest.mark.parametrize("W,H", HAT_SIZES)
def test_pipelined_sweep_kernel_matches_plain(dev, W, H):
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed=5)
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    kern, plain = chip_smoke.sweep_case(torch, stream_cuda, x, ur, cons,
                                        mask, params, t, None, alpha, beta)
    _close(kern(), plain())
    w = t["r"].clone()
    with pytest.raises(ValueError, match="two"):
        stream_cuda.warp_pipelined_sweep(
            x, ur, cons, mask, params, t["sq"], None, w, w, t["ap"].clone(),
            t["b"].clone(), t["p"].clone(), t["delta"].clone(),
            t["r"].clone(), alpha, beta)


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_stream_engine_agrees_with_cuda_engine(dev, kind):
    """Both backends of the stream engine against the whole-grid engine on
    the card, and repeated stream solves bit for bit."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    st = opt_tpu_torch.NewState(device="cuda")
    plan = st.problem_plan(st.problem_define(energies.image_warping, kind),
                           [96, 64])
    plan.set_solver_parameter("nIterations", 3)
    plan.set_solver_parameter("lIterations", 40)
    inputs = chip_smoke.warp_inputs(96, 64, seed=6)
    inputs["Mask"][20, 30] = 1.0
    cost = plan.solve(inputs, engine="stream")
    assert plan.variant == ("classic" if kind == "LMGPU" else "pipelined")
    want = plan.solve(inputs, engine="cuda")
    assert np.isfinite(cost)
    assert cost == pytest.approx(want, rel=1e-4)
    assert plan.solve(inputs, engine="stream") == cost


def test_kernels_reject_bad_operands(dev):
    x, ur, cons, mask, params, t = _operands(37, 23, dev)
    with pytest.raises(ValueError, match="float32"):
        warp_cuda.warp_jtj_apply(x, t["p"].double(), ur, cons, mask, params)
    with pytest.raises(ValueError, match="shape"):
        warp_cuda.warp_linearize(x[:-1], ur, cons, mask, params)
    with pytest.raises(ValueError, match="contiguous"):
        k2.pcg_update(torch.tensor(1.0, device=dev), t["p"][::2],
                      t["ap"][::2], t["delta"][::2], t["r"][::2],
                      t["pre"][::2])
    with pytest.raises(ValueError, match="cuda"):
        warp_cuda.warp_jtj_apply(x, t["p"].cpu(), ur, cons, mask, params)


def test_engines_agree_on_the_card(dev):
    import opt_tpu_torch
    from opt_tpu_torch import energies

    st = opt_tpu_torch.NewState(device="cuda")
    plan = st.problem_plan(st.problem_define(energies.image_warping,
                                             "gaussNewtonGPU"), [64, 48])
    plan.set_solver_parameter("nIterations", 3)
    plan.set_solver_parameter("lIterations", 40)
    inputs = chip_smoke.warp_inputs(64, 48, seed=6)
    cost = plan.solve(inputs)
    assert plan.engine == "cuda"
    want = plan.solve(inputs, engine="torch")
    assert np.isfinite(cost)
    assert cost == pytest.approx(want, rel=1e-4)
    # repeated runs match bit for bit: no float atomics in any kernel
    assert plan.solve(inputs) == cost
