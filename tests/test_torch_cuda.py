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
from opt_tpu_torch.ops import graph_cuda, stream3d_cuda, stream_cuda
from opt_tpu_torch.ops import vol_cuda, warp_cuda
from opt_tpu_torch.runtime.trace import LAUNCHES

pytestmark = pytest.mark.cuda

# K11's two kernels, each counted on its own
K11_PASSES = ("K11.graph_hat_edge", "K11.graph_hat_vertex")

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
    n = LAUNCHES["K1.warp_jtj_apply"]
    got = warp_cuda.warp_jtj_apply(x, t["p"], ur, cons, mask, params)
    assert LAUNCHES["K1.warp_jtj_apply"] == n + 1
    _close(got, warp_cuda.warp_jtj_apply_plain(x, t["p"], ur, cons, mask,
                                               params))


# K1 and K15 on the row-marching core (csrc/warp_tile.cuh): ragged strips
# of 32 columns and ragged chunks of rows, one pixel, one column past 16
# strips, and the paths' grids
MARCH_SIZES = [(33, 9), (1, 1), (513, 7), (512, 512), (2048, 2048)]


def _march_operands(W, H, dev, seed=7):
    """kernel_operands with excluded pixels beside a strip's edge columns
    and on a chunk's first row, where the grid has them."""
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed)
    for i, j in ((1, 31), (H - 1, 32), (4, 0), (4, 63), (5, 64)):
        if i < H and j < W:
            mask[i, j] = 1.0
    return x, ur, cons, mask, params, t


def _k1_partials(x, p, ur, cons, mask, params, ctc):
    """K1 through its C entry, into as many partials as
    opt_warp_apply_blocks gives, NaN before the launch: (Ap, partials)."""
    from opt_tpu_torch.ops import build

    lib = build.library()
    H, W = mask.shape[:2]
    ap = torch.empty_like(p)
    parts = torch.full((lib.opt_warp_apply_blocks(H, W),), float("nan"),
                       device=p.device)
    ptr = build.ptr
    build.check(lib.opt_warp_jtj_apply(
        ptr(x), ptr(p), ptr(ur), ptr(cons), ptr(mask), ptr(params), ptr(ctc),
        ptr(ap), ptr(parts), H, W, build.stream()), "warp_jtj_apply")
    return ap, parts


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", MARCH_SIZES)
def test_jtj_apply_march_matches_plain_and_repeats(dev, W, H, lm):
    x, ur, cons, mask, params, t = _march_operands(W, H, dev)
    args = (x, t["p"], ur, cons, mask, params, t["ctc"] if lm else None)
    n = LAUNCHES["K1.warp_jtj_apply"]
    got = warp_cuda.warp_jtj_apply(*args)
    assert LAUNCHES["K1.warp_jtj_apply"] == n + 1
    _close(got, warp_cuda.warp_jtj_apply_plain(*args))
    # every block writes its one partial; two calls match bit for bit
    a, b = _k1_partials(*args), _k1_partials(*args)
    assert not torch.isnan(a[1]).any()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], got[0])
    assert float(torch.sum(a[1])) == float(got[1])


def test_jtj_apply_march_on_unaligned_operands(dev):
    """p, ur and ctc at an odd float offset in their storage: the core
    moves them as single floats, with the same result."""
    W, H = 33, 9
    x, ur, cons, mask, params, t = _march_operands(W, H, dev)
    shifted = lambda a: torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(
        a.shape)
    args = (x, shifted(t["p"]), shifted(ur), cons, mask, params,
            shifted(t["ctc"]))
    assert args[1].data_ptr() % 8 == 4
    got = warp_cuda.warp_jtj_apply(*args)
    _close(got, warp_cuda.warp_jtj_apply_plain(*args))
    assert torch.equal(got[0], warp_cuda.warp_jtj_apply(
        x, t["p"], ur, cons, mask, params, t["ctc"])[0])


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
    n = LAUNCHES["K4.warp_hat_apply"]
    _close(stream_cuda.warp_hat_apply(*args, t["p"], beta),
           stream_cuda.warp_hat_apply_plain(*args, t["p"], beta))
    _close(stream_cuda.warp_hat_apply(*args),
           stream_cuda.warp_hat_apply_plain(*args))
    assert LAUNCHES["K4.warp_hat_apply"] == n + 2


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", HAT_SIZES)
def test_pipelined_sweep_kernel_matches_plain(dev, W, H, lm):
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed=5)
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    consts = (x, ur, cons, mask, params, t["sq"], t["scs"] if lm else None)
    b_hat = t["b"] if lm else None
    kern, plain = (chip_smoke.sweep_case(torch, fn, consts, t, alpha, beta,
                                         b_hat)
                   for fn in (stream_cuda.warp_pipelined_sweep,
                              stream_cuda.warp_pipelined_sweep_plain))
    got = kern()
    assert (got[2] is None) == (not lm)  # LM's q
    _close(got, plain())
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
    want = plan.solve(inputs, engine="cuda")
    # classic by default; GN's pipelined loop on request
    for variant in (("classic", "pipelined") if kind == "gaussNewtonGPU"
                    else ("classic",)):
        plan.stream_variant = None if variant == "classic" else variant
        cost = plan.solve(inputs, engine="stream")
        assert plan.variant == variant
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


# the slice-3 kernels: an odd volume, ragged 32x8 blocks on every face
VOL_DIMS = chip_smoke.SMALL_VOL


def _vol_operands(dev):
    return chip_smoke.volume_kernel_operands(torch, *VOL_DIMS, dev, seed=6)


@pytest.mark.parametrize("mode", ["full", "cost_only", "model_cost"])
def test_vol_linearize_kernel_matches_plain(dev, mode):
    x, ur, cons, params, t = _vol_operands(dev)
    kw = {"cost_only": {"cost_only": True},
          "model_cost": {"delta": t["delta"]}}.get(mode, {})
    n = LAUNCHES["K8.vol_linearize"]
    got = vol_cuda.vol_linearize(x, ur, cons, params, **kw)
    assert LAUNCHES["K8.vol_linearize"] == n + 1
    _close(got, vol_cuda.vol_linearize_plain(x, ur, cons, params, **kw))


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
def test_vol_hat_apply_kernel_matches_plain(dev, lm, prev):
    x, ur, cons, params, t = _vol_operands(dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    args = (x, ur, cons, params, t["sq"], t["scs"] if lm else None, t["r"])
    extra = (t["p"], beta) if prev else ()
    n = LAUNCHES["K6.vol_hat_apply"]
    got = stream3d_cuda.vol_hat_apply(*args, *extra)
    assert LAUNCHES["K6.vol_hat_apply"] == n + 1
    assert (got[0] is t["r"]) == (not prev)
    _close(got, stream3d_cuda.vol_hat_apply_plain(*args, *extra))


@pytest.mark.parametrize("lm", [False, True])
def test_vol_pipelined_sweep_kernel_matches_plain(dev, lm):
    x, ur, cons, params, t = _vol_operands(dev)
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    consts = (x, ur, cons, params, t["sq"], t["scs"] if lm else None)
    b_hat = t["b"] if lm else None
    kern, plain = (chip_smoke.sweep_case(torch, fn, consts, t, alpha, beta,
                                         b_hat)
                   for fn in (stream3d_cuda.vol_pipelined_sweep,
                              stream3d_cuda.vol_pipelined_sweep_plain))
    _close(kern(), plain())
    w = t["r"].clone()
    with pytest.raises(ValueError, match="two"):
        stream3d_cuda.vol_pipelined_sweep(
            *consts, w, w, t["ap"].clone(), t["b"].clone(), t["p"].clone(),
            t["delta"].clone(), t["r"].clone(), alpha, beta)


def _vol_plan(kind, dims, n_outer=3, n_linear=30):
    import opt_tpu_torch
    from opt_tpu_torch import energies

    st = opt_tpu_torch.NewState(device="cuda")
    plan = st.problem_plan(st.problem_define(
        energies.volumetric_mesh_deformation, kind), list(dims))
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


def _pulled_volume(W, H, D):
    """A grid pinned on its H = 0 face and pulled on its H = H - 1 face."""
    dd, hh, ww = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                             indexing="ij")
    grid = np.stack([dd, hh, ww], axis=-1).astype(np.float32)
    cons = np.full_like(grid, -np.inf)
    cons[:, 0] = grid[:, 0]
    cons[:, -1] = grid[:, -1] + np.array([2.0, -2.0, 1.0], np.float32)
    rng = np.random.RandomState(7)
    return {"Offset": grid + 0.01 * rng.randn(*grid.shape).astype(
                np.float32),
            "Angle": (0.1 * rng.randn(*grid.shape)).astype(np.float32),
            "UrShape": grid, "Constraints": cons,
            "w_fitSqrt": 1.0, "w_regSqrt": np.sqrt(0.05)}


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_stream3d_backends_agree_on_the_card(dev, kind):
    """The pipelined and classic 3-D backends against each other (LM with
    three residual resets in each PCG solve), and repeated solves bit for
    bit: no float atomics in any kernel."""
    W, H, D = 40, 20, 12
    plan = _vol_plan(kind, (W, H, D))
    inputs = _pulled_volume(W, H, D)
    plan.stream_variant = "pipelined"
    cost = plan.solve(inputs, engine="stream3d")
    assert plan.variant == "pipelined"
    assert np.isfinite(cost)
    assert plan.solve(inputs, engine="stream3d") == cost
    plan.stream_variant = "classic"
    classic = plan.solve(inputs, engine="stream3d")
    assert plan.variant == "classic"
    assert classic == pytest.approx(cost, rel=1e-4)
    assert plan.solve(inputs, engine="stream3d") == classic


def test_stream3d_gn_runs_the_classic_loop_on_the_card(dev):
    """GN on "stream3d" with no variant asked runs the classic loop: one
    K6 and one K2 an iteration, K8 for the outer steps, and no K7."""
    plan = _vol_plan("gaussNewtonGPU", (40, 20, 12), 2, 10)
    before = dict(LAUNCHES)
    cost = plan.solve(_pulled_volume(40, 20, 12), engine="stream3d")
    assert (plan.engine, plan.variant) == ("stream3d", "classic")
    assert np.isfinite(cost)
    want = {"K6.vol_hat_apply": 20, "K2.pcg_update": 20,
            "K8.vol_linearize": 5, "K7.vol_pipelined_sweep": 0}
    assert {k: LAUNCHES[k] - before[k] for k in want} == want


def test_stream3d_launch_failure_raises_with_no_fallback(dev):
    """A volume of more D planes than a grid's z extent (65,535) makes K7
    fail to launch: it raises out of Plan.solve (after K8's outer step and
    K6's w_0) and from its wrapper.  K8 marches chunks of planes sized to
    one wave, so it runs at that depth and agrees with its plain version;
    K6 marches chunks of a fixed number of planes, so it fails past 65,535
    chunks and raises from its wrapper."""
    D = 70000
    plan = _vol_plan("gaussNewtonGPU", (1, 1, D), 1, 2)
    plan.stream_variant = "pipelined"
    rng = np.random.RandomState(0)
    shape = (D, 1, 1, 3)
    inputs = {"Offset": rng.randn(*shape).astype(np.float32),
              "Angle": np.zeros(shape, np.float32),
              "UrShape": rng.randn(*shape).astype(np.float32),
              "Constraints": rng.randn(*shape).astype(np.float32),
              "w_fitSqrt": 1.0, "w_regSqrt": 1.0}
    n = LAUNCHES["K8.vol_linearize"]
    with pytest.raises(RuntimeError,
                       match="vol_pipelined_sweep: CUDA error"):
        plan.solve(inputs, engine="stream3d")
    assert plan.engine == "stream3d"
    assert LAUNCHES["K8.vol_linearize"] > n
    x, data = plan.bind(inputs)
    op = plan._operator("stream3d", data)
    for kw in ({}, {"cost_only": True}):
        _close(vol_cuda.vol_linearize(x, op.ur, op.cons, op.params, **kw),
               vol_cuda.vol_linearize_plain(x, op.ur, op.cons, op.params,
                                            **kw))
    v = torch.ones_like(x)
    op._x = x
    Dk = 65536 * _hat_chunk()
    vk = torch.ones(6 * Dk, device=dev)
    urk = torch.zeros(Dk, 1, 1, 3, device=dev)
    with pytest.raises(RuntimeError, match="vol_hat_apply: CUDA error"):
        stream3d_cuda.vol_hat_apply(vk, urk, urk, op.params, vk, None, vk)
    zero = torch.zeros((), device=dev)
    with pytest.raises(RuntimeError,
                       match="vol_pipelined_sweep: CUDA error"):
        stream3d_cuda.vol_pipelined_sweep(
            x, op.ur, op.cons, op.params, v, None, v.clone(), v.clone(),
            v.clone(), v.clone(), v.clone(), v.clone(), v.clone(), zero,
            zero)
    torch.cuda.synchronize()


# K6 and K16 on the tile core (csrc/vol_tile.cuh): ragged 32x8 tiles, one
# plane, one plane past a block's chunk of planes, and the paths' 128^3
TILE_SHAPES = ["33x9x1", "33x9xchunk+1", "128^3"]


def _hat_chunk():
    """The planes a K6 block marches (kTileD), from its grid."""
    from opt_tpu_torch.ops import build

    return 65536 // build.library().opt_vol_hat_blocks(65536, 1, 1)


def _tile_dims(shape):
    if shape == "128^3":
        return (chip_smoke.VOL,) * 3
    W, H, D = shape.split("x")
    return int(W), int(H), _hat_chunk() + 1 if D == "chunk+1" else int(D)


def _k6_partials(x, ur, cons, params, sq, scs, r, p_prev, beta):
    """K6 through its C entry: (p or None, A_hat p, the dot partials)."""
    from opt_tpu_torch.ops import build

    lib = build.library()
    D, H, W = ur.shape[:3]
    p = None if p_prev is None else torch.empty_like(r)
    ap = torch.empty_like(r)
    parts = torch.empty(lib.opt_vol_hat_blocks(D, H, W), device=r.device)
    ptr = build.ptr
    build.check(lib.opt_vol_hat_apply(
        ptr(x), ptr(ur), ptr(cons), ptr(params), ptr(sq), ptr(scs), ptr(r),
        ptr(p_prev), ptr(beta), ptr(p), ptr(ap), ptr(parts), D, H, W,
        build.stream()), "vol_hat_apply")
    return p, ap, parts


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_vol_hat_apply_tile_core_matches_plain_and_repeats(dev, shape, lm,
                                                          prev):
    x, ur, cons, params, t = chip_smoke.volume_kernel_operands(
        torch, *_tile_dims(shape), dev, seed=7)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    args = (x, ur, cons, params, t["sq"], t["scs"] if lm else None, t["r"])
    extra = (t["p"], beta) if prev else ()
    n = LAUNCHES["K6.vol_hat_apply"]
    got = stream3d_cuda.vol_hat_apply(*args, *extra)
    assert LAUNCHES["K6.vol_hat_apply"] == n + 1
    _close(got, stream3d_cuda.vol_hat_apply_plain(*args, *extra))
    # two calls: the same outputs and dot partials, bit for bit
    a = _k6_partials(*args, *(extra or (None, None)))
    b = _k6_partials(*args, *(extra or (None, None)))
    for u, v in zip(a, b):
        assert (u is None and v is None) or torch.equal(u, v)
    assert torch.equal(a[1], got[1])
    assert float(torch.sum(a[2])) == float(got[2])


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_vol_operator_apply_on_the_tile_core(dev, shape):
    """VolOperator.apply: K6 with sq = 1, ctc as scs and no p_prev."""
    x, ur, cons, params, t = chip_smoke.volume_kernel_operands(
        torch, *_tile_dims(shape), dev, seed=8)
    op = vol_cuda.VolOperator({
        "images": {"UrShape": ur, "Constraints": cons},
        "params": {"w_fitSqrt": params[0], "w_regSqrt": params[1]}})
    op._x = x
    for ctc in (None, t["scs"]):
        _close(op.apply(t["p"], ctc), vol_cuda.vol_jtj_apply_plain(
            x, t["p"], ur, cons, op.params, ctc))


@pytest.mark.parametrize("n", ["1", "chunk+1"])
def test_vol_slab_apply_tile_core_matches_plain_and_repeats(dev, n):
    """K16 on 3 slabs of one plane, and of one plane past a chunk."""
    from opt_tpu_torch.ops import slab_cuda as sc

    n = _hat_chunk() + 1 if n == "chunk+1" else int(n)
    x, ur, cons, params, t, g = chip_smoke.vol_slab_operands(
        torch, 33, 9, 3 * n, 3, dev, seed=10)
    assert g[:2] == (n, 2)
    for s in (None, 0, 1, 2):
        (xs, urs, cs, sq, p), gs = (
            ((x, ur, cons, t["sq"], t["p"]), g) if s is None
            else _alone((x, ur, cons, t["sq"], t["p"]), s, g))
        got = sc.vol_slab_apply(xs, urs, cs, params, sq, p, gs)
        _close([got], [sc.vol_slab_apply_plain(xs, urs, cs, params, sq, p,
                                                gs)])
        assert torch.equal(got, sc.vol_slab_apply(xs, urs, cs, params, sq,
                                                  p, gs))


def test_vol_tile_kernels_refuse_misshaped_calls(dev):
    """A misshaped operand or slab geometry raises before any launch."""
    from opt_tpu_torch.ops import slab_cuda as sc

    x, ur, cons, params, t = chip_smoke.volume_kernel_operands(
        torch, 33, 9, 3, dev, seed=7)
    n = LAUNCHES["K6.vol_hat_apply"]
    with pytest.raises(ValueError, match="vol_hat_apply"):
        stream3d_cuda.vol_hat_apply(x, ur, cons, params, t["sq"][:-6], None,
                                    t["r"])
    with pytest.raises(ValueError, match="p_prev and beta"):
        stream3d_cuda.vol_hat_apply(x, ur, cons, params, t["sq"], None,
                                    t["r"], t["p"])
    assert LAUNCHES["K6.vol_hat_apply"] == n
    xs, urs, cs, ps, ts, g = chip_smoke.vol_slab_operands(
        torch, 33, 9, 6, 3, dev, seed=10)
    with pytest.raises(ValueError, match="vol_slab_apply"):
        sc.vol_slab_apply(xs, urs, cs, ps, ts["sq"], ts["p"],
                          (g[0], 1, g[2], g[3]))


# the slice-4 kernels: meshes whose vertex and edge counts leave ragged
# blocks (19 x 19 = 361 vertices, 37 x 23 = 851)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_gather_and_scatter_match_plain(dev, dtype):
    v0, v1 = chip_smoke.tri_grid_graph(37, 23)
    n = 37 * 23
    rng = np.random.RandomState(8)
    v = torch.as_tensor(rng.randn(n, 5), device=dev).to(dtype)
    x = torch.as_tensor(rng.randn(len(v0), 5), device=dev).to(dtype)
    idx = torch.as_tensor(np.stack([v0, v1]), device=dev)
    k9 = LAUNCHES["K9.graph_gather"]
    k10 = LAUNCHES["K10.graph_scatter"]
    got = graph_cuda.graph_gather(v, idx)
    assert got.shape == (2, len(v0), 5) and got.dtype == dtype
    # a gather moves values: exact
    assert torch.equal(got, graph_cuda.graph_gather_plain(v, idx))
    order, rowptr = (torch.as_tensor(a, device=dev)
                     for a in graph_cuda.incidence(v1, n))
    out = graph_cuda.graph_scatter(x, idx[1], order, rowptr)
    _close([out], [graph_cuda.graph_scatter_plain(x, idx[1], n)])
    assert torch.equal(out, graph_cuda.graph_scatter(x, idx[1], order, rowptr))
    assert LAUNCHES["K9.graph_gather"] == k9 + 1
    assert LAUNCHES["K10.graph_scatter"] == k10 + 2


# K9 and K10 at every channel count they instantiate (1-8) and one the
# generic kernels take (11); a base one element past an aligned address
# sends a vector-width row to the generic kernels too
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_kernels_exact_at_every_width(dev, dtype, C):
    v0, v1 = chip_smoke.tri_grid_graph(37, 23)
    n, E = 37 * 23, len(v0)
    rng = np.random.RandomState(C)
    idx = torch.as_tensor(np.stack([v0, v1, v0[::-1].copy()]), device=dev)
    order, rowptr = (torch.as_tensor(a, device=dev)
                     for a in graph_cuda.incidence(v1, n))
    flat_v = torch.as_tensor(rng.randn(n * C + 1), device=dev).to(dtype)
    flat_x = torch.as_tensor(rng.randn(E * C + 1), device=dev).to(dtype)
    for off in (0, 1):
        v = flat_v[off:off + n * C].view(n, C)
        x = flat_x[off:off + E * C].view(E, C)
        k9 = LAUNCHES["K9.graph_gather"]
        k10 = LAUNCHES["K10.graph_scatter"]
        want = graph_cuda.graph_gather_plain(v, idx)
        got = graph_cuda.graph_gather(v, idx)
        assert got.shape == (3, E, C) and got.dtype == dtype
        assert torch.equal(got, want)
        out = graph_cuda.graph_scatter(x, idx[1], order, rowptr)
        assert torch.equal(out.cpu(), chip_smoke.scatter_in_edge_order(
            torch, x, order, rowptr))
        assert torch.equal(out, graph_cuda.graph_scatter(x, idx[1], order,
                                                         rowptr))
        torch.cuda.synchronize()
        assert LAUNCHES["K9.graph_gather"] == k9 + 1
        assert LAUNCHES["K10.graph_scatter"] == k10 + 2


def test_graph_kernels_refuse_bad_operands(dev):
    v0, v1 = chip_smoke.tri_grid_graph(9, 7)
    n = 63
    v = torch.randn(n, 4, device=dev)
    x = torch.randn(len(v0), 4, device=dev)
    idx = torch.as_tensor(v1, device=dev)
    order, rowptr = (torch.as_tensor(a, device=dev)
                     for a in graph_cuda.incidence(v1, n))
    k9 = LAUNCHES["K9.graph_gather"]
    k10 = LAUNCHES["K10.graph_scatter"]
    with pytest.raises(ValueError, match="float32 or float64"):
        graph_cuda.graph_gather(v.half(), idx)
    with pytest.raises(ValueError, match="int64"):
        graph_cuda.graph_gather(v, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        graph_cuda.graph_gather(torch.randn(4, n, device=dev).t(), idx)
    with pytest.raises(ValueError, match="cuda"):
        graph_cuda.graph_gather(v, idx.cpu())
    with pytest.raises(ValueError, match="want \\(N, C\\)"):
        graph_cuda.graph_gather(v.view(-1), idx)
    with pytest.raises(ValueError, match="float32 or float64"):
        graph_cuda.graph_scatter(x.half(), idx, order, rowptr)
    with pytest.raises(ValueError, match="int64"):
        graph_cuda.graph_scatter(x, idx, order.long(), rowptr)
    with pytest.raises(ValueError, match="contiguous"):
        graph_cuda.graph_scatter(torch.randn(4, len(v0), device=dev).t(),
                                 idx, order, rowptr)
    with pytest.raises(ValueError, match="cuda"):
        graph_cuda.graph_scatter(x, idx, order, rowptr.cpu())
    with pytest.raises(ValueError, match="shape"):
        graph_cuda.graph_scatter(x[:-1], idx, order, rowptr)
    assert LAUNCHES["K9.graph_gather"] == k9
    assert LAUNCHES["K10.graph_scatter"] == k10


def irregular_graph_inputs(seed=1):
    """arap inputs on a 50-vertex graph that stresses K11's two passes: a
    star vertex (0) with 40 edges each way, a chain of 8, vertex 49 on no
    edge, E = 94 edges (not a multiple of the edge pass's 128-edge
    block).  (inputs, dims)."""
    nv = 50
    star, chain = np.arange(1, 41), np.arange(41, 48)
    v0 = np.concatenate([np.zeros(40, int), star, chain, chain + 1])
    v1 = np.concatenate([star, np.zeros(40, int), chain + 1, chain])
    rng = np.random.RandomState(seed)
    ur = rng.randn(nv, 3).astype(np.float32)
    cons = np.full((nv, 3), -1e7, np.float32)
    cons[:10] = ur[:10] + 0.1
    inputs = {"Offset": ur + 0.1 * rng.randn(nv, 3).astype(np.float32),
              "Angle": (0.3 * rng.randn(nv, 3)).astype(np.float32),
              "UrShape": ur, "Constraints": cons, "w_fitSqrt": 2.0,
              "w_regSqrt": 1.0,
              "G": {"v0": v0.astype(np.int32), "v1": v1.astype(np.int32)}}
    return inputs, [nv, len(v0)]


def _hat_tables(dev, case):
    """(HatTables, vectors) on the card: arap's 19 x 19 mesh (the edge
    pass's arap instantiation), embedded_mesh_deformation's (15 leaves, 12
    on one slot: the generic edge kernel and the vertex pass's chunked
    sum), or arap on irregular_graph_inputs."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    if case == "arap":
        tab, _, t = chip_smoke.graph_kernel_operands(torch, 19, dev, seed=9)
        return tab, t
    if case == "irregular":
        name = "arap_mesh_deformation"
        inputs, dims = irregular_graph_inputs()
    else:
        name = "embedded_mesh_deformation"
        inputs = chip_smoke.arap_inputs(19, seed=9)
        rng = np.random.RandomState(9)
        inputs.pop("Angle")
        inputs["RotMatrix"] = (np.tile(np.eye(3).reshape(1, 9), (361, 1))
                               + 0.1 * rng.randn(361, 9)).astype(np.float32)
        inputs["w_rotSqrt"] = 0.5
        dims = [361, len(inputs["G"]["v0"])]
    st = opt_tpu_torch.NewState(device="cuda")
    plan = st.problem_plan(st.problem_define(getattr(energies, name),
                                             "LMGPU"), dims)
    x, data = plan.bind(inputs)
    op = graph_cuda.GraphOperator(plan.funcs, data, plan.layout, True,
                                  graph_cuda.plan_meta(plan))
    op.outer(x)
    rng = np.random.RandomState(10)
    n = x.numel()
    t = {k: torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
         for k in ("r", "p")}
    t["sq"] = torch.as_tensor(rng.rand(n).astype(np.float32), device=dev)
    t["scs"] = t["sq"] * t["sq"] * 0.7
    return op.tables, t


HAT_CASES = ["arap", "embedded", "irregular"]


@pytest.mark.parametrize("case", HAT_CASES)
@pytest.mark.parametrize("prev", [False, True])
def test_graph_hat_edge_kernel_matches_plain(dev, case, prev):
    tab, t = _hat_tables(dev, case)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    extra = (t["p"], beta) if prev else ()
    n = LAUNCHES["K11.graph_hat_edge"]
    got = graph_cuda.graph_hat_edge(tab, t["sq"], t["r"], *extra)
    assert LAUNCHES["K11.graph_hat_edge"] == n + 1
    want = graph_cuda.graph_hat_edge_plain(tab, t["sq"], t["r"], *extra)
    for rows, wrows in zip(got, want):
        assert [r.shape for r in rows] == [w.shape for w in wrows]
        _close(rows, wrows)


@pytest.mark.parametrize("case", HAT_CASES)
@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
def test_graph_hat_vertex_kernel_matches_plain(dev, case, lm, prev):
    """The vertex pass on the plain edge pass's rows (copied into the
    tables' buffer) against its plain version."""
    tab, t = _hat_tables(dev, case)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    extra = (t["p"], beta) if prev else ()
    c = graph_cuda.graph_hat_edge_plain(tab, t["sq"], t["r"], *extra)
    args = (tab, c, t["sq"], t["scs"] if lm else None, t["r"])
    n = LAUNCHES["K11.graph_hat_vertex"]
    got = [x.clone() for x in graph_cuda.graph_hat_vertex(*args, *extra)]
    assert LAUNCHES["K11.graph_hat_vertex"] == n + 1
    _close(got, graph_cuda.graph_hat_vertex_plain(*args, *extra))


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
def test_graph_hat_apply_kernel_matches_plain(dev, lm, prev):
    tab, _, t = chip_smoke.graph_kernel_operands(torch, 19, dev, seed=9)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    args = (tab, t["sq"], t["scs"] if lm else None, t["r"])
    extra = (t["p"], beta) if prev else ()
    n = [LAUNCHES[k] for k in K11_PASSES]
    got = graph_cuda.graph_hat_apply(*args, *extra)
    assert [LAUNCHES[k] for k in K11_PASSES] == [c + 1 for c in n]
    assert (got[0] is t["r"]) == (not prev)
    _close(got, graph_cuda.graph_hat_apply_plain(*args, *extra))
    # no atomics: the same bits on a second call, in the same scratch
    c, parts = tab.c.data_ptr(), tab.partials.data_ptr()
    again = graph_cuda.graph_hat_apply(*args, *extra)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (tab.c.data_ptr(), tab.partials.data_ptr()) == (c, parts)


@pytest.mark.parametrize("case", ["embedded", "irregular"])
@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
def test_graph_hat_apply_on_other_shapes_matches_plain(dev, case, lm, prev):
    """The apply where the edge pass takes its generic kernel (embedded) and
    on a graph with an isolated vertex, a star of 40 and a ragged last
    block (irregular)."""
    tab, t = _hat_tables(dev, case)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    args = (tab, t["sq"], t["scs"] if lm else None, t["r"])
    extra = (t["p"], beta) if prev else ()
    got = graph_cuda.graph_hat_apply(*args, *extra)
    _close(got, graph_cuda.graph_hat_apply_plain(*args, *extra))
    again = graph_cuda.graph_hat_apply(*args, *extra)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_graph_partials_match_the_kernel_grid(dev):
    """HatTables sizes partials from VERTEX_THREADS; the vertex pass's grid
    is opt_graph_blocks(N)."""
    from opt_tpu_torch.ops import build

    for case in ("arap", "irregular"):
        tab, _ = _hat_tables(dev, case)
        assert (build.library().opt_graph_blocks(tab.n_verts)
                == tab.partials.numel())


def _arap_plan(kind, w, device="cuda", n_outer=3, n_linear=30, **state):
    import opt_tpu_torch
    from opt_tpu_torch import energies

    st = opt_tpu_torch.NewState(device=device, **state)
    plan = st.problem_plan(
        st.problem_define(energies.arap_mesh_deformation, kind),
        [w * w, len(chip_smoke.tri_grid_graph(w, w)[0])])
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_graph_engine_agrees_and_repeats_on_the_card(dev, kind):
    """engine="auto" picks "graph"; its solves repeat bit for bit (no
    atomics in K9-K11), and agree with the plain engine on the card (K9
    and K10 inside its traced J p) and with the graph engine on the CPU."""
    inputs = chip_smoke.arap_inputs(19, seed=3)
    plan = _arap_plan(kind, 19)
    cost = plan.solve(inputs)
    assert plan.engine == "graph"
    assert np.isfinite(cost)
    assert plan.solve(inputs) == cost
    assert plan.solve(inputs, engine="torch") == pytest.approx(cost, rel=1e-4)
    cpu = _arap_plan(kind, 19, device="cpu").solve(inputs, engine="graph")
    assert cost == pytest.approx(cpu, rel=1e-4)


def test_traced_jp_runs_the_gathers(dev):
    """torch.func.linearize traces J p with make_fx and replays the trace:
    K9 and K10 are custom ops, so the replay launches them on each new
    tangent rather than returning the buffers of the trace.  Two tangents,
    held against the CPU's linearized J p and J^T, in f32 and f64."""
    for dp in (False, True):
        inputs = chip_smoke.arap_inputs(19, seed=4)
        inputs["Angle"] = (0.2 * np.random.RandomState(5).randn(361, 3))
        got = {}
        for device in ("cuda", "cpu"):
            plan = _arap_plan("gaussNewtonGPU", 19, device,
                              double_precision=dp)
            x, data = plan.bind(inputs)
            r0, jvp, jt = plan.funcs.linearize(plan.layout.views(x), data)
            rng = np.random.RandomState(6)
            outs = []
            for _ in range(2):
                p = torch.as_tensor(rng.randn(x.numel()), device=device).to(
                    x.dtype)
                jp = jvp(plan.layout.views(p))
                outs.append([f.cpu() for f in jp])
                outs.append([v.cpu() for v in jt(jp).values()])
            got[device] = outs
        for a, b in zip(got["cuda"], got["cpu"]):
            _close(a, b)
        assert not torch.equal(got["cuda"][0][1], got["cuda"][2][1])


def test_graph_launch_failure_raises_through_solve(dev, monkeypatch):
    """K11 refusing its launch (here: a table longer than the kernel's
    shared copy, which the C entry rejects with cudaErrorInvalidValue)
    raises out of Plan.solve: no engine catches it and carries on."""
    set_partials = graph_cuda.HatTables.set_partials

    def too_long(self, D_groups):
        set_partials(self, D_groups)
        self.meta = torch.cat([self.meta, torch.zeros(
            graph_cuda.META_MAX, dtype=torch.int32, device=self.meta.device)])

    monkeypatch.setattr(graph_cuda.HatTables, "set_partials", too_long)
    plan = _arap_plan("gaussNewtonGPU", 19, n_outer=1, n_linear=2)
    with pytest.raises(RuntimeError, match="graph_hat_apply: CUDA error"):
        plan.solve(chip_smoke.arap_inputs(19))
    assert plan.engine == "graph"
    torch.cuda.synchronize()


def test_graph_vertex_pass_failure_raises_through_solve(dev, monkeypatch):
    """K11's second kernel refused (here: tables claiming 0 vertices, an
    empty grid for the vertex pass, after an edge pass that launches)
    raises out of Plan.solve with CUDA's error: no fallback."""
    set_partials = graph_cuda.HatTables.set_partials

    def no_vertices(self, D_groups):
        set_partials(self, D_groups)
        self.n_verts = 0

    monkeypatch.setattr(graph_cuda.HatTables, "set_partials", no_vertices)
    plan = _arap_plan("gaussNewtonGPU", 19, n_outer=1, n_linear=2)
    n = [LAUNCHES[k] for k in K11_PASSES]
    with pytest.raises(RuntimeError,
                       match="graph_hat_apply: CUDA error 9 "):
        plan.solve(chip_smoke.arap_inputs(19))
    assert plan.engine == "graph"
    assert [LAUNCHES[k] for k in K11_PASSES] == n
    torch.cuda.synchronize()


# the slice-5 kernels: K12 and K13 at a ragged 37 x 23 (ragged 256-pixel
# blocks) with excluded pixels, at 50 iterations, where a stale read of a
# neighbour's p across a grid sync would show; K14 at ragged shapes
ITERS = [1, chip_smoke.RESIDENT_CHECK_ITERS]
def _poisson_operands(dev, C, seed=10):
    """b (C, 23, 37) with channel 2 zero when C is 4, and keep with an
    excluded frame and an excluded pixel inside."""
    rng = np.random.RandomState(seed)
    Ws, Hs = chip_smoke.SMALL_POISSON
    keep = np.zeros((Hs, Ws), np.float32)
    keep[3:-3, 4:-4] = 1.0
    keep[11, 17] = 0.0
    b = rng.randn(C, Hs, Ws).astype(np.float32)
    if C == 4:
        b[2] = 0.0
    return (torch.as_tensor(b, device=dev), torch.as_tensor(keep, device=dev))


@pytest.mark.parametrize("n_iters", ITERS)
@pytest.mark.parametrize("C", [1, 4])
def test_poisson_cg_kernel_matches_plain(dev, C, n_iters):
    from opt_tpu_torch.ops import poisson_cuda

    b, keep = _poisson_operands(dev, C)
    n = LAUNCHES["K12.poisson_cg"]
    got = poisson_cuda.poisson_cg(b, keep, n_iters)
    assert LAUNCHES["K12.poisson_cg"] == n + 1
    _close([got], [poisson_cuda.poisson_cg_plain(b, keep, n_iters)])
    assert torch.isfinite(got).all()
    if C == 4:
        assert not got[2].any()  # the all-zero channel: delta 0, no NaN
    assert not got[:, keep == 0].any()
    # no float atomics: a second launch matches bit for bit
    assert torch.equal(got, poisson_cuda.poisson_cg(b, keep, n_iters))


@pytest.mark.parametrize("n_iters", ITERS)
@pytest.mark.parametrize("energy", ["warp", "poisson"])
def test_resident_pcg_kernel_matches_plain(dev, energy, n_iters):
    hat, sq, b_hat = chip_smoke.resident_operands(torch, energy,
                                                  *chip_smoke.SMALL_POISSON,
                                                  dev)
    n = LAUNCHES["K13.resident_pcg"]
    got = stream_cuda.resident_pcg(hat, sq, b_hat, n_iters)
    assert LAUNCHES["K13.resident_pcg"] == n + 1
    _close([got], [stream_cuda.resident_pcg_plain(hat, sq, b_hat, n_iters)])
    assert not got[sq == 0].any()
    assert torch.equal(got, stream_cuda.resident_pcg(hat, sq, b_hat,
                                                     n_iters))


# the paths' grids: StreamSolver's and the cuda engine's GN at 512^2 (warp
# and poisson), the cuda engine's explicit 2048^2 GN (warp), and K12's two
# poisson paths
PATH_CASES = [("warp", 512), ("poisson", 512), ("warp", 2048)]


@pytest.mark.parametrize("energy,size", PATH_CASES)
def test_resident_pcg_kernel_at_the_paths_grids(dev, energy, size):
    """K13 on the two-sync core within 1e-5 of its plain loop after
    RESIDENT_CHECK_ITERS iterations (where a stale neighbour read or a p
    formed differently at two sites would show), and bit for bit on a
    second launch."""
    hat, sq, b_hat = chip_smoke.resident_operands(torch, energy, size, size,
                                                  dev)
    n = chip_smoke.RESIDENT_CHECK_ITERS
    got = stream_cuda.resident_pcg(hat, sq, b_hat, n)
    _close([got], [stream_cuda.resident_pcg_plain(hat, sq, b_hat, n)])
    assert not got[sq == 0].any()
    assert torch.equal(got, stream_cuda.resident_pcg(hat, sq, b_hat, n))


# K13's on-chip form against its plain loop: float32 loops that sum in
# different orders part by a few 1e-6 over 400 iterations at 512^2
ONCHIP_RTOL = 1e-4
K13_FORMS = ("K13.resident_pcg", "K13.resident_pcg_onchip")


@pytest.mark.parametrize("n_iters", [chip_smoke.RESIDENT_CHECK_ITERS,
                                     chip_smoke.N_LINEAR])
def test_resident_pcg_onchip_form_at_512(dev, n_iters):
    """The main path's 512^2 grid takes K13's on-chip form (one launch
    on each counter), within ONCHIP_RTOL of the plain loop after 50 and
    400 iterations, and bit for bit on a second launch."""
    hat, sq, b_hat = chip_smoke.resident_operands(torch, "warp", 512, 512,
                                                  dev)
    before = [LAUNCHES[k] for k in K13_FORMS]
    got = stream_cuda.resident_pcg(hat, sq, b_hat, n_iters)
    assert [LAUNCHES[k] - n for k, n in zip(K13_FORMS, before)] == [1, 1]
    want = stream_cuda.resident_pcg_plain(hat, sq, b_hat, n_iters)
    assert float((got - want).abs().max()) <= ONCHIP_RTOL * float(
        want.abs().max())
    assert not got[sq == 0].any()
    assert torch.equal(got, stream_cuda.resident_pcg(hat, sq, b_hat,
                                                     n_iters))


@pytest.mark.parametrize("W,H,onchip", [(37, 23, True), (512, 512, True),
                                        (448, 608, False),
                                        (2048, 2048, False)])
def test_resident_pcg_form_follows_the_rule(dev, W, H, onchip):
    """The grid the C entry launches is the rule's tile count; a grid past
    the rule (one tile past the SMs, 2048^2) runs on the L2 form, counted
    only on K13.resident_pcg."""
    from opt_tpu_torch.ops import build

    tiles = stream_cuda.onchip_tiles(H, W, *build.card_limits())
    assert bool(tiles) == onchip
    if onchip:
        assert build.library().opt_resident_warp_onchip_blocks(H, W) == tiles
    hat, sq, b_hat = chip_smoke.resident_operands(torch, "warp", W, H, dev)
    before = [LAUNCHES[k] for k in K13_FORMS]
    stream_cuda.resident_pcg(hat, sq, b_hat, 5)
    assert [LAUNCHES[k] - n for k, n in zip(K13_FORMS, before)] == [
        1, int(onchip)]


@pytest.mark.parametrize("size", [512, 2048])
def test_poisson_cg_kernel_at_the_paths_grids(dev, size):
    """K12 with four channels, one all zero, on the paths' keep mask."""
    from opt_tpu_torch.ops import poisson_cuda

    keep = torch.as_tensor(
        (chip_smoke.poisson_inputs(size, size)["M"][..., 0] == 0).astype(
            np.float32), device=dev)
    b = torch.as_tensor(np.random.RandomState(size).randn(
        4, size, size).astype(np.float32), device=dev)
    b[2] = 0.0
    n = chip_smoke.RESIDENT_CHECK_ITERS
    got = poisson_cuda.poisson_cg(b, keep, n)
    _close([got], [poisson_cuda.poisson_cg_plain(b, keep, n)])
    assert not got[2].any() and not got[:, keep == 0].any()
    assert torch.equal(got, poisson_cuda.poisson_cg(b, keep, n))


def test_cuda_engine_gn_runs_one_k13_launch_an_outer_step(dev):
    """bench.py's main path, 512^2 GN 8x400 through engine="auto": the
    cuda engine, 8 K13 launches, all on the on-chip form, and K3's 17, no
    K1 and no K2; the final cost within COST_RTOL of the JAX package's CPU
    value."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    plan = chip_smoke.new_plan(opt_tpu_torch, energies, "gaussNewtonGPU",
                               512, 8, 400)
    inputs = chip_smoke.warp_inputs(512, 512)
    kernels = ("K13.resident_pcg", "K13.resident_pcg_onchip",
               "K3.warp_linearize", "K1.warp_jtj_apply", "K2.pcg_update")
    before = [LAUNCHES[k] for k in kernels]
    cost = plan.solve(inputs)
    assert plan.engine == "cuda"
    assert [LAUNCHES[k] - b for k, b in zip(kernels, before)] == [
        8, 8, 17, 0, 0]
    assert cost == pytest.approx(chip_smoke.JAX_CPU_FINAL_COST,
                                 rel=chip_smoke.COST_RTOL)


def test_resident_launch_refused_raises_through_solve(dev, monkeypatch):
    """The cuda engine's GN with K13's grid too large to be resident: the
    cooperative launch is refused and Plan.solve raises CUDA's error; no
    engine carries on with K1 and K2, and no launch is counted."""
    from opt_tpu_torch.ops import build

    lib = build.library()
    monkeypatch.setattr(build, "library", lambda: _ProxyLibrary(lib))
    plan = _mesh_plan("image_warping", "gaussNewtonGPU", (64, 48), 1, 2)
    counted = ("K13.resident_pcg", "K1.warp_jtj_apply")
    counts = [LAUNCHES[k] for k in counted]
    with pytest.raises(RuntimeError, match="resident_pcg: CUDA error"):
        plan.solve(chip_smoke.warp_inputs(64, 48, seed=6), engine="cuda")
    assert plan.engine == "cuda"
    assert counts == [LAUNCHES[k] for k in counted]
    torch.cuda.synchronize()


@pytest.mark.parametrize("tile", [7, 32, 64])
@pytest.mark.parametrize("shape", [(64, 128), (100, 200), (33, 450)])
def test_stencil_kernel_matches_plain(dev, shape, tile):
    from opt_tpu_torch.ops import halo_stencil

    img = torch.as_tensor(np.random.RandomState(11).randn(*shape).astype(
        np.float32), device=dev)
    for offsets, weights in chip_smoke.STENCIL_TAPS.values():
        n = LAUNCHES["K14.stencil_apply"]
        got = halo_stencil.stencil_apply(img, offsets, weights, tile)
        assert LAUNCHES["K14.stencil_apply"] == n + 1
        _close([got], [halo_stencil.stencil_apply_plain(img, offsets,
                                                        weights)])


class _ProxyLibrary:
    """The kernel library with its grid queries multiplied: a cooperative
    grid larger than the card holds at once."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name.endswith("_blocks"):
            return lambda *args: 1000 * fn(*args)
        return fn


def test_refused_launches_raise(dev, monkeypatch):
    """A cooperative grid too large to be resident is refused, not run:
    K12 and K13 raise.  K14 raises for a tile whose window needs more
    shared memory than a block has."""
    from opt_tpu_torch.ops import build, halo_stencil, poisson_cuda

    b, keep = _poisson_operands(dev, 4)
    hat, sq, b_hat = chip_smoke.resident_operands(
        torch, "warp", *chip_smoke.SMALL_POISSON, dev)
    lib = build.library()
    monkeypatch.setattr(build, "library", lambda: _ProxyLibrary(lib))
    with pytest.raises(RuntimeError, match="poisson_cg: CUDA error"):
        poisson_cuda.poisson_cg(b, keep, 5)
    with pytest.raises(RuntimeError, match="resident_pcg: CUDA error"):
        stream_cuda.resident_pcg(hat, sq, b_hat, 5)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="stencil_apply: CUDA error"):
        halo_stencil.stencil_apply(torch.zeros(4096, 64, device=dev),
                                   ((1, 0),), (1.0,), tile=4096)
    torch.cuda.synchronize()


def test_resident_solvers_agree_with_the_cpu(dev):
    """StreamSolver (both energies) and PoissonCudaSolver on the card
    against the same solves on a CPU plan (the plain versions), and
    repeated card solves bit for bit."""
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.ops import poisson_cuda

    W, H = 96, 64
    for energy, inputs in (
            (energies.image_warping, chip_smoke.warp_inputs(W, H, seed=6)),
            (energies.poisson_image_editing,
             chip_smoke.poisson_inputs(W, H))):
        costs = {}
        for device in ("cuda", "cpu"):
            st = opt_tpu_torch.NewState(device=device)
            plan = st.problem_plan(st.problem_define(energy,
                                                     "gaussNewtonGPU"),
                                   [W, H])
            plan.set_solver_parameter("nIterations", 3)
            plan.set_solver_parameter("lIterations", 40)
            costs[device] = stream_cuda.StreamSolver(plan).solve(
                inputs)["final_cost"]
            if energy is energies.poisson_image_editing:
                costs[device, "cg"] = poisson_cuda.PoissonCudaSolver(
                    plan).solve(inputs, 60)["final_cost"]
            if device == "cuda":
                assert stream_cuda.StreamSolver(plan).solve(
                    inputs)["final_cost"] == costs[device]
        assert np.isfinite(costs["cuda"])
        assert costs["cuda"] == pytest.approx(costs["cpu"], rel=1e-4)
        if ("cuda", "cg") in costs:
            assert costs["cuda", "cg"] == pytest.approx(costs["cpu", "cg"],
                                                        rel=1e-5)


# the slice-6 kernels (ops/slab_cuda.py) on ragged slabs: 37 columns and
# 7 own rows (2-D), 3 own planes of 37x23 (3-D) -- neither a multiple of
# the 32x8 blocks -- three slabs (the first, an interior one, the last) in
# one launch, and each alone with its own global offset (a rank's batch
# in the group form)
SLABS = 3


def _warp_slabs(dev):
    return chip_smoke.slab_operands(torch, 37, 7 * SLABS, SLABS, dev,
                                    seed=8)


def _alone(ops, s, g):
    """Slab s of a batch as a batch of its own."""
    n, he, row0, total = g
    return [a[s:s + 1] for a in ops], (n, he, row0 + s * n, total)


def test_warp_slab_kernels_match_plain(dev):
    from opt_tpu_torch.ops import slab_cuda as sc

    x, ur, cons, mask, params, t, g = _warp_slabs(dev)
    for s in (None, 0, 1, 2):
        (xs, urs, cs, ms, sq, p, d), gs = (
            ((x, ur, cons, mask, t["sq"], t["p"], t["delta"]), g)
            if s is None else
            _alone((x, ur, cons, mask, t["sq"], t["p"], t["delta"]), s, g))
        n0 = LAUNCHES["K15.warp_slab_apply"]
        _close([sc.warp_slab_apply(xs, urs, cs, ms, params, sq, p, gs)],
               [sc.warp_slab_apply_plain(xs, urs, cs, ms, params, sq, p,
                                         gs)])
        assert LAUNCHES["K15.warp_slab_apply"] == n0 + 1
        for kw in ({}, {"cost_only": True}, {"delta": d}):
            _close(sc.warp_slab_linearize(xs, urs, cs, ms, params, gs, **kw),
                   sc.warp_slab_linearize_plain(xs, urs, cs, ms, params, gs,
                                                **kw))


@pytest.mark.parametrize("case", ["3x1", "3x17", "2048^2"])
def test_warp_slab_apply_march_matches_plain_and_repeats(dev, case):
    """K15 on the row-marching core: 3 slabs of 1 and of 17 rows at a
    ragged width (the first slab's halo before the global edge, the last's
    past it), and the sharded paths' 4 slabs of 512 rows at 2048^2; the
    batch and each slab alone, each twice, bit for bit."""
    from opt_tpu_torch.ops import slab_cuda as sc

    if case == "2048^2":
        W = H = chip_smoke.BIG
        S = chip_smoke.SHARD_SLABS
    else:
        S, n = map(int, case.split("x"))
        W, H = 37, S * n
    x, ur, cons, mask, params, t, g = chip_smoke.slab_operands(
        torch, W, H, S, dev, seed=11)
    assert g[:2] == (H // S, 2)
    for s in (None,) + tuple(range(S)):
        ops, gs = (((x, ur, cons, mask, t["sq"], t["p"]), g) if s is None
                   else _alone((x, ur, cons, mask, t["sq"], t["p"]), s, g))
        xs, urs, cs, ms, sq, p = ops
        got = sc.warp_slab_apply(xs, urs, cs, ms, params, sq, p, gs)
        _close([got], [sc.warp_slab_apply_plain(xs, urs, cs, ms, params, sq,
                                                p, gs)])
        assert torch.equal(got, sc.warp_slab_apply(xs, urs, cs, ms, params,
                                                   sq, p, gs))


def test_warp_march_kernels_refuse_misshaped_calls(dev):
    """A misshaped operand or slab geometry raises before any launch."""
    from opt_tpu_torch.ops import slab_cuda as sc

    x, ur, cons, mask, params, t = _march_operands(33, 9, dev)
    n = LAUNCHES["K1.warp_jtj_apply"]
    with pytest.raises(ValueError, match="warp_jtj_apply"):
        warp_cuda.warp_jtj_apply(x, t["p"][:-3], ur, cons, mask, params)
    with pytest.raises(ValueError, match="warp_jtj_apply"):
        warp_cuda.warp_jtj_apply(x, t["p"], ur, cons, mask, params,
                                 t["ctc"][:-1])
    assert LAUNCHES["K1.warp_jtj_apply"] == n
    x, ur, cons, mask, params, t, g = _warp_slabs(dev)
    n = LAUNCHES["K15.warp_slab_apply"]
    with pytest.raises(ValueError, match="warp_slab_apply"):
        sc.warp_slab_apply(x, ur, cons, mask, params, t["sq"], t["p"],
                           (g[0], 1, g[2], g[3]))
    with pytest.raises(ValueError, match="warp_slab_apply"):
        sc.warp_slab_apply(x, ur, cons, mask, params, t["sq"][:, :-1],
                           t["p"], g)
    assert LAUNCHES["K15.warp_slab_apply"] == n


class _ZeroWidthLibrary:
    """The kernel library with K1's and K15's C entries handed a width of
    0: an empty grid, which CUDA refuses to launch."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name == "opt_warp_jtj_apply":
            return lambda *a: fn(*a[:10], 0, a[11])
        if name == "opt_warp_slab_apply":
            return lambda *a: fn(*a[:11], 0, *a[12:])
        return fn


def test_warp_march_launch_failure_raises_through_solve(dev, monkeypatch):
    """K1 (the cuda engine's LM: its GN runs K13) and K15 (a solve over a
    mesh of slabs) refused their launch raise out of Plan.solve with CUDA's
    error: no engine catches it and carries on, and no launch is
    counted."""
    from opt_tpu_torch.ops import build, slab_cuda as sc
    from opt_tpu_torch.parallel.mesh import make_mesh

    lib = build.library()
    monkeypatch.setattr(build, "library", lambda: _ZeroWidthLibrary(lib))
    inputs = chip_smoke.warp_inputs(64, 48, seed=6)
    lm = _mesh_plan("image_warping", "LMGPU", (64, 48), 1, 2)
    n = LAUNCHES["K1.warp_jtj_apply"]
    with pytest.raises(RuntimeError, match="warp_jtj_apply: CUDA error"):
        lm.solve(inputs, engine="cuda")
    assert lm.engine == "cuda"
    assert LAUNCHES["K1.warp_jtj_apply"] == n
    plan = _mesh_plan("image_warping", "gaussNewtonGPU", (64, 48), 1, 2)
    n = LAUNCHES["K15.warp_slab_apply"]
    with pytest.raises(RuntimeError, match="warp_slab_apply: CUDA error"):
        plan.solve(inputs, engine="stream", mesh=make_mesh(4, device="cuda"))
    assert LAUNCHES["K15.warp_slab_apply"] == n
    torch.cuda.synchronize()


@pytest.mark.parametrize("W,H", [(37, 23), (2048, 2048)])
def test_gather_form_kernels_repeat_bit_for_bit(dev, W, H):
    """K4 (GN and LM) and K5 (GN and LM) keep warp_energy.cuh's gather
    form, and K13 its loop's fixed-tree partials: two calls on the same
    operands match bit for bit."""
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed=12)
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    for scs in (None, t["scs"]):
        args = (x, ur, cons, mask, params, t["sq"], scs, t["r"], t["p"],
                beta)
        a, b = stream_cuda.warp_hat_apply(*args), stream_cuda.warp_hat_apply(
            *args)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        b_hat = None if scs is None else t["b"]
        sweeps = [chip_smoke.sweep_case(
            torch, stream_cuda.warp_pipelined_sweep,
            (x, ur, cons, mask, params, t["sq"], scs), t, alpha, beta,
            b_hat)() for _ in range(2)]
        for u, v in zip(*sweeps):
            assert (u is None and v is None) or torch.equal(u, v)
    if W * H <= 37 * 23:
        hat, sq, b_hat = chip_smoke.resident_operands(torch, "warp", W, H,
                                                      dev)
        assert torch.equal(stream_cuda.resident_pcg(hat, sq, b_hat, 20),
                           stream_cuda.resident_pcg(hat, sq, b_hat, 20))


def test_vol_slab_kernels_match_plain(dev):
    from opt_tpu_torch.ops import slab_cuda as sc

    x, ur, cons, params, t, g = chip_smoke.vol_slab_operands(
        torch, 37, 23, 3 * SLABS, SLABS, dev, seed=9)
    for s in (None, 0, 1, 2):
        (xs, urs, cs, sq, p, d), gs = (
            ((x, ur, cons, t["sq"], t["p"], t["delta"]), g) if s is None
            else _alone((x, ur, cons, t["sq"], t["p"], t["delta"]), s, g))
        n0 = LAUNCHES["K16.vol_slab_apply"]
        _close([sc.vol_slab_apply(xs, urs, cs, params, sq, p, gs)],
               [sc.vol_slab_apply_plain(xs, urs, cs, params, sq, p, gs)])
        assert LAUNCHES["K16.vol_slab_apply"] == n0 + 1
        for kw in ({}, {"cost_only": True}, {"delta": d}):
            _close(sc.vol_slab_linearize(xs, urs, cs, params, gs, **kw),
                   sc.vol_slab_linearize_plain(xs, urs, cs, params, gs,
                                               **kw))


def test_one_slab_past_both_edges_is_the_whole_grid(dev):
    """One slab whose halo lies past both global edges: K3's offset mode
    gives the whole-grid K3 bit for bit (one kernel, the global bounds
    doing what the array bounds do on a whole grid), and K15 K4's A_hat p
    (two kernels, compiled apart: to their rounding).  K1, K4, K5 and K13
    keep offset 0: the tests above hold them unchanged."""
    from opt_tpu_torch.ops import slab_cuda as sc

    W, H = 37, 23
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(torch, W, H,
                                                              dev, seed=8)
    pad = lambda a: torch.nn.functional.pad(
        a.view(H, W, -1), (0, 0, 0, 0, 2, 2)).unsqueeze(0).contiguous()
    flat = lambda v: torch.cat([pad(v[:2 * H * W]).reshape(1, -1),
                                pad(v[2 * H * W:]).reshape(1, -1)], dim=1)
    g = (H, 2, -2, H)
    slab = (flat(x), pad(ur), pad(cons), pad(mask), params)
    for kw in ({}, {"cost_only": True}, {"delta": t["delta"]}):
        want = warp_cuda.warp_linearize(x, ur, cons, mask, params, **kw)
        if "delta" in kw:
            kw = {"delta": flat(kw["delta"])}
        got = sc.warp_slab_linearize(*slab, g, **kw)
        assert float(got[2][0]) == pytest.approx(float(want[2]), rel=1e-6)
        for a, b in zip(got[:2], want[:2]):
            assert (a is None and b is None) or torch.equal(a, b)
    ap = sc.warp_slab_apply(*slab, flat(t["sq"]), flat(t["p"]), g)
    want = stream_cuda.warp_hat_apply(x, ur, cons, mask, params, t["sq"],
                                      None, t["p"])[1]
    _close([ap], [want])


def _mesh_plan(energy, kind, dims, n_outer=3, n_linear=30):
    import opt_tpu_torch
    from opt_tpu_torch import energies

    st = opt_tpu_torch.NewState(device="cuda")
    plan = st.problem_plan(st.problem_define(getattr(energies, energy),
                                             kind), list(dims))
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_sharded_engines_agree_on_the_card(dev, kind):
    """Plan.solve(mesh=make_mesh(4)) on the card against the single-card
    engines (2e-5 for 2-D, 5e-4 for volumes), repeated solves bit for bit,
    and the unknowns back in the global layout."""
    from opt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, device="cuda")
    plan = _mesh_plan("image_warping", kind, (96, 64))
    inputs = chip_smoke.warp_inputs(96, 64, seed=6)
    inputs["Mask"][15, 30] = inputs["Mask"][16, 31] = 1.0  # a slab edge
    cost = plan.solve(inputs, engine="stream", mesh=mesh)
    x = plan.unknowns()
    assert plan.solve(inputs, engine="stream", mesh=mesh) == cost
    want = plan.solve(inputs, engine="stream")
    assert np.isfinite(cost) and cost == pytest.approx(want, rel=2e-5)
    # the sums' other order moves the unknowns: GN's pipelined loop parted
    # them by up to 6.4e-4 (of 5.2) here on the CPU's plain path
    for n, v in plan.unknowns().items():
        np.testing.assert_allclose(x[n], v, rtol=1e-3, atol=1e-3)
    inputs = chip_smoke.volume_inputs(12)
    vol = _vol_plan(kind, (12, 12, 12))
    cost = vol.solve(inputs, engine="stream3d", mesh=mesh)
    assert vol.solve(inputs, engine="stream3d", mesh=mesh) == cost
    assert cost == pytest.approx(vol.solve(inputs, engine="stream3d"),
                                 rel=5e-4)
    halo = plan.solve(chip_smoke.warp_inputs(96, 64, seed=6), engine="halo",
                      mesh=mesh)
    assert np.isfinite(halo)


# K3 and K8 on the tile cores (the linearize marches of csrc/warp_kernels.cu
# and csrc/vol_kernels.cu): each mode, the whole grid at 37x23(x11) and
# three slabs of one own row or plane, against the plain versions, and
# twice, bit for bit
LINEARIZE_MODES = ["full", "cost_only", "model_cost"]


def _mode_kw(mode, delta):
    return {"full": {}, "cost_only": {"cost_only": True},
            "model_cost": {"delta": delta}}[mode]


def _same(a, b):
    return all((u is None and v is None) or torch.equal(u, v)
               for u, v in zip(a, b))


def _linearize_case(dev, kernel, layout, mode):
    """(kernel call, plain call) of K3 or K8 in `mode` on the whole grid or
    on 3 slabs of one own row or plane (halo 2)."""
    from opt_tpu_torch.ops import slab_cuda as sc

    if kernel == "K3" and layout == "whole":
        x, ur, cons, mask, params, t = _march_operands(37, 23, dev, seed=21)
        cons[0, -1, 1] = -0.5
        args = (x, ur, cons, mask, params)
        kw = _mode_kw(mode, t["delta"])
        return (lambda: warp_cuda.warp_linearize(*args, **kw),
                lambda: warp_cuda.warp_linearize_plain(*args, **kw))
    if kernel == "K3":
        x, ur, cons, mask, params, t, g = chip_smoke.slab_operands(
            torch, 37, 3, 3, dev, seed=22)
        args = (x, ur, cons, mask, params, g)
        kw = _mode_kw(mode, t["delta"])
        return (lambda: sc.warp_slab_linearize(*args, **kw),
                lambda: sc.warp_slab_linearize_plain(*args, **kw))
    if layout == "whole":
        x, ur, cons, params, t = chip_smoke.volume_kernel_operands(
            torch, *chip_smoke.SMALL_VOL, dev, seed=23)
        args = (x, ur, cons, params)
        kw = _mode_kw(mode, t["delta"])
        return (lambda: vol_cuda.vol_linearize(*args, **kw),
                lambda: vol_cuda.vol_linearize_plain(*args, **kw))
    x, ur, cons, params, t, g = chip_smoke.vol_slab_operands(
        torch, 37, 23, 3, 3, dev, seed=24)
    args = (x, ur, cons, params, g)
    kw = _mode_kw(mode, t["delta"])
    return (lambda: sc.vol_slab_linearize(*args, **kw),
            lambda: sc.vol_slab_linearize_plain(*args, **kw))


@pytest.mark.parametrize("mode", LINEARIZE_MODES)
@pytest.mark.parametrize("layout", ["whole", "slabs"])
@pytest.mark.parametrize("kernel", ["K3", "K8"])
def test_linearize_tile_cores_match_plain_and_repeat(dev, kernel, layout,
                                                     mode):
    kern, plain = _linearize_case(dev, kernel, layout, mode)
    counted = {("K3", "whole"): "K3.warp_linearize",
               ("K3", "slabs"): "K3.warp_slab_linearize",
               ("K8", "whole"): "K8.vol_linearize",
               ("K8", "slabs"): "K8.vol_slab_linearize"}[kernel, layout]
    n = LAUNCHES[counted]
    got = kern()
    assert LAUNCHES[counted] == n + 1
    _close(got, plain())
    assert _same(got, kern())


def test_linearize_blocks_give_every_partial(dev):
    """The cost partials the wrappers allocate are the *_linearize_blocks
    exports' counts, and each launch writes every one of them (NaN
    before), at the paths' sizes and a ragged one, in each mode."""
    from opt_tpu_torch.ops import build

    lib = build.library()
    ptr = build.ptr
    for W, H in ((37, 23), (chip_smoke.BIG, chip_smoke.BIG)):
        x, ur, cons, mask, params, t = chip_smoke.kernel_operands(
            torch, W, H, dev, seed=25)
        for mode in range(3):
            n = lib.opt_warp_linearize_blocks(1, H, W, mode)
            assert n > 0
            parts = torch.full((n,), float("nan"), device=dev)
            out = [torch.empty_like(x) if mode == 0 else None
                   for _ in range(2)]
            build.check(lib.opt_warp_linearize(
                ptr(x), ptr(ur), ptr(cons), ptr(mask), ptr(params),
                ptr(t["delta"] if mode == 2 else None), ptr(out[0]),
                ptr(out[1]), ptr(parts), H, W, mode, build.stream()),
                "warp_linearize")
            assert not torch.isnan(parts).any()
            kw = _mode_kw(LINEARIZE_MODES[mode], t["delta"])
            assert float(torch.sum(parts)) == float(warp_cuda.warp_linearize(
                x, ur, cons, mask, params, **kw)[2])
    for dims in (chip_smoke.SMALL_VOL, (chip_smoke.VOL,) * 3):
        x, ur, cons, params, t = chip_smoke.volume_kernel_operands(
            torch, *dims, dev, seed=26)
        D, H, W = ur.shape[:3]
        for mode in range(3):
            n = lib.opt_vol_linearize_blocks(1, D, H, W, mode)
            assert n > 0
            parts = torch.full((n,), float("nan"), device=dev)
            out = [torch.empty_like(x) if mode == 0 else None
                   for _ in range(2)]
            build.check(lib.opt_vol_linearize(
                ptr(x), ptr(ur), ptr(cons), ptr(params),
                ptr(t["delta"] if mode == 2 else None), ptr(out[0]),
                ptr(out[1]), ptr(parts), D, H, W, mode, build.stream()),
                "vol_linearize")
            assert not torch.isnan(parts).any()
            kw = _mode_kw(LINEARIZE_MODES[mode], t["delta"])
            assert float(torch.sum(parts)) == float(vol_cuda.vol_linearize(
                x, ur, cons, params, **kw)[2])
    # slabs: the partials come slab by slab, as many as the export says
    x, ur, cons, mask, params, t, g = chip_smoke.slab_operands(
        torch, 37, 21, 3, dev, seed=27)
    S, (n, he, row0, total) = 3, g
    for mode in range(3):
        parts = torch.full((lib.opt_warp_linearize_blocks(S, n, 37, mode),),
                           float("nan"), device=dev)
        out = [x.new_empty(3 * S * n * 37) if mode == 0 else None
               for _ in range(2)]
        build.check(lib.opt_warp_slab_linearize(
            ptr(x), ptr(ur), ptr(cons), ptr(mask), ptr(params),
            ptr(t["delta"] if mode == 2 else None), ptr(out[0]), ptr(out[1]),
            ptr(parts), S, n, he, 37, row0, total, mode, build.stream()),
            "warp_slab_linearize")
        assert not torch.isnan(parts).any() and parts.numel() % S == 0


def test_linearize_refuses_an_empty_grid(dev):
    """K3 and K8 at W = 0 or H = 0 (or D = 0): the launch is refused (an
    empty grid), the wrapper raises CUDA's error and counts no launch; the
    chunk rules divide by no zero on the way."""
    from opt_tpu_torch.ops import build

    lib = build.library()
    params = torch.tensor([0.5, 1.0], device=dev)
    for W, H in ((0, 5), (5, 0)):
        for mode in range(3):
            assert lib.opt_warp_linearize_blocks(1, H, W, mode) == 0
            assert lib.opt_vol_linearize_blocks(1, 3, H, W, mode) == 0
        x = torch.zeros(3 * H * W, device=dev)
        ur = torch.zeros(H, W, 2, device=dev)
        mask = torch.zeros(H, W, 1, device=dev)
        n = LAUNCHES["K3.warp_linearize"]
        for kw in ({}, {"cost_only": True}, {"delta": x}):
            with pytest.raises(RuntimeError,
                               match="warp_linearize: CUDA error"):
                warp_cuda.warp_linearize(x, ur, ur, mask, params, **kw)
        assert LAUNCHES["K3.warp_linearize"] == n
        xv = torch.zeros(6 * 3 * H * W, device=dev)
        urv = torch.zeros(3, H, W, 3, device=dev)
        n = LAUNCHES["K8.vol_linearize"]
        for kw in ({}, {"cost_only": True}, {"delta": xv}):
            with pytest.raises(RuntimeError,
                               match="vol_linearize: CUDA error"):
                vol_cuda.vol_linearize(xv, urv, urv, params, **kw)
        assert LAUNCHES["K8.vol_linearize"] == n
    xv = torch.zeros(0, device=dev)
    urv = torch.zeros(0, 4, 4, 3, device=dev)
    with pytest.raises(RuntimeError, match="vol_linearize: CUDA error"):
        vol_cuda.vol_linearize(xv, urv, urv, params, cost_only=True)
    torch.cuda.synchronize()
