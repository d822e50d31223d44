"""The port's sharded streamed engines (opt_tpu_torch/parallel/
stream_shard.py) on the CPU, through the plain versions of their kernels
(ops/slab_cuda.py), against the JAX package's (opt_tpu/parallel/
stream_shard.py) on its 8-device CPU mesh, inside the JAX gates (W a
multiple of 128, 2-D slabs of a multiple of 8 rows):

* K15's plain version against ShardedStreamEngine.build_apply_kernel in
  interpret mode, and K16's against ShardedStream3D's, on every slab of a
  4-slab batch (the first, two interior, the last), each with its own
  global row offset, rtol 1e-5;
* K3's and K8's offset modes against the plain evaluator on the same
  extended slabs (parallel/halo.py), and their per-slab costs summed
  against the whole grid's, rtol 1e-5;
* Plan.solve(mesh=make_mesh(4)) with "stream" -- pipelined and classic
  GN, and LM long enough to reset its residual -- against
  solve_sharded_stream on 4 devices (rtol 1e-5) and the port's
  single-card "stream" engine (2e-5); "stream3d" GN and LM against
  solve_sharded_stream3d (5e-4).

One outer step of four PCG iterations; each JAX reference is solved once
per module."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.parallel import stream_shard as jss
from opt_tpu_torch import energies
from opt_tpu_torch.ops import slab_cuda, vol_cuda, warp_cuda
from opt_tpu_torch.parallel.halo import HaloOperator, ShardedGridFuncs
from opt_tpu_torch.parallel.mesh import SlabLayout, make_mesh, shard_problem
from opt_tpu_torch.parallel.stream_shard import (ShardedStream3D,
                                                 ShardedStreamEngine)
from tests.test_halo_shard import _vol_inputs, _warp_inputs
from tests.test_torch_evaluate import assert_close

torch.set_num_threads(1)

N = 4  # slabs and devices
W2, H2 = 128, 32  # 2-D: 4 slabs of 8 rows
W3, H3, D3 = 128, 8, 8  # 3-D: 4 slabs of 2 planes
WARP = (jax_energies.image_warping, energies.image_warping)
VOL = (jax_energies.volumetric_mesh_deformation,
       energies.volumetric_mesh_deformation)


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:N]), ("shard",))


def _plans(energy, dims, kind="gaussNewtonGPU", n=1, l=4, period=None):
    js = opt_tpu.NewState()
    jplan = js.problem_plan(js.problem_define(energy[0], kind), dims)
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(energy[1], kind), dims)
    for plan in (jplan, tplan):
        plan.set_solver_parameter("nIterations", n)
        plan.set_solver_parameter("lIterations", l)
        if period:
            plan.set_solver_parameter("residual_reset_period", period)
    return jplan, tplan


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K15 and K16 against the TPU kernels in interpret mode
# ---------------------------------------------------------------------------


def _jax_apply(kern, ins, p, params, row0, pad):
    """One slab through a JAX apply kernel: the planes padded by its window
    halo, its output's own rows."""
    ins = jnp.pad(jnp.asarray(ins), pad)
    p = jnp.pad(jnp.asarray(p), pad)
    row0 = jnp.asarray([[row0]], jnp.int32)
    return np.asarray(kern(ins, p, jnp.asarray(params).reshape(-1, 1),
                           row0))


def test_warp_slab_apply_matches_the_tpu_kernel():
    jplan, _ = _plans(WARP, [W2, H2])
    eng = jss.ShardedStreamEngine(jplan, _mesh())
    kern = jax.jit(eng.build_apply_kernel(interpret=True))
    n, he, h = eng.n_local, eng.he, eng.h
    rows = n + 2 * he  # the JAX engine's halo (8, its sublane rule)
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(N, rows, W2, *s).astype(np.float32)
    off, ang, ur = 0.3 * f(2), 0.4 * f(1), f(2)
    cons = np.where(rng.rand(N, rows, W2, 2) < 0.3, f(2), -1.0)
    mask = (rng.rand(N, rows, W2, 1) < 0.05).astype(np.float32)
    sq = np.where(mask == 0, rng.rand(N, rows, W2, 3), 0).astype(np.float32)
    p = f(3)
    params = np.array([0.7, 1.3], np.float32)
    g = (n, he, -he, H2)
    flat = lambda o, a: _t(np.concatenate(
        [o.reshape(N, -1), a.reshape(N, -1)], 1))
    got = slab_cuda.warp_slab_apply_plain(
        flat(off, ang), _t(ur), _t(cons), _t(mask), _t(params),
        flat(sq[..., :2], sq[..., 2:]), flat(p[..., :2], p[..., 2:]), g)
    got_o = got[:2 * N * n * W2].view(N, n, W2, 2).numpy()
    got_a = got[2 * N * n * W2:].view(N, n, W2).numpy()
    pad = ((0, 0), (h, h), (0, 0))
    for s in range(N):  # the first, two interior and the last slab
        # JAX's planes: unknowns, constants, sq, each in name order
        ins = np.stack([ang[s, ..., 0], off[s, ..., 0], off[s, ..., 1],
                        cons[s, ..., 0], cons[s, ..., 1], mask[s, ..., 0],
                        ur[s, ..., 0], ur[s, ..., 1], sq[s, ..., 2],
                        sq[s, ..., 0], sq[s, ..., 1]])
        pp = np.stack([p[s, ..., 2], p[s, ..., 0], p[s, ..., 1]])
        out = _jax_apply(kern, ins, pp, params, s * n - he, pad)
        own = slice(he, he + n)
        want_o = np.stack([out[1, own], out[2, own]], -1)
        assert_close(got_o[s], want_o, 1e-5, f"slab {s} Offset")
        assert_close(got_a[s], out[0, own], 1e-5, f"slab {s} Angle")


def test_vol_slab_apply_matches_the_tpu_kernel():
    jplan, _ = _plans(VOL, [W3, H3, D3])
    eng = jss.ShardedStream3D(jplan, _mesh())
    kern = jax.jit(eng.build_apply_kernel(interpret=True))
    n, he, h_d, h_h = eng.n_local, eng.he, eng.h_d, eng.h_h
    planes = n + 2 * he
    rng = np.random.RandomState(4)
    f = lambda: rng.randn(N, planes, H3, W3, 3).astype(np.float32)
    off, ang, ur = 0.3 * f(), 0.4 * f(), f()
    cons = np.where(rng.rand(N, planes, H3, W3, 1) < 0.3, f(), -1e7
                    ).astype(np.float32)
    sq, p = np.abs(f()), f()
    params = np.array([0.7, 1.3], np.float32)
    g = (n, he, -he, D3)
    flat = lambda o, a: _t(np.concatenate(
        [o.reshape(N, -1), a.reshape(N, -1)], 1))
    got = slab_cuda.vol_slab_apply_plain(
        flat(off, ang), _t(ur), _t(cons), _t(params), flat(sq, sq),
        flat(p, 2 * p), g)
    got = got.view(2, N, n, H3, W3, 3).numpy()
    pad = ((0, 0), (h_d, h_d), (h_h, h_h), (0, 0))
    chan = lambda a, s: [a[s, ..., c] for c in range(3)]
    for s in range(N):
        ins = np.stack(chan(ang, s) + chan(off, s) + chan(cons, s)
                       + chan(ur, s) + chan(sq, s) + chan(sq, s))
        pp = np.stack(chan(2 * p, s) + chan(p, s))
        out = _jax_apply(kern, ins, pp, params, s * n - he, pad)
        own = slice(he, he + n)
        assert_close(got[0, s], np.stack(
            [out[3 + c, own] for c in range(3)], -1), 1e-5, f"slab {s} O")
        assert_close(got[1, s], np.stack(
            [out[c, own] for c in range(3)], -1), 1e-5, f"slab {s} A")


# ---------------------------------------------------------------------------
# K3 and K8's offset modes against the plain evaluator
# ---------------------------------------------------------------------------


def _bound(tplan, inputs, engine):
    mesh = make_mesh(N, device="cpu")
    layout = SlabLayout(tplan.funcs.unknown_shapes, mesh)
    x, data = tplan.bind(inputs)
    sharded = shard_problem(mesh, data)
    halo = HaloOperator(ShardedGridFuncs(tplan, mesh), sharded, layout)
    return halo, engine(tplan, sharded, layout), layout.shard(
        x, tplan.layout), layout


@pytest.mark.parametrize("vol", [False, True])
def test_offset_modes_match_the_evaluator(vol):
    if vol:
        inputs = _vol_inputs(16, 8, 8)
        rng = np.random.RandomState(6)
        inputs["Angle"] = 0.2 * rng.randn(8, 8, 16, 3).astype(np.float32)
        _, tplan = _plans(VOL, [16, 8, 8])
        engine, whole = ShardedStream3D, vol_cuda.vol_linearize_plain
    else:
        inputs = _warp_inputs(32, 16)
        rng = np.random.RandomState(6)
        inputs["Offset"] = 0.2 * rng.randn(16, 32, 2).astype(np.float32)
        inputs["Angle"] = 0.3 * rng.randn(16, 32, 1).astype(np.float32)
        inputs["Mask"][3, 9] = inputs["Mask"][4, 2] = 1.0
        _, tplan = _plans(WARP, [32, 16])
        engine, whole = ShardedStreamEngine, warp_cuda.warp_linearize_plain
    halo, op, xl, layout = _bound(tplan, inputs, engine)
    assert op.he == halo.funcs.halo == 2
    # per slab: the cost of the residuals centred on its own rows
    assert_close(op._linearize(op._slabs(xl), cost_only=True)[2].numpy(),
                 halo.funcs.cost(halo._ext(xl), halo.data_ext).numpy(),
                 1e-5, "per-slab cost")
    for name, got, want in zip(("J^T F", "diag"), op.outer(xl),
                               halo.outer(xl)):
        assert_close(got.numpy(), want.numpy(), 1e-5, name)
    # LM's model cost: the slabs' costs add up to the whole grid's
    delta = torch.as_tensor(0.1 * rng.randn(xl.numel()).astype(np.float32))
    x, data = tplan.bind(inputs)
    consts = ((data["images"]["UrShape"], data["images"]["Constraints"])
              + (() if vol else (data["images"]["Mask"],)))
    params = torch.stack((data["params"]["w_fitSqrt"],
                          data["params"]["w_regSqrt"]))
    want = whole(x, *consts, params, delta=delta)[2]
    assert float(op.model_cost(delta)) == pytest.approx(float(want),
                                                        rel=1e-5)


# ---------------------------------------------------------------------------
# whole solves through Plan.solve(mesh=)
# ---------------------------------------------------------------------------

STREAM_CASES = {"pipelined": ("gaussNewtonGPU", None),
                "classic": ("gaussNewtonGPU", None),
                "lm": ("LMGPU", 2)}  # resets at PCG iterations 2 and 4


@pytest.fixture(scope="module", params=sorted(STREAM_CASES))
def sharded_stream(request):
    """solve_sharded_stream's cost and unknowns, once per case."""
    kind, period = STREAM_CASES[request.param]
    variant = "classic" if request.param == "lm" else request.param
    inputs = _warp_inputs(W2, H2)
    inputs["Mask"][7, 40] = inputs["Mask"][8, 41] = 1.0  # at a slab edge
    jplan, _ = _plans(WARP, [W2, H2], kind, period=period)
    cost = jss.solve_sharded_stream(jplan, inputs, _mesh(), variant=variant)
    x = {k: np.asarray(v) for k, v in jplan._state["x"].items()}
    return request.param, variant, inputs, cost, x


def test_stream_on_a_mesh_matches_jax_and_the_single_card_engine(
        sharded_stream):
    case, variant, inputs, want, want_x = sharded_stream
    kind, period = STREAM_CASES[case]
    _, tplan = _plans(WARP, [W2, H2], kind, period=period)
    tplan.stream_variant = variant
    cost = tplan.solve(inputs, engine="stream",
                       mesh=make_mesh(N, device="cpu"))
    assert (tplan.engine, tplan.variant) == ("stream", variant)
    assert cost == pytest.approx(want, rel=1e-5)
    for n, v in tplan.unknowns().items():
        assert_close(v, want_x[n], 1e-4, n)
    _, single = _plans(WARP, [W2, H2], kind, period=period)
    single.stream_variant = variant
    assert cost == pytest.approx(single.solve(inputs, engine="stream"),
                                 rel=2e-5)


@pytest.mark.parametrize("kind,variant", [
    pytest.param("gaussNewtonGPU", "classic", id="gaussNewtonGPU"),
    pytest.param("LMGPU", "classic", id="LMGPU"),
    pytest.param("gaussNewtonGPU", "pipelined",
                 id="gaussNewtonGPU-pipelined")])
def test_stream3d_on_a_mesh_matches_jax(kind, variant):
    """Each 3-D slab loop against the JAX package's same loop: GN's
    classic (the default) and pipelined, and LM's, which is classic in
    both packages whatever variant= says."""
    inputs = _vol_inputs(W3, H3, D3)
    jplan, tplan = _plans(VOL, [W3, H3, D3], kind, l=3)
    want = jss.solve_sharded_stream3d(jplan, inputs, _mesh(),
                                      variant=variant)
    tplan.stream_variant = variant
    cost = tplan.solve(inputs, engine="stream3d",
                       mesh=make_mesh(N, device="cpu"))
    assert (tplan.engine, tplan.variant) == ("stream3d", variant)
    assert cost == pytest.approx(want, rel=5e-4)


@pytest.mark.parametrize("engine,variant,its,rtol", [
    ("stream", "classic", 101, 2e-5), ("stream3d", "classic", 3, 5e-4)])
def test_gn_on_a_mesh_takes_the_single_card_variant(engine, variant, its,
                                                    rtol):
    """GN over a mesh picks its PCG loop as the single-card engine does
    (stream_cuda.pick_variant: classic on grids at any iteration count and
    on volumes, where it was 27% faster than pipelined over 4 slabs on an
    H100 as on one card; PERF.md) and ends where that engine does, at the
    tolerances above."""
    vol = engine == "stream3d"
    dims = [W3, H3, D3] if vol else [W2, H2]
    inputs = _vol_inputs(*dims) if vol else _warp_inputs(*dims)
    _, tplan = _plans(VOL if vol else WARP, dims, l=its)
    cost = tplan.solve(inputs, engine=engine,
                       mesh=make_mesh(N, device="cpu"))
    assert (tplan.engine, tplan.variant) == (engine, variant)
    _, single = _plans(VOL if vol else WARP, dims, l=its)
    assert cost == pytest.approx(single.solve(inputs, engine=engine),
                                 rel=rtol)
    assert single.variant == variant
