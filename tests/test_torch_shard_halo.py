"""The port's explicit halo path (opt_tpu_torch/parallel/halo.py) against
the JAX package's (opt_tpu/parallel/halo.py) on its 8-device CPU mesh:
the evaluator at global coordinates, ShardedGridFuncs' per-slab cost,
J^T F and diag against the JAX pieces run under shard_map on 4 devices,
and the "halo" engine through Plan.solve(mesh=) against
solve_sharded_halo on 2 (image_warping LM, poisson with Exclude), all at
rtol 1e-5, one outer step of five PCG iterations; and the halo path's
reverse-over-reverse J p against the plain engine's traced one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from opt_tpu.compile import evaluate as jev
from opt_tpu.compile.plan_fns import ProblemFunctions as JaxFuncs
from opt_tpu.dsl.env import EnergyEnv as JaxEnv
from opt_tpu.dsl.spec import ProblemSpec as JaxSpec
from opt_tpu.parallel import halo as jhalo
from opt_tpu.runtime.api import _run_energy as jax_run_energy
from opt_tpu_torch.compile import evaluate as tev
from opt_tpu_torch.compile.plan_fns import _traced_linearize
from opt_tpu_torch.parallel.halo import (HaloOperator, ShardedGridFuncs,
                                         _linearize)
from opt_tpu_torch.parallel.mesh import SlabLayout, make_mesh, shard_problem
from tests.test_halo_shard import _poisson_inputs, _warp_inputs
from tests.test_torch_evaluate import assert_close
from tests.test_torch_lm import make_plans

torch.set_num_threads(1)

RTOL = 1e-5


def _jax_mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shard",))


@pytest.mark.parametrize("offset", [(-2, 0), (6, 0), (14, 3)])
def test_bounds_index_and_domain_at_global_positions(offset):
    shape, glob = (8, 5), (16, 7)
    cpu = torch.device("cpu")
    for mins, maxs in (((0, -1), (0, 0)), ((-1, 0), (0, 1)),
                       ((1, -2), (2, 1))):
        np.testing.assert_array_equal(
            tev.bounds_mask(shape, mins, maxs, cpu, glob, offset).numpy(),
            np.asarray(jev.bounds_mask(shape, mins, maxs, real_shape=glob,
                                       coord_offset=offset)))
    for dim in (0, 1):
        np.testing.assert_array_equal(
            tev.index_coords(shape, dim, 0.5, torch.float32, cpu,
                             offset).numpy().squeeze(),
            np.asarray(jev.index_coords(shape, dim, 0.5, jnp.float32,
                                        offset)).squeeze())
    got = tev.real_domain_mask(shape, glob, offset, cpu)
    want = np.asarray(jev.real_domain_mask(shape, glob, offset))
    np.testing.assert_array_equal(
        np.ones(shape, bool) if got is None else got.numpy(), want)


def _inputs(energy, W, H):
    if energy == "poisson_image_editing":
        return _poisson_inputs(W, H)
    inputs = _warp_inputs(W, H)
    rng = np.random.RandomState(5)
    inputs["Offset"] = 0.2 * rng.randn(H, W, 2).astype(np.float32)
    inputs["Angle"] = 0.3 * rng.randn(H, W, 1).astype(np.float32)
    inputs["Mask"][3, 7] = inputs["Mask"][4, 20] = 1.0  # at a slab edge
    return inputs


def _jax_pieces(jplan, inputs, n):
    """Per-device cost, and J^T F and diag in the global layout, from the
    JAX package's ShardedGridFuncs (built as make_halo_solver builds it)
    under shard_map on n devices."""
    dims = list(jplan.dims)
    n_local = dims[-1] // n
    halo = 2 * jhalo.stencil_radius(jplan.spec, len(dims) - 1)
    dims[-1] = n_local + 2 * halo
    spec = JaxSpec()
    jax_run_energy(jplan.problem.energy, JaxEnv(spec, dims))
    base = JaxFuncs(spec, jplan.funcs.dtype, real_shapes={
        im.ispace.key(): im.ispace.shape
        for im in jplan.spec.images.values()})
    sharded = jhalo.ShardedGridFuncs(base, halo, n_local, "shard", n)
    x, data = jplan.bind(inputs, graph_mode="take")
    data = {"images": data["images"], "params": data["params"],
            "graph_indices": {}}

    def body(x, data):
        sharded.set_offsets()
        r0, _, jt = sharded.linearize(x, data)
        return (sharded.cost(x, data).reshape(1), sharded.jtf(r0, jt),
                sharded.diag_jtj(x, data))

    img = P("shard", None, None)
    xs = {k: img for k in x}
    fn = jhalo.shard_map(
        body, _jax_mesh(n),
        ({k: img for k in x},
         {"images": {k: img for k in data["images"]},
          "params": {k: P() for k in data["params"]}, "graph_indices": {}}),
        (P("shard"), xs, xs))
    cost, jtf, diag = jax.jit(fn)(x, data)
    return (np.asarray(cost), {k: np.asarray(v) for k, v in jtf.items()},
            {k: np.asarray(v) for k, v in diag.items()})


@pytest.mark.parametrize("energy", ["image_warping",
                                    "poisson_image_editing"])
def test_reverse_over_reverse_jp_is_the_traced_jp(energy):
    """The halo path's J p (the vjp of J^T's vjp) equals the plain
    engine's traced J p (torch.func.linearize) bit for bit, and its J^T
    the vjp's."""
    inputs = _inputs(energy, 32, 16)
    _, tplan = make_plans(energy, "gaussNewtonGPU", 32, 16, 1, 1)
    x, data = tplan.bind(inputs)
    xv = tplan.layout.views(x)
    fn = lambda xx: tplan.funcs.residuals_solve(xx, data)
    r0, jt, jvp = _linearize(fn, xv)
    want_r0, want_jvp = _traced_linearize(fn, xv)
    _, want_vjp = torch.func.vjp(fn, xv)
    rng = np.random.RandomState(7)
    p = {n: torch.as_tensor(rng.randn(*v.shape).astype(np.float32))
         for n, v in xv.items()}
    for got, want in zip(jvp(p), want_jvp(p)):
        assert torch.equal(got, want)
    for n, got in jt(r0).items():
        assert torch.equal(got, want_vjp(want_r0)[0][n]), n


@pytest.mark.parametrize("energy,W,H", [("image_warping", 40, 16),
                                        ("poisson_image_editing", 32, 16)])
def test_sharded_grid_funcs_match_jax(energy, W, H):
    """Each slab's cost of its own rows, and J^T F and diag at its own rows
    (4 slabs of 4 rows, halo 2: the first, two interior, the last)."""
    inputs = _inputs(energy, W, H)
    jplan, tplan = make_plans(energy, "gaussNewtonGPU", W, H, 1, 1)
    cost, jtf, diag = _jax_pieces(jplan, inputs, 4)

    mesh = make_mesh(4, device="cpu")
    layout = SlabLayout(tplan.funcs.unknown_shapes, mesh)
    x, data = tplan.bind(inputs)
    funcs = ShardedGridFuncs(tplan, mesh)
    assert (funcs.halo, funcs.n_local) == (2, H // 4)
    op = HaloOperator(funcs, shard_problem(mesh, data), layout)
    xl = layout.shard(x, tplan.layout)
    assert_close(funcs.cost(op._ext(xl), op.data_ext).numpy(), cost, RTOL,
                 "per-slab cost")
    got_jtf, got_diag = op.outer(xl)
    for name, got, want in (("J^T F", got_jtf, jtf), ("diag", got_diag,
                                                      diag)):
        for n, v in tplan.layout.views(layout.gather(got)).items():
            assert_close(v.numpy(), want[n], RTOL, f"{name} {n}")


@pytest.mark.parametrize("energy,kind,W,H", [
    ("image_warping", "LMGPU", 40, 16),
    ("poisson_image_editing", "gaussNewtonGPU", 32, 16)])
def test_halo_engine_matches_solve_sharded_halo(energy, kind, W, H):
    inputs = _inputs(energy, W, H)
    jplan, tplan = make_plans(energy, kind, W, H, 1, 5)
    want = jhalo.solve_sharded_halo(jplan, inputs, _jax_mesh(2))
    got = tplan.solve(inputs, engine="halo", mesh=make_mesh(2, device="cpu"))
    assert tplan.engine == "halo"
    assert got == pytest.approx(want, rel=RTOL)
    for n, v in tplan.unknowns().items():
        assert_close(v, np.asarray(jplan._state["x"][n]), 1e-4, n)
