"""The slab mesh (opt_tpu_torch/parallel/mesh.py) and the sharded route
(parallel/dispatch.py) on the CPU: ext and psum of the slab form, the
local layout, pick_sharded_engine against the JAX package's on the plans
of tests/test_dispatch_mesh.py, the unknowns read back in the global
layout, and the rejections.  No solve here runs more than a few plain
PCG iterations on a small grid."""

import numpy as np
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.parallel import mesh as jmesh
from opt_tpu.parallel.dispatch import pick_sharded_engine as jax_pick
from opt_tpu_torch import energies
from opt_tpu_torch.parallel import dispatch
from opt_tpu_torch.parallel.mesh import SlabLayout, make_mesh
from opt_tpu_torch.solver.core import Layout
from tests.test_halo_shard import _mesh1d, _warp_inputs

torch.set_num_threads(1)


def test_ext_fills_neighbour_rows_and_zeros_past_the_edges():
    mesh = make_mesh(4, device="cpu")
    a = torch.arange(4 * 3 * 2, dtype=torch.float32).view(4, 3, 2) + 1
    e = mesh.ext(a, 2)
    assert e.shape == (4, 7, 2)
    for s in range(4):
        torch.testing.assert_close(e[s, 2:5], a[s])
        up = a[s - 1, 1:] if s > 0 else torch.zeros(2, 2)
        dn = a[s + 1, :2] if s < 3 else torch.zeros(2, 2)
        torch.testing.assert_close(e[s, :2], up)
        torch.testing.assert_close(e[s, 5:], dn)
    assert mesh.ext(a, 0) is a


def test_psum_sums_the_slabs_in_order():
    mesh = make_mesh(4, device="cpu")
    v = torch.tensor([1.0, 2.0, 3.0, 4.5])
    assert float(mesh.psum(v)) == 10.5
    assert mesh.psum(v).shape == ()


def test_a_2d_shape_is_flattened_row_major():
    mesh = make_mesh(shape=(2, 2), device="cpu")
    assert (mesh.n, mesh.S, mesh.first) == (4, 4, 0)
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(3, shape=(2, 2), device="cpu")


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


def test_local_layout_is_the_global_layout_in_the_slab_form():
    shapes = {"Offset": (8, 5, 2), "Angle": (8, 5, 1)}
    mesh = make_mesh(4, device="cpu")
    layout, whole = SlabLayout(shapes, mesh), Layout(shapes)
    x = torch.randn(8 * 5 * 3)
    torch.testing.assert_close(layout.shard(x, whole), x)
    torch.testing.assert_close(layout.gather(x), x)
    assert layout.views(x)["Angle"].shape == (4, 2, 5, 1)
    y = torch.randn_like(x)
    parts = layout.partials(x * y)
    assert parts.shape == (4,)
    torch.testing.assert_close(layout.dot(x, y), torch.dot(x, y))
    # slab s holds rows 2s, 2s + 1 of every unknown
    for s in range(4):
        want = sum(float((v[2 * s:2 * s + 2] * w[2 * s:2 * s + 2]).sum())
                   for v, w in zip(whole.views(x).values(),
                                   whole.views(y).values()))
        assert float(parts[s]) == pytest.approx(want, rel=1e-5)


def _plans(energy, dims, kind="gaussNewtonGPU"):
    """The JAX package's plan and the port's, the port's device named
    cuda: the route reads only the plan (as tests/test_torch_stream.py's
    route test does)."""
    js = opt_tpu.NewState()
    jplan = js.problem_plan(js.problem_define(energy[0], kind), dims)
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(energy[1], kind), dims)
    tplan.device = torch.device("cuda")
    return jplan, tplan


WARP = (jax_energies.image_warping, energies.image_warping)
VOL = (jax_energies.volumetric_mesh_deformation,
       energies.volumetric_mesh_deformation)
POISSON = (jax_energies.poisson_image_editing,
           energies.poisson_image_editing)
# the JAX package's sharded engines, as the port runs them: torch has no
# GSPMD, so "gspmd" is the explicit halo path
ROUTE_MAP = {"gspmd": "halo", "halo": "halo", "stream": "stream",
             "stream3d": "stream3d"}
# tests/test_dispatch_mesh.py's plans, on its 8-device mesh
ROUTE_CASES = [
    (WARP, [40, 48], "gaussNewtonGPU"),
    (WARP, [2048, 8 * 2048], "gaussNewtonGPU"),
    (WARP, [512, 8 * 512], "LMGPU"),
    (WARP, [512, 8 * 512], "gaussNewtonGPU"),
    (VOL, [128, 64, 8 * 32], "gaussNewtonGPU"),
    (VOL, [128, 16, 16], "gaussNewtonGPU"),
    (POISSON, [2048, 8 * 2048], "gaussNewtonGPU"),
]


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
@pytest.mark.parametrize("energy,dims,kind", ROUTE_CASES)
def test_auto_route_matches_jax(energy, dims, kind, shape):
    jplan, tplan = _plans(energy, dims, kind)
    jm = jmesh.make_mesh(8, shape=shape)
    want = ROUTE_MAP[jax_pick(jplan, jm)]
    if energy is POISSON and want == "stream":
        # the JAX streamed apply traces any energy; the port's holds one
        want = "halo"
    assert dispatch.pick_sharded_engine(
        tplan, make_mesh(shape=shape, device="cpu")) == want


def test_auto_route_where_the_port_differs():
    """The JAX gate wants slabs of a multiple of 8 rows (the TPU's
    sublanes) and sends 2049-row slabs to GSPMD; the port has no such
    rule.  A plan on the CPU never takes a kernel engine."""
    jplan, tplan = _plans(WARP, [2048, 8 * 2048 + 8])
    assert jax_pick(jplan, _mesh1d()) == "gspmd"
    mesh = make_mesh(8, device="cpu")
    assert dispatch.pick_sharded_engine(tplan, mesh) == "stream"
    tplan.device = torch.device("cpu")
    assert dispatch.pick_sharded_engine(tplan, mesh) == "halo"


def test_named_engines_and_aliases():
    _, tplan = _plans(WARP, [128, 64])
    mesh = make_mesh(8, device="cpu")
    pick = lambda e: dispatch.pick_sharded_engine(tplan, mesh, e)
    assert [pick(e) for e in ("gspmd", "xla", "torch", "halo")] == [
        "halo"] * 4
    assert pick("stream_hbm") == pick("stream") == "stream"
    for single in ("cuda", "vmem", "graph"):
        with pytest.raises(ValueError, match="runs on one device"):
            pick(single)
    with pytest.raises(ValueError, match="unknown sharded engine"):
        pick("warpspeed")


def _cpu_plan(energy, dims, kind="gaussNewtonGPU", n=1, l=3):
    state = opt_tpu_torch.NewState(device="cpu")
    plan = state.problem_plan(state.problem_define(energy, kind), dims)
    plan.set_solver_parameter("nIterations", n)
    plan.set_solver_parameter("lIterations", l)
    return plan


def test_rejections():
    mesh = make_mesh(4, device="cpu")
    graph = _cpu_plan(energies.arap_mesh_deformation, [64, 128])
    with pytest.raises(NotImplementedError, match="item 17"):
        graph.solve({}, mesh=mesh)
    flow = _cpu_plan(energies.optical_flow, [32, 16])
    with pytest.raises(NotImplementedError, match="SampledImage"):
        flow.solve({}, mesh=mesh)
    poisson = _cpu_plan(energies.poisson_image_editing, [32, 16])
    with pytest.raises(ValueError, match="holds only energies.image_warping"):
        poisson.solve({}, engine="stream", mesh=mesh)
    with pytest.raises(ValueError, match="holds only energies.volumetric"):
        poisson.solve({}, engine="stream3d", mesh=mesh)
    odd = _cpu_plan(energies.image_warping, [32, 18])
    inputs = _warp_inputs(32, 18)
    for engine in ("stream", "halo"):
        with pytest.raises(ValueError, match="divide"):
            odd.solve(inputs, engine=engine, mesh=mesh)
    thin = _cpu_plan(energies.image_warping, [32, 4])
    with pytest.raises(ValueError, match="thinner than the halo"):
        thin.solve(_warp_inputs(32, 4), engine="halo", mesh=mesh)
    with pytest.raises(ValueError, match="the mesh is on"):
        _cpu_plan(energies.image_warping, [32, 16]).solve(
            _warp_inputs(32, 16), mesh=make_mesh(4, device="meta"))


def test_unknowns_read_back_in_the_global_layout():
    """A sharded solve leaves the plan's state in the global layout: the
    unknowns, current_cost and a checkpoint are those of the whole grid,
    and a plain single-device solve resumes from that checkpoint."""
    inputs = _warp_inputs(32, 16)
    inputs["Mask"][9, 4] = 1.0
    plan = _cpu_plan(energies.image_warping, [32, 16], "LMGPU")
    cost = plan.solve(inputs, engine="stream", mesh=make_mesh(4,
                                                              device="cpu"))
    assert (plan.engine, plan.variant) == ("stream", "classic")
    x = plan.unknowns()
    assert x["Offset"].shape == (16, 32, 2) and x["Angle"].shape == (16, 32, 1)
    np.testing.assert_array_equal(x["Offset"][9, 4], inputs["Offset"][9, 4])
    assert plan.current_cost() == pytest.approx(cost, rel=1e-6)
    single = _cpu_plan(energies.image_warping, [32, 16], "LMGPU")
    single.solve(inputs, engine="stream")
    for n, v in single.unknowns().items():
        np.testing.assert_allclose(x[n], v, rtol=1e-4, atol=1e-5, err_msg=n)
    assert plan._state["ssq"].shape == (16 * 32 * 3,)
