"""Plan.solve(inputs, mesh=...): one entry point for a solve over a slab
mesh (port of opt_tpu/parallel/dispatch.py).

The engines:
  "halo"      any grid energy on the plain evaluator (parallel/halo.py);
  "stream"    image_warping's inner PCG on K15, its outer step on K3's
              offset mode (parallel/stream_shard.py);
  "stream3d"  volumetric ARAP's on K16 and K8's offset mode.

engine="auto" takes the JAX package's rule (dispatch.py:66-108) with its
thresholds applied to each slab: "stream" for 2-D grids from
stream_cuda.AUTO_STREAM_MIN_PIXELS pixels a slab (GN) or
AUTO_STREAM_MIN_PIXELS_LM (LM), "stream3d" for volumes from
stream3d_cuda.AUTO_STREAM3D_MIN_VOXELS voxels a slab -- and, as the
single-card route does, only where the kernels hold the plan (its energy,
f32, a CUDA device: warp_cuda.supports, vol_cuda.supports).  Everything
else takes "halo".  torch has no GSPMD: the JAX package's "gspmd" route,
and its "xla" alias, resolve to "halo", the explicit form of the same
computation; the port's plain engine name "torch" does too.  There is no
environment override (the JAX package's OPT_TPU_SHARD_ENGINE).

Graphs and SampledImage reads have no slab form here (the JAX package
serves them only through GSPMD): they raise NotImplementedError.
"""

from __future__ import annotations

import math

from ..ops import stream3d_cuda, stream_cuda, vol_cuda, warp_cuda
from ..runtime.trace import span
from . import halo, stream_shard
from .mesh import SlabLayout, shard_problem

ENGINES = ("halo", "stream", "stream3d")
# the JAX package's sharded and single-chip names, as the port runs them
_ALIASES = {"gspmd": "halo", "xla": "halo", "torch": "halo",
            "stream_hbm": "stream", "stream_shard": "stream"}
_NOT_ON_A_MESH = ("graph", "cuda", "vmem")


def pick_sharded_engine(plan, mesh, engine="auto"):
    """The engine a solve of this plan over this mesh runs: "halo",
    "stream" or "stream3d"."""
    if plan.spec.graphs or not plan.spec.images:
        raise NotImplementedError(
            "graph energies have no slab form: a mesh runs grid energies "
            "only (ROADMAP.md queue A item 17)")
    if halo.has_sampled(plan.spec):
        raise NotImplementedError(
            "SampledImage reads cannot be halo-bounded: a mesh does not run "
            "them (ROADMAP.md queue A item 17)")
    engine = _ALIASES.get(engine, engine)
    if engine != "auto":
        if engine in _NOT_ON_A_MESH:
            raise ValueError(f"engine={engine!r} runs on one device; with a "
                             f"mesh use 'auto' or one of {ENGINES}")
        if engine not in ENGINES:
            raise ValueError(f"unknown sharded engine {engine!r}")
        if engine == "stream" and not warp_cuda.supports_energy(plan):
            raise ValueError(
                "engine='stream' holds only energies.image_warping, f32")
        if engine == "stream3d" and not vol_cuda.supports_energy(plan):
            raise ValueError("engine='stream3d' holds only "
                             "energies.volumetric_mesh_deformation, f32")
        return engine
    shape = next(iter(plan.spec.images.values())).ispace.shape
    per_slab = math.prod(shape) // mesh.n
    if len(shape) == 3:
        if (vol_cuda.supports(plan)
                and per_slab >= stream3d_cuda.AUTO_STREAM3D_MIN_VOXELS
                and stream_shard.supports3d(plan, mesh)):
            return "stream3d"
        return "halo"
    if len(shape) == 2:
        min_px = (stream_cuda.AUTO_STREAM_MIN_PIXELS_LM
                  if plan.config.uses_lambda
                  else stream_cuda.AUTO_STREAM_MIN_PIXELS)
        if (warp_cuda.supports(plan) and per_slab >= min_px
                and stream_shard.supports(plan, mesh)):
            return "stream"
    return "halo"


_OPERATORS = {
    "halo": halo.make_halo_solver,
    "stream": stream_shard.ShardedStreamEngine,
    "stream3d": stream_shard.ShardedStream3D,
}


class GlobalCost:
    """A sharded operator's cost of a global flat vector: what
    Plan.current_cost reads after a solve over a mesh."""

    def __init__(self, op, layout, global_layout):
        self.op, self.layout, self.global_layout = op, layout, global_layout

    def cost(self, x):
        return self.op.cost(self.layout.shard(x, self.global_layout))


def solve_sharded_auto(plan, inputs, mesh, engine="auto"):
    """Bind the inputs, cut them into the mesh's slabs and run the plan's
    own solver loop on the picked engine's sharded operator.  Leaves
    plan.engine, plan.variant and the state (its unknowns gathered back
    into the global layout) readable, as the JAX package's sharded solves
    do (stream_shard.py:822-824); Plan.final_cost reads the final
    cost."""
    if mesh.device != plan.device:
        raise ValueError(f"the mesh is on {mesh.device}, the plan on "
                         f"{plan.device}")
    with span("opt.bind"):
        eng = pick_sharded_engine(plan, mesh, engine)
        x, data = plan.bind(inputs)
        layout = SlabLayout(plan.funcs.unknown_shapes, mesh)
        op = _OPERATORS[eng](plan, shard_problem(mesh, data), layout)
    state = plan._full_solve_fn(layout.shard(x, plan.layout), op,
                                plan.solver_params)
    for key in ("x", "ssq"):
        if state[key].ndim:
            state[key] = layout.gather(state[key])
    plan.engine, plan.variant = eng, getattr(op, "variant", None)
    plan._state = state
    plan._op = GlobalCost(op, layout, plan.layout)
