"""Multi-device streamed PCG: the per-slab hat-space apply on K15 / K16
(port of opt_tpu/parallel/stream_shard.py).

The single-card streamed engines (ops/stream_cuda.py, ops/stream3d_cuda.py)
run the inner PCG on the whole grid.  Over a slab mesh (parallel/mesh.py)
each slab owns a contiguous block of rows (D planes of a volume), and

* the inner PCG's apply A_hat p = S J^T J S p is ONE launch for all of a
  process's slabs, one slab per blockIdx.z: K15 warp_slab_apply for
  image_warping, K16 vol_slab_apply for volumetric ARAP
  (ops/slab_cuda.py), each reading its extended slab (its own rows and
  he = 2 radius halo rows from each neighbour, he >= 1) and writing its
  own rows, with global coordinates from the slab's row offset;
* the operands x, the constants and sq are extended once per outer step
  (stream_shard.py:297-304); p is extended before every apply (the mesh's
  ext: a device copy in the slab form, send/recv in the group form);
* the inner PCG is solver/hat_pcg.py's loop, the one the single-card
  engines run: its sums are global sums of the slabs' partials (the mesh's
  psum), and its updates and sweeps the plain torch versions of K2 and of
  the sweep's recurrences (pcg_update_plain, stream_cuda.sweep_update_plain)
  on those sums;
* LM's hat-space diagonal scs = S^2 ctc is purely local, so it is added
  outside the kernel; the LM loop is always the classic one with the Q/zeta
  exit and the exact residual every residual_reset_period iterations
  (stream_shard.py:445-489);
* the outer step (cost, J^T F, diag, LM's model cost) runs per slab on K3
  (2-D) or K8 (3-D) in their global-offset mode, which counts the cost of
  the residuals centred on own rows only.

As on one card, these engines hold one energy each until the DSL->kernel
emitter exists (ROADMAP.md queue A item 6): image_warping ("stream") and
volumetric ARAP ("stream3d"), f32.  The JAX package's lane and sublane
rules (stream_shard.py:88-93, :521-527) are TPU scaffolding and are not
ported; so is its tile search (a CUDA thread per pixel needs none).
"""

from __future__ import annotations

import functools

import torch

from .. import energies
from ..ops import slab_cuda
from ..ops.pcg_update import pcg_update_plain
from ..ops.stream_cuda import pick_variant, sweep_update_plain
from ..solver.hat_pcg import hat_pcg
from .halo import has_sampled, slab_rows, stencil_radius


def _eligible(plan, mesh, ndims, energy):
    """The JAX gate without its TPU rules (stream_shard.py:60-93,
    :492-527): the one energy the kernels hold, f32, one grid index space
    of centered groups in ndims dimensions, no graph and no SampledImage,
    the sharded axis a multiple of the slab count with slabs no thinner
    than the halo."""
    if plan.spec.graphs or plan.funcs.dtype != torch.float32:
        return False
    if plan.problem.energy is not energy:
        return False
    if len({im.ispace.key() for im in plan.spec.images.values()}) != 1:
        return False
    if any(g.kind != "centered" or g.ispace.ndims != ndims
           for g in plan.funcs.groups):
        return False
    if has_sampled(plan.spec):
        return False
    H = next(iter(plan.spec.images.values())).ispace.shape[0]
    he = max(2 * stencil_radius(plan.spec), 1)
    return H % mesh.n == 0 and H // mesh.n >= he


def supports(plan, mesh):
    """The 2-D sharded stream engine's gate (image_warping)."""
    return _eligible(plan, mesh, 2, energies.image_warping)


def supports3d(plan, mesh):
    """The 3-D sharded stream engine's gate (volumetric ARAP)."""
    return _eligible(plan, mesh, 3, energies.volumetric_mesh_deformation)


class _SlabStream:
    """The solver seam (solver/core.py) of a sharded streamed engine: the
    outer step on the slab form of K3 or K8, the inner PCG as pcg_backend
    on K15 or K16.  Vectors are the local flat layout
    (parallel/mesh.SlabLayout); every sum is global."""

    def __init__(self, plan, data, layout, name):
        mesh = layout.mesh
        if not self._supports(plan, mesh):
            raise ValueError(
                f"engine={name!r} over a mesh holds {self._energy}, f32, on "
                f"a grid whose sharded axis divides into {mesh.n} slabs of "
                "at least the halo's rows (parallel/stream_shard.py)")
        self.mesh = mesh
        self.layout = layout
        self.dot = layout.dot
        self.uses_lambda = plan.config.uses_lambda
        # the LM loop is always classic (stream_shard.py:370-372); GN's is
        # the single-card engines' choice
        self.variant = ("classic" if self.uses_lambda else
                        pick_variant(plan.stream_variant))
        self.he = max(2 * stencil_radius(plan.spec), 1)
        n = slab_rows(plan, mesh, self.he)
        total = n * mesh.n
        # (own rows, halo, global row of this process's first array row,
        # global rows): ops/slab_cuda.py's geometry
        self.geom = (n, self.he, mesh.first * n - self.he, total)
        im = data["images"]
        self.consts = [mesh.ext(im[k], self.he).contiguous()
                       for k in self._consts]
        self.params = torch.stack((data["params"]["w_fitSqrt"],
                                   data["params"]["w_regSqrt"]))
        self._x = None  # x on the extended slabs at the last outer

    def _slabs(self, v):
        """A local flat vector on the extended slabs: (S, m), each slab's
        flat unknown layout over its n + 2 he rows."""
        S = self.mesh.S
        return torch.cat([self.mesh.ext(a, self.he).reshape(S, -1)
                          for a in self.layout.views(v).values()], dim=1)

    def cost(self, x):
        return self.mesh.psum(self._linearize(self._slabs(x),
                                              cost_only=True)[2])

    def outer(self, x):
        self._x = self._slabs(x)
        jtf, diag, _ = self._linearize(self._x)
        return jtf, diag

    def model_cost(self, delta):
        return self.mesh.psum(self._linearize(
            self._x, delta=self._slabs(delta))[2])

    def pcg_backend(self, sq, scs, b_hat, sp):
        sq_slabs = self._slabs(sq)  # the operands, once per outer step

        def A(p):
            ap = self._apply(sq_slabs, self._slabs(p))
            return ap if scs is None else ap + scs * p

        def hat_apply(r, p_prev=None, beta=None):
            p = r if p_prev is None else r + beta * p_prev
            ap = A(p)
            return p, ap, self.dot(p, ap)

        def sweep(w_in, *state):  # GN only: LM runs the classic loop
            return sweep_update_plain(A(w_in), w_in, *state, dot=self.dot)

        update = functools.partial(pcg_update_plain, dot=self.dot)
        return hat_pcg(self.variant, hat_apply, update, sweep, self.dot,
                       b_hat, sp, self.uses_lambda)


class ShardedStreamEngine(_SlabStream):
    """image_warping over a slab mesh (stream_shard.py:96): K3's offset
    mode and K15."""

    _supports = staticmethod(supports)
    _energy = "energies.image_warping"
    _consts = ("UrShape", "Constraints", "Mask")

    def __init__(self, plan, data, layout):
        super().__init__(plan, data, layout, "stream")
        # the excluded unknowns in the local layout: Offset's slabs, then
        # Angle's
        keep = data["images"]["Mask"] == 0  # (S, n, W, 1)
        self._excl = ~torch.cat((keep.expand(*keep.shape[:3], 2).reshape(-1),
                                 keep.reshape(-1)))

    def mask(self, v):
        return torch.where(self._excl, torch.zeros((), dtype=v.dtype,
                                                   device=v.device), v)

    def _linearize(self, x, cost_only=False, delta=None):
        return slab_cuda.warp_slab_linearize(
            x, *self.consts, self.params, self.geom, cost_only, delta)

    def _apply(self, sq, p):
        return slab_cuda.warp_slab_apply(self._x, *self.consts, self.params,
                                         sq, p, self.geom)


class ShardedStream3D(_SlabStream):
    """Volumetric ARAP over a mesh of D slabs (stream_shard.py:530): K8's
    offset mode and K16.  The energy excludes nothing."""

    _supports = staticmethod(supports3d)
    _energy = "energies.volumetric_mesh_deformation"
    _consts = ("UrShape", "Constraints")

    def __init__(self, plan, data, layout):
        super().__init__(plan, data, layout, "stream3d")

    def mask(self, v):
        return v

    def _linearize(self, x, cost_only=False, delta=None):
        return slab_cuda.vol_slab_linearize(
            x, *self.consts, self.params, self.geom, cost_only, delta)

    def _apply(self, sq, p):
        return slab_cuda.vol_slab_apply(self._x, *self.consts, self.params,
                                        sq, p, self.geom)

