"""The explicit halo path: any grid energy on the plain evaluator, over a
slab mesh (port of opt_tpu/parallel/halo.py).

Each slab evaluates the energy on its rows plus `halo` rows from each
neighbour, filled by the mesh's ext; the solver's sums reduce with the
mesh's psum (solver/core.py's dot hook).  As in the JAX package:

* halo = 2 * stencil radius (halo.py:59-75, :529-533);
* InBounds, Index and the grid's edge evaluate at GLOBAL positions
  (ProblemFunctions.coord_offsets holds the slab's row offset), and a
  slab's halo past the global edge stays zero, the zero fill of a stencil
  read at the edge;
* cost and LM's model cost count the residuals centred on the slab's own
  rows only, so each residual is counted once.

The JAX package gets J^T by transposing ext, which sends the halo rows'
share of J^T back to their owners through the reverse ppermutes.  Here
each slab takes J^T F, diag(J^T J) and J^T J p at its own rows from the
residuals of its whole extended slab, and crops: a residual that touches
an own row is centred within radius of it and reads within 2 radius, so
it lies whole inside the extended slab; the residuals near the extended
slab's edge, whose reads fall outside it, touch only halo rows.  So an
apply exchanges p once and nothing comes back, the redundant compute the
JAX package itself chose for diag and for its streamed apply
(stream_shard.py:24-28).  The sums are the same; their order differs.

The slabs run the plain evaluator one after another, J and J^T by reverse
mode (_linearize).  ShardedChunkedGridFuncs (the strip-mined outer step)
is not ported (ROADMAP.md queue A item 18).
"""

from __future__ import annotations

import torch
from torch.func import vjp as _vjp

from ..compile.plan_fns import ProblemFunctions
from ..dsl import expr as E
from ..dsl.env import EnergyEnv
from ..dsl.spec import ProblemSpec
from ..ops.pcg_update import pcg_update_plain


def stencil_radius(spec, axis=0):
    """Max |offset| along array axis `axis` (axis 0 = the last declared
    dim) over every image read and exclusion."""
    radius = 0
    nd = next(iter(spec.images.values())).ispace.ndims

    def on_node(a):
        nonlocal radius
        if isinstance(a, E.ImageAccess) and isinstance(a.index, E.Offset):
            radius = max(radius, abs(int(a.index.data[nd - 1 - axis])))
        elif isinstance(a, E.ComputedAccess):
            E.visit(a.expanded(), on_node)

    for exp in list(spec.terms) + list(spec.excludes):
        E.visit(exp, on_node)
    return radius


def has_sampled(spec):
    found = []
    for exp in spec.terms:
        E.visit(exp, lambda a: found.append(a)
                if isinstance(a, E.SampledAccess) else None)
    return bool(found)


def slab_rows(plan, mesh, he):
    """n_local, the rows of each slab, after checking that the grid cuts
    into mesh.n slabs of at least he rows."""
    H = next(iter(plan.spec.images.values())).ispace.shape[0]
    if H % mesh.n:
        raise ValueError(f"the sharded axis ({H}) does not divide into "
                         f"{mesh.n} slabs")
    n_local = H // mesh.n
    if n_local < he:
        raise ValueError(f"slabs of {n_local} rows are thinner than the "
                         f"halo of {he} rows")
    return n_local


def _linearize(fn, x):
    """(r0, J^T, J) of fn at x, both from reverse mode: J^T is fn's vjp,
    and J the vjp of that linear map (J p = d/du <J^T u, p>).  The plain
    engine traces J p with torch.func.linearize instead, once per outer
    step, seconds of host time a trace, which every slab would pay; the
    two J p agree bit for bit.  A grid energy's backward is plain torch,
    twice differentiable; a graph energy's (K9, K10) is not, and a mesh
    runs no graph."""
    r0, vjp = _vjp(fn, x)
    _, vjp_of_vjp = _vjp(lambda u: vjp(u)[0], [torch.zeros_like(r)
                                                for r in r0])
    return r0, (lambda u: vjp(u)[0]), (lambda p: vjp_of_vjp(p)[0])


def ext_tree(mesh, tree, he):
    return {n: mesh.ext(v, he) for n, v in tree.items()}


class ShardedGridFuncs:
    """The plain evaluator over extended slabs (halo.py:78): a
    ProblemFunctions built for the extended shape, with global shapes,
    whose coord_offsets each slab sets before it evaluates."""

    def __init__(self, plan, mesh):
        from ..runtime.api import _run_energy

        if has_sampled(plan.spec):
            raise NotImplementedError(
                "SampledImage reads at dynamic coordinates cannot be "
                "halo-bounded; a mesh does not run them (ROADMAP.md queue A "
                "item 17)")
        self.mesh = mesh
        self.halo = 2 * stencil_radius(plan.spec)
        self.n_local = slab_rows(plan, mesh, self.halo)
        self.nd = len(plan.dims)
        dims = list(plan.dims)
        dims[-1] = self.n_local + 2 * self.halo  # array axis 0
        spec = ProblemSpec()
        _run_energy(plan.problem.energy, EnergyEnv(spec, dims))
        self.base = ProblemFunctions(spec, plan.funcs.dtype, mesh.device)
        self.base.global_shapes = {im.ispace.key(): im.ispace.shape
                                   for im in plan.spec.images.values()}
        self.dtype = plan.funcs.dtype

    def set_slab(self, s):
        """Install slab s's global offset: its array row 0's global row."""
        row0 = (self.mesh.first + s) * self.n_local - self.halo
        self.base.coord_offsets = (row0,) + (0,) * (self.nd - 1)

    def slabs(self, x_ext, data_ext):
        """(x, data) of each slab in turn, its global offset installed."""
        for s in range(self.mesh.S):
            self.set_slab(s)
            yield ({n: v[s] for n, v in x_ext.items()},
                   {"images": {n: v[s] for n, v in
                               data_ext["images"].items()},
                    "params": data_ext["params"], "graph_indices": {},
                    "graph_incidence": {}})

    def crop(self, a, axis=0):
        """The slab's own rows of an extended-slab array."""
        return a.narrow(axis, self.halo, self.n_local)

    def fields_sum(self, fields):
        """0.5 sum of squares over the own rows of stacked (C, rows, ...)
        residual fields."""
        total = torch.zeros((), dtype=self.dtype, device=self.mesh.device)
        for f in fields:
            c = self.crop(f, 1)
            total = total + 0.5 * torch.sum(c * c)
        return total

    def cost(self, x_ext, data_ext):
        """(S,) per-slab masked costs of the own rows."""
        return torch.stack([
            self.fields_sum(self.base.residual_fields(x, d, masked=True))
            for x, d in self.slabs(x_ext, data_ext)])


class HaloOperator:
    """The solver seam (solver/core.py) over a slab mesh on the plain
    evaluator: the counterpart of compile/plan_fns.FuncsOperator, whose
    vectors are the local flat layout (parallel/mesh.SlabLayout) and whose
    sums are global."""

    pcg_backend = None

    def __init__(self, funcs, data, layout):
        self.funcs = funcs
        self.layout = layout
        self.mesh = layout.mesh
        self.data_ext = {"images": ext_tree(self.mesh, data["images"],
                                            funcs.halo),
                         "params": data["params"]}
        self.dot = layout.dot
        # per slab at the last outer step: x, data, r0, jt (J^T), jvp (J)
        self._lin = None
        self.masks = None

    def _ext(self, v):
        return ext_tree(self.mesh, self.layout.views(v), self.funcs.halo)

    def _stack(self, per_slab):
        """Local flat vector from a list over slabs of name -> extended
        array, each cropped to its own rows."""
        return self.layout.pack({
            n: torch.stack([self.funcs.crop(t[n]) for t in per_slab])
            for n in self.layout.shapes})

    def cost(self, xf):
        return self.mesh.psum(self.funcs.cost(self._ext(xf), self.data_ext))

    def outer(self, xf):
        base = self.funcs.base
        self._lin, masks, jtf, diag = [], [], [], []
        for x, d in self.funcs.slabs(self._ext(xf), self.data_ext):
            r0, jt, jvp = _linearize(
                lambda xx, d=d: base.residuals_solve(xx, d), x)
            self._lin.append({"x": x, "data": d, "r0": r0, "jt": jt,
                              "jvp": jvp})
            masks.append(base.unknown_masks(x, d))
            jtf.append(jt(r0))
            diag.append(base.diag_jtj(x, d))
        self.masks = {n: self._stack_masks([m[n] for m in masks])
                      for n in self.layout.shapes}
        return self._stack(jtf), self._stack(diag)

    def _stack_masks(self, per_slab):
        """(S, n_local, ..., 1) excluded own unknowns, or None where no
        slab has a mask."""
        own = [None if m is None else self.funcs.crop(m) for m in per_slab]
        if all(m is None for m in own):
            return None
        ref = next(m for m in own if m is not None)
        return torch.stack([torch.zeros_like(ref) if m is None else m
                            for m in own])

    def mask(self, v):
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        return self.layout.pack({
            n: a if self.masks[n] is None else torch.where(self.masks[n],
                                                           zero, a)
            for n, a in self.layout.views(v).items()})

    def apply(self, p, ctc=None):
        p_ext = self._ext(p)
        jtjp = self._stack([
            lin["jt"](lin["jvp"]({n: v[s] for n, v in p_ext.items()}))
            for s, lin in enumerate(self._lin)])
        if ctc is not None:
            jtjp = jtjp + ctc * p
        ap = self.mask(jtjp)
        return ap, self.dot(p, ap)

    def model_cost(self, delta):
        base = self.funcs.base
        d_ext = self._ext(delta)
        parts = []
        for s, lin in enumerate(self._lin):
            self.funcs.set_slab(s)
            fields = []
            jd = lin["jvp"]({n: v[s] for n, v in d_ext.items()})
            for g, f0, fd in zip(base.groups, lin["r0"], jd):
                f = f0 + fd
                m = base.exclude_mask(g.ispace.key(), lin["x"], lin["data"])
                if m is not None:
                    f = torch.where(m, torch.zeros((), dtype=f.dtype,
                                                   device=f.device), f)
                fields.append(f)
            parts.append(self.funcs.fields_sum(fields))
        return self.mesh.psum(torch.stack(parts))

    def update(self, alpha, p, ap, delta, r, pre, b=None):
        return pcg_update_plain(alpha, p, ap, delta, r, pre, b, dot=self.dot)


def make_halo_solver(plan, data, layout):
    """The halo path's operator for a plan's bound data, cut into the
    slabs of layout's mesh (halo.py:493), for the plan's solver loop."""
    return HaloOperator(ShardedGridFuncs(plan, layout.mesh), data, layout)
