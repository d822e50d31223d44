"""ProblemFunctions: the torch callables a plan's solver runs on (port of
opt_tpu/compile/plan_fns.py: centered and graph term groups, take-mode
graph reads).

  residual_fields(x, data) -> list of per-group residual fields (UNMASKED in
                              J -- the reference's J includes rows whose
                              center pixel is excluded; only the *cost* gates
                              on exclusion, solverGPUGaussNewton.t:530-560 vs
                              :971-1000)
  cost(x, data)            -> 0.5 * sum of squared *masked* fields
  model_cost               -> 0.5 * sum of masked (r + J delta)^2 (LM)
  linearize / jtf          -> torch.func.linearize for J.p (traced once per
                              linearization point), torch.func.vjp for J^T.v
  diag_jtj(x, data)        -> structural gather of squared per-leaf partials
                              (the Jacobi preconditioner, o.t:2894-2903):
                              the inverse shift on grids, one batched
                              scatter per (graph, slot) on graphs (K10)

Exclusion masks zero the unknown side of every operator (excluded unknowns
never move: PCGLinearUpdate gate, solverGPUGaussNewton.t:855-862); graph
residuals are never masked (graph kernels default to exclude=false,
o.t:457-458).

FuncsOperator binds these to one problem's data and is the plain engine's
side of the solver seam (solver/core.py): cost(x), outer(x) -> (J^T F,
diag), apply(p, ctc) -> (mask(J^T J p + ctc p), <p, Ap>), mask(v),
model_cost(delta) and the PCG update.
"""

from __future__ import annotations

import warnings

import torch
from torch.func import linearize as _linearize, vjp as _vjp

from ..dsl import expr as E
from ..ops import graph_cuda
from ..ops.pcg_update import pcg_update_plain
from . import evaluate as ev
from .terms import classify_terms, classify_excludes


def _traced_linearize(fn, x):
    """torch.func.linearize, without the UserWarning its constant folding
    raises for every traced graph."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="Attempted to insert a get_attr Node")
        return _linearize(fn, x)


class ProblemFunctions:
    def __init__(self, spec, dtype, device):
        self.spec = spec
        self.dtype = dtype
        self.device = torch.device(device)
        self.groups = classify_terms(spec)
        self.excludes = classify_excludes(spec)  # ispace key -> exprs
        self.use_preconditioner = spec.use_preconditioner
        self.unknowns = spec.unknowns  # name -> Image handle
        self.unknown_shapes = {
            n: im.ispace.shape + (im.channels,)
            for n, im in self.unknowns.items()
        }
        # on a slab of a sharded grid (parallel/halo.py): ispace key -> the
        # global grid's shape, and the per-axis global coordinate of the
        # slab array's [0, ...] corner, so that InBounds, Index and the
        # domain's edge evaluate at global positions
        # (opt_tpu/compile/plan_fns.py:34-43)
        self.global_shapes = {}
        self.coord_offsets = None
        unknown_idx = {im.idx for im in self.unknowns.values()
                       if im.idx is not None}
        for im in spec.images.values():
            if not im.is_unknown and im.idx in unknown_idx:
                # a const view bound to an unknown's buffer (r_const in
                # intrinsic_image_decomposition.t:7)
                ev.not_ported("constant views of unknowns", 7)

    # -- contexts ------------------------------------------------------------

    def _images(self, x, data):
        images = dict(data["images"])
        images.update(x)
        return images

    def _ctx(self, shape, x, data, domain="grid", key=None):
        where = {}
        if domain == "grid" and self.coord_offsets is not None:
            where = dict(global_shape=self.global_shapes[key],
                         coord_offset=self.coord_offsets)
        return ev.EvalContext(
            shape, self._images(x, data), data["params"], self.dtype,
            self.device, domain=domain,
            graph_indices=data.get("graph_indices"),
            graph_incidence=data.get("graph_incidence"),
            unknown_names=self.unknowns, **where)

    def _group_ctx(self, g, x, data):
        """A context over a term group's domain: its grid, or the (E,)
        edges of its graph."""
        if g.kind == "centered":
            return self._ctx(g.ispace.shape, x, data, key=g.ispace.key())
        any_slot = next(iter(g.graph.slots))
        shape = data["graph_indices"][g.graph.name][any_slot].shape
        return self._ctx(shape, x, data, domain="graph")

    def domain_mask(self, ispace_key, shape):
        """True inside the global grid, on a slab whose rows reach past its
        edge; None elsewhere."""
        if self.coord_offsets is None:
            return None
        return ev.real_domain_mask(shape, self.global_shapes[ispace_key],
                                   self.coord_offsets, self.device)

    def exclude_mask(self, ispace_key, x, data):
        """Boolean 'excluded' mask over one index space, or None.  On a
        slab, the rows outside the global grid count as excluded."""
        exprs = self.excludes.get(ispace_key)
        shape = next(im.ispace.shape for im in self.spec.images.values()
                     if im.ispace.key() == ispace_key)
        inside = self.domain_mask(ispace_key, shape)
        if not exprs and inside is None:
            return None
        ctx = self._ctx(shape, x, data, key=ispace_key)
        m = None if inside is None else ~inside
        for e in exprs or ():
            v = ctx.eval(e)
            v = v if v.dtype == torch.bool else (v != 0)
            v = v.expand(shape)
            m = v if m is None else (m | v)
        return m

    def unknown_masks(self, x, data):
        """Per-unknown 'excluded' masks of shape (*spatial, 1), or None."""
        cache = {}
        out = {}
        for n, im in self.unknowns.items():
            k = im.ispace.key()
            if k not in cache:
                cache[k] = self.exclude_mask(k, x, data)
            m = cache[k]
            out[n] = None if m is None else m[..., None]
        return out

    def mask_unknown_tree(self, tree, masks):
        def apply(m, v):
            if m is None:
                return v
            return torch.where(m, torch.zeros((), dtype=v.dtype,
                                              device=v.device), v)

        return {n: apply(masks[n], v) for n, v in tree.items()}

    # -- residual fields -------------------------------------------------------

    def residual_fields(self, x, data, masked):
        """List over groups of (n_channels, *domain) stacked fields."""
        out = []
        for g in self.groups:
            ctx = self._group_ctx(g, x, data)
            fields = [ev.eval_field(e, ctx) for e in g.exprs]
            if g.kind == "centered":
                # a residual centred past the global grid's edge is none
                inside = self.domain_mask(g.ispace.key(), ctx.shape)
                if inside is not None:
                    zero = torch.zeros((), dtype=self.dtype,
                                       device=self.device)
                    fields = [torch.where(inside, f, zero) for f in fields]
            if masked and g.kind == "centered":
                m = self.exclude_mask(g.ispace.key(), x, data)
                if m is not None:
                    zero = torch.zeros((), dtype=self.dtype,
                                       device=self.device)
                    fields = [torch.where(m, zero, f) for f in fields]
            out.append(torch.stack(fields))
        return out

    def residuals_solve(self, x, data):
        return self.residual_fields(x, data, masked=False)

    def cost(self, x, data):
        fields = self.residual_fields(x, data, masked=True)
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for f in fields:
            total = total + 0.5 * torch.sum(f * f)
        return total

    def model_cost(self, r0, jvp_fn, delta, x, data):
        """0.5 * sum of masked (r + J delta)^2 (createmodelcost, o.t:2915)."""
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for g, f0, fd in zip(self.groups, r0, jvp_fn(delta)):
            f = f0 + fd
            m = (self.exclude_mask(g.ispace.key(), x, data)
                 if g.kind == "centered" else None)
            if m is not None:
                f = torch.where(m, torch.zeros((), dtype=self.dtype,
                                               device=self.device), f)
            total = total + 0.5 * torch.sum(f * f)
        return total

    # -- linearization ---------------------------------------------------------

    def linearize(self, x, data):
        """(r0, jvp, jt): matrix-free J and J^T at the current point."""
        fn = lambda xx: self.residuals_solve(xx, data)
        r0, jvp_fn = _traced_linearize(fn, x)
        _, vjp_fn = _vjp(fn, x)
        return r0, jvp_fn, lambda cot: vjp_fn(cot)[0]

    def jtf(self, r0, jt):
        """J^T F -- gradient of the (unmasked) half-sum-of-squares."""
        return jt(r0)

    # -- diag(J^T J) ------------------------------------------------------------

    def leaf_partials(self, x, data):
        """Per-group elementwise partial fields dr/da for every unknown leaf.

        Each group's residual fields depend on their unknown leaves
        pointwise, so the gradient of one residual channel's sum with
        respect to the leaves is, leaf by leaf, the elementwise partial
        field: one backward pass per residual channel gives every leaf's
        partial of that channel.  (The JAX package takes one forward-mode
        JVP per leaf; torch's forward mode runs add and mul through its
        Python reference decompositions, several times the cost of the
        backward passes.)  Yields (group, leaves, [D_a of shape
        (n_channels, *domain)]).  A graph group's leaves are read through
        its slots' gathers, which the evaluation shares: under the
        overrides only the constant block is read."""
        for g in self.groups:
            leaves = g.unknown_leaves
            if not leaves:
                continue
            read_ctx = self._group_ctx(g, x, data)
            vals = tuple(read_ctx.read_image(a).detach().requires_grad_()
                         for a in leaves)
            ctx = self._group_ctx(g, x, data)
            ctx.slot_cache = read_ctx.slot_cache
            ctx.leaf_overrides = {a.key(): v for a, v in zip(leaves, vals)}
            with torch.enable_grad():
                fields = [ev.eval_field(e, ctx) for e in g.exprs]
                rows = []  # per channel: the partial of every leaf
                for k, f in enumerate(fields):
                    grads = (torch.autograd.grad(
                        f, vals, torch.ones_like(f), retain_graph=True,
                        allow_unused=True) if f.requires_grad
                        else (None,) * len(vals))
                    rows.append([torch.zeros_like(v) if d is None else d
                                 for v, d in zip(vals, grads)])
            D = [torch.stack([row[i] for row in rows]).detach()
                 for i in range(len(leaves))]
            inside = (self.domain_mask(g.ispace.key(), ctx.shape)
                      if g.kind == "centered" else None)
            if inside is not None:  # no residual past the global edge
                D = [torch.where(inside, d, torch.zeros_like(d)) for d in D]
            yield g, leaves, D

    def diag_jtj(self, x, data, partials=None):
        """Exact diag(J^T J): squared leaf partials gathered back onto the
        unknowns, by the inverse shift on grids and by one scatter per
        (graph, slot) on graphs, the squared partials of every leaf on the
        slot stacked into one (E, K) block (opt_tpu plan_fns.py:503-540).
        partials: leaf_partials(x, data) already materialized, or None."""
        acc = {
            n: [torch.zeros(s[:-1], dtype=self.dtype, device=self.device)
                for _ in range(s[-1])]
            for n, s in self.unknown_shapes.items()
        }
        pending = {}  # (graph, slot) -> [(image name, channel, d2)]
        if partials is None:
            partials = self.leaf_partials(x, data)
        for g, leaves, D in partials:
            for a, d in zip(leaves, D):
                d2 = torch.sum(d * d, dim=0)
                if isinstance(a.index, E.Offset):
                    contrib = ev.scatter_shift(d2, a.index.data)
                    acc[a.image.name][a.channel] = (
                        acc[a.image.name][a.channel] + contrib
                    )
                else:
                    key = (a.index.graph.name, a.index.slot)
                    pending.setdefault(key, []).append(
                        (a.image.name, a.channel, d2))
        for (gname, slot), items in pending.items():
            stacked = torch.stack([d2 for _, _, d2 in items], dim=-1)
            order, rowptr = data["graph_incidence"][gname][slot]
            out = graph_cuda.graph_scatter(
                stacked, data["graph_indices"][gname][slot], order, rowptr)
            for k, (name, chan, _) in enumerate(items):
                acc[name][chan] = acc[name][chan] + out[:, k]
        return {n: torch.stack(ch, dim=-1) for n, ch in acc.items()}


class FuncsOperator:
    """The plain engine's operator for the solver seam (solver/core.py).

    Works on flat unknown vectors laid out by `layout` (solver/core.Layout);
    outer(x) linearizes at x, and apply() and model_cost() use that point
    until the next outer()."""

    pcg_backend = None
    dot = staticmethod(torch.dot)

    def __init__(self, funcs, data, layout):
        self.funcs = funcs
        self.data = data
        self.layout = layout
        self._x = None
        self.masks = None  # the unknowns' exclusion masks at the last outer
        self._r0 = None
        self._jvp = None
        self._jt = None

    def cost(self, xf):
        return self.funcs.cost(self.layout.views(xf), self.data)

    def outer(self, xf):
        self._x = x = self.layout.views(xf)
        self.masks = self.funcs.unknown_masks(x, self.data)
        self._r0, self._jvp, self._jt = self.funcs.linearize(x, self.data)
        jtf = self.layout.pack(self.funcs.jtf(self._r0, self._jt))
        diag = self.layout.pack(self.funcs.diag_jtj(x, self.data))
        return jtf, diag

    def mask(self, v):
        return self.layout.pack(self.funcs.mask_unknown_tree(
            self.layout.views(v), self.masks))

    def apply(self, p, ctc=None):
        jtjp = self.layout.pack(self._jt(self._jvp(self.layout.views(p))))
        if ctc is not None:
            jtjp = jtjp + ctc * p
        ap = self.mask(jtjp)
        return ap, torch.dot(p, ap)

    def model_cost(self, delta):
        return self.funcs.model_cost(self._r0, self._jvp,
                                     self.layout.views(delta), self._x,
                                     self.data)

    update = staticmethod(pcg_update_plain)


class EvaluatorOuter(FuncsOperator):
    """FuncsOperator for a GN step whose PCG runs on a pcg_backend, which
    replaces apply: outer traces no J p, takes J^T F from one vjp of the
    residuals and the diag only where the energy uses a preconditioner."""

    def outer(self, xf):
        funcs, data = self.funcs, self.data
        self._x = x = self.layout.views(xf)
        self.masks = funcs.unknown_masks(x, data)
        r0, jt = _vjp(lambda xx: funcs.residuals_solve(xx, data), x)
        jtf = self.layout.pack(jt(r0)[0])
        if not funcs.use_preconditioner:  # core reads only its shape
            return jtf, torch.zeros_like(jtf)
        return jtf, self.layout.pack(funcs.diag_jtj(x, data))
