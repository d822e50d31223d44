"""Expression -> torch evaluation (port of opt_tpu/compile/evaluate.py).

Each scalar residual expression evaluates to a whole-domain tensor shaped
like its index space: stencil reads are zero-padded shifted slices, so one
residual is a handful of elementwise ops over the grid.  Derivatives come
from torch.func (compile/plan_fns.py), never from symbolic rules.

What this package evaluates: the elementwise ops that the grid energies
image_warping and poisson_image_editing and the graph energies arap,
embedded and robust_nonrigid use (arithmetic, comparisons, boolean ops,
select, the trig/exp family, constant integer powers), InBounds and Index
on grids, and graph reads: a residual over a graph's edges reads a vertex
array through a slot, one batched gather per slot and block of vertex
arrays (EvalContext._slot_gather; K9 and K10 of ops/graph_cuda.py on the
card).  What it does not, and where that work is queued in ROADMAP.md
queue A:
  * the NaN-safe primitives safe_sqrt/div/log/pow -- they need forward and
    backward rules of their own (item 2);
  * SampledImage reads (items 2 and 7);
  * ComputedArray buffers (item 2).
Each raises NotImplementedError naming its item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dsl import expr as E
from ..ops import graph_cuda


def not_ported(what, item):
    raise NotImplementedError(
        f"{what} is not ported to opt_tpu_torch yet (ROADMAP.md queue A "
        f"item {item})"
    )


def safe_sqrt(x):
    not_ported("sqrt (safe_sqrt: a custom derivative rule)", 2)


def safe_div(a, b):
    not_ported("division (safe_div: a custom derivative rule)", 2)


def safe_log(x):
    not_ported("log (safe_log: a custom derivative rule)", 2)


def safe_pow(x, y):
    not_ported("non-integer pow (safe_pow: a custom derivative rule)", 2)


# ---------------------------------------------------------------------------
# domain helpers
# ---------------------------------------------------------------------------


def shift_read(a, offsets):
    """out[p] = a[p + offset], zero outside bounds.

    ``a`` has spatial axes only (one channel); ``offsets`` is in DSL dim
    order (x fastest), i.e. offsets[i] shifts axis (ndim-1-i).  Zero-pad
    then slice, as the JAX package does."""
    nd = a.ndim
    pads = []  # F.pad order: last axis first, (before, after) each
    slices = []
    for axis in range(nd):
        o = int(offsets[nd - 1 - axis])
        slices.append(slice(max(0, o), max(0, o) + a.shape[axis]))
    for axis in reversed(range(nd)):
        o = int(offsets[nd - 1 - axis])
        pads += [max(0, -o), max(0, o)]
    if not any(pads):
        return a
    return F.pad(a, pads)[tuple(slices)]


def scatter_shift(a, offsets):
    """Adjoint of shift_read: out[p] = a[p - offset], zero outside."""
    return shift_read(a, tuple(-int(o) for o in offsets))


def _coord(shape, axis, device, coord_offset=None):
    """Integer coordinate along ``axis``, broadcastable against ``shape``;
    global when coord_offset (per-axis global coordinate of the array's
    [0, ...] corner) is given."""
    nd = len(shape)
    view = [1] * nd
    view[axis] = shape[axis]
    c = torch.arange(shape[axis], device=device).reshape(view)
    return c if coord_offset is None else c + int(coord_offset[axis])


def bounds_mask(shape, mins, maxs, device, global_shape=None,
                coord_offset=None):
    """InBounds mask over the grid (genbounds, o.t:585-607).  On a slab of
    a sharded grid (parallel/halo.py) coord_offset places the array in the
    global grid, and the bounds test global positions against
    global_shape (opt_tpu/compile/evaluate.py:193-216)."""
    nd = len(shape)
    real = tuple(shape) if global_shape is None else tuple(global_shape)
    m = None
    for i in range(len(mins)):
        axis = nd - 1 - i
        coord = _coord(shape, axis, device, coord_offset)
        mi = (coord >= -int(mins[i])) & (coord < real[axis] - int(maxs[i]))
        m = mi if m is None else (m & mi)
    if m is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return m.expand(shape)


def real_domain_mask(shape, global_shape, coord_offset, device):
    """True where a slab's array lies inside the global grid (its halo
    rows past the global edge are outside), or None where all of it does
    (opt_tpu/compile/evaluate.py:219-233, without the TPU padding)."""
    m = None
    for axis in range(len(shape)):
        off = int(coord_offset[axis])
        if off >= 0 and off + shape[axis] <= global_shape[axis]:
            continue
        coord = _coord(shape, axis, device, coord_offset)
        mi = (coord >= 0) & (coord < global_shape[axis])
        m = mi if m is None else (m & mi)
    return None if m is None else m.expand(shape)


def index_coords(shape, dim, shift, dtype, device, coord_offset=None):
    axis = len(shape) - 1 - dim
    return _coord(shape, axis, device, coord_offset).to(dtype) + shift


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------


def _as_float(v, dtype):
    if v.dtype == torch.bool:
        return v.to(dtype)
    return v


def _as_bool(v):
    if v.dtype == torch.bool:
        return v
    return v != 0


class EvalContext:
    """Carries the runtime tensors an expression evaluates against.

    domain: "grid" or "graph"
    shape: grid spatial shape, or (E,) over a graph's edges
    images: name -> (*spatial, C) tensor; a graph's vertex arrays are
            (N, C)
    params: name -> 0-d tensor
    graph_indices: graph name -> slot name -> (E,) int32 vertex index
    graph_incidence: graph name -> slot name -> (order, rowptr), the
                     slot's CSR incidence (ops/graph_cuda.incidence)
    unknown_names: the unknowns' names (see _slot_gather)
    global_shape, coord_offset: on a slab of a sharded grid, the global
            grid's shape and the slab array's global corner; InBounds and
            Index then evaluate at global positions
    """

    def __init__(self, shape, images, params, dtype, device, domain="grid",
                 graph_indices=None, graph_incidence=None,
                 unknown_names=(), global_shape=None, coord_offset=None):
        self.domain = domain
        self.shape = tuple(shape)
        self.global_shape = global_shape
        self.coord_offset = coord_offset
        self.images = images
        self.params = params
        self.graph_indices = graph_indices or {}
        self.graph_incidence = graph_incidence or {}
        self.unknown_names = frozenset(unknown_names)
        self.dtype = dtype
        self.device = device
        self.memo = {}
        # leaf key -> tensor: re-routes unknown reads through explicit leaf
        # inputs (the structural diag(J^T J), plan_fns.leaf_partials)
        self.leaf_overrides = None
        # (graph, slot, n_verts) -> name -> (gathered rows, column offset)
        self.slot_cache = {}

    def _slot_gather(self, gname, slot, n_verts):
        """name -> (the slot's gathered (E, C_block) rows, the name's column
        offset) for every vertex array of one graph's vertex space.

        The vertex arrays concatenate into two blocks, unknowns and
        constants, gathered separately, one gather per slot and block; a
        read of one (image, channel) is a column of its block.  Split so,
        the constant block carries no tangent under torch.func and the
        unknown block's transpose scatters only unknown channels
        (opt_tpu/compile/evaluate.py:368-417, take mode)."""
        key = (gname, slot, n_verts)
        hit = self.slot_cache.get(key)
        if hit is not None:
            return hit
        blocks = {}  # is_unknown -> (parts, name -> column offset)
        for n in sorted(self.images):
            arr = self.images[n]
            if arr.ndim != 2 or arr.shape[0] != n_verts:
                continue
            parts, offsets = blocks.setdefault(n in self.unknown_names,
                                               ([], {}))
            offsets[n] = sum(p.shape[-1] for p in parts)
            parts.append(arr)
        idx = self.graph_indices[gname][slot]
        order, rowptr = self.graph_incidence[gname][slot]
        out = {}
        for parts, offsets in blocks.values():
            big = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            rows = graph_cuda.gather(big, idx, order, rowptr)
            for n, off in offsets.items():
                out[n] = (rows, off)
        self.slot_cache[key] = out
        return out

    def read_image(self, access: E.ImageAccess):
        if self.leaf_overrides is not None:
            ov = self.leaf_overrides.get(access.key())
            if ov is not None:
                return ov
        idx = access.index
        img = self.images[access.image.name]
        if isinstance(idx, E.Offset):
            return shift_read(img[..., access.channel], idx.data)
        rows, off = self._slot_gather(idx.graph.name, idx.slot,
                                      img.shape[0])[access.image.name]
        return rows[:, off + access.channel]

    def eval(self, e):
        # memo entries hold the expression object itself: id() keys are
        # only unique while the object is alive
        hit = self.memo.get(id(e))
        if hit is not None:
            return hit[1]
        r = self._eval(e)
        self.memo[id(e)] = (e, r)
        return r

    def _scalar(self, v):
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def _eval(self, e):
        if isinstance(e, E.Const):
            return self._scalar(e.value)
        if isinstance(e, E.ImageAccess):
            return self.read_image(e)
        if isinstance(e, E.ParamValue):
            return self.params[e.param.name]
        if isinstance(e, E.BoundsAccess):
            if self.domain != "grid":
                raise ValueError("InBounds used in a graph residual")
            return bounds_mask(self.shape, e.mins, e.maxs, self.device,
                               self.global_shape, self.coord_offset)
        if isinstance(e, E.IndexValue):
            if self.domain != "grid":
                raise ValueError("Index used in a graph residual")
            return index_coords(self.shape, e.dim, e.shift_, self.dtype,
                                self.device, self.coord_offset)
        if isinstance(e, E.SampledAccess):
            not_ported("SampledImage reads", 7)
        if isinstance(e, E.ComputedAccess):
            not_ported("ComputedArray buffers", 2)
        if isinstance(e, E.Apply):
            return self._eval_apply(e)
        raise TypeError(f"cannot evaluate {e!r}")

    def _eval_apply(self, e: E.Apply):
        op = e.op
        args = [self.eval(a) for a in e.args]
        f = lambda v: _as_float(v, self.dtype)

        if op == "add":
            return f(args[0]) + f(args[1])
        if op == "sub":
            return f(args[0]) - f(args[1])
        if op == "mul":
            a, b = args
            if a.dtype == torch.bool and b.dtype == torch.bool:
                return a & b  # boolean product == AND (ad.and_, ad.t:873)
            return f(a) * f(b)
        if op == "div":
            return safe_div(f(args[0]), f(args[1]))
        if op == "neg":
            return -f(args[0])
        if op == "pow":
            b = e.args[1]
            if isinstance(b, E.Const):
                c = b.value
                if c == int(c) and abs(c) <= 4:
                    # powc fast path (ad.t:806-835)
                    n = int(c)
                    x = f(args[0])
                    if n == 0:
                        return torch.ones_like(x)
                    r = x
                    for _ in range(abs(n) - 1):
                        r = r * x
                    return r if n > 0 else 1.0 / r
            return safe_pow(f(args[0]), f(args[1]))
        if op == "select":
            c = _as_bool(args[0])
            a, b = f(args[1]), f(args[2])
            return torch.where(c, a, b)
        if op == "and_":
            return _as_bool(args[0]) & _as_bool(args[1])
        if op == "or_":
            return _as_bool(args[0]) | _as_bool(args[1])
        if op == "not_":
            return ~_as_bool(args[0])
        if op in ("less", "greater", "lesseq", "greatereq", "eq"):
            a, b = f(args[0]), f(args[1])
            return {
                "less": torch.lt,
                "greater": torch.gt,
                "lesseq": torch.le,
                "greatereq": torch.ge,
                "eq": torch.eq,
            }[op](a, b)
        if op == "sqrt":
            return safe_sqrt(f(args[0]))
        if op == "log":
            return safe_log(f(args[0]))
        if op == "abs":
            return torch.abs(f(args[0]))
        unary = {
            "sin": torch.sin,
            "cos": torch.cos,
            "tan": torch.tan,
            "asin": torch.asin,
            "acos": torch.acos,
            "atan": torch.atan,
            "sinh": torch.sinh,
            "cosh": torch.cosh,
            "tanh": torch.tanh,
            "asinh": torch.asinh,
            "acosh": torch.acosh,
            "exp": torch.exp,
            "log10": torch.log10,
        }
        if op in unary:
            return unary[op](f(args[0]))
        if op == "atan2":
            return torch.atan2(f(args[0]), f(args[1]))
        raise NotImplementedError(f"op {op}")


def eval_field(exp, ctx):
    """Evaluate a scalar residual expression to a full-domain float tensor."""
    v = ctx.eval(exp)
    if v.dtype != ctx.dtype:
        v = v.to(ctx.dtype)
    return v.expand(ctx.shape)
