"""The graph path on hand-written CUDA: K9 graph_gather, K10 graph_scatter
and K11 graph_hat_apply (csrc/graph_kernels.cu), and the "graph" engine
that runs a graph energy's inner PCG on them (port of
opt_tpu/ops/graph_pcg_kernel.py GraphPcgKernel and of the one-hot kernels
of opt_tpu/ops/onehot_pallas.py).

K9 and K10 are the vertex <-> edge movement of every graph residual:
compile/evaluate.py gathers a slot's vertex rows through gather() below, an
autograd function whose forward and tangent are K9 and whose transpose is
K10, so cost, J^T F (torch.func.vjp), the leaf partials (torch.func.jvp)
and the plain engine's linearized J p all run on them on the card.  They
are torch.library operators, so torch.func.linearize, which traces its J p
with make_fx and replays the trace, records the launches rather than the
empty buffers a ctypes launch would leave in the trace.

The "graph" engine (GraphOperator) follows GraphPcgKernel: once per outer
step it materializes the per-leaf partials D_a = dr/da through
funcs.leaf_partials, and the inner PCG applies

    J p   = sum_a D_a * gather_slot(a)(p)[unk(a)]
    J^T v = sum_a scatter_slot(a)(D_a * v)   into unk(a)

in the hat space (ops/stream_cuda.py): classic_pcg with K11 as its apply
and K2's hat mode as its update, GN and LM, as GraphPcgKernel.solve runs
its classic loop.  The energy enters K11 only through D and a small int
table (HatTables), so it holds every graph energy whose images share one
vertex space, with no Exclude and pointwise vertex terms: arap,
embedded_mesh_deformation, robust_nonrigid_alignment.  Not ported: the
banded (RCM-reordered, split-bf16 one-hot) layout, which exists for the
TPU's matrix unit (opt_tpu/ops/graph_banded.py:452-485); a gather here is a
load on the flat vertex order.

On CPU tensors every wrapper runs its plain torch version
(graph_gather_plain: index_select; graph_scatter_plain: index_add_;
graph_hat_apply_plain), so on a CPU plan engine="graph" runs the whole
engine on them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vjp as _vjp

from ..dsl import expr as E
from . import build
from .stream_cuda import classic_pcg

# K11's static limits, as csrc/graph_kernels.cu sizes its shared memory and
# its per-thread tangent
MAX_UNKNOWN_CHANNELS = 16
MAX_RESIDUALS = 16
META_MAX = 1024


def incidence(idx, n_verts):
    """One slot's vertex -> edge incidence in CSR form, from its (E,) int
    index: (order, rowptr), order the edges sorted by vertex (stably, so in
    edge order within a vertex) and rowptr[v]:rowptr[v + 1] vertex v's run
    in order.  int32 numpy arrays."""
    idx = np.asarray(idx)
    order = np.argsort(idx, kind="stable").astype(np.int32)
    rowptr = np.zeros(n_verts + 1, np.int64)
    np.cumsum(np.bincount(idx, minlength=n_verts), out=rowptr[1:])
    return order, rowptr.astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def graph_gather_plain(v, idx):
    """out[..., c] = v[idx[...], c] for an (N, C) vertex block."""
    rows = torch.index_select(v, 0, idx.reshape(-1))
    return rows.reshape(*idx.shape, *v.shape[1:])


def graph_scatter_plain(x, idx, n_verts):
    """out[w, c] = sum of x[e, c] over the edges e with idx[e] = w."""
    out = torch.zeros((n_verts,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, idx, x)


def graph_hat_apply_plain(t, sq, scs, r, p_prev=None, beta=None):
    """(p, A_hat p, <p, A_hat p>) for p = r + beta p_prev (r when p_prev is
    None), A_hat p = sq J^T J (sq p) + scs p with J from the tables t."""
    p = r if p_prev is None else r + beta * p_prev
    ps = (sq * p)[t.flat_index]  # (n_unk, N)
    acc = torch.zeros_like(ps)
    for _, n_res, leaves, D, idx in t.graph:
        g = ps[:, idx]  # (n_unk, n_slots, E)
        Dl = D.view(len(leaves), n_res, -1)
        tan = sum(Dl[a] * g[u, s] for a, (s, u) in enumerate(leaves))
        for a, (s, u) in enumerate(leaves):
            acc[u].index_add_(0, idx[s], torch.sum(Dl[a] * tan, dim=0))
    if t.fit is not None:
        _, n_res, leaves, D = t.fit
        Dl = D.view(len(leaves), n_res, -1)
        tan = sum(Dl[a] * ps[u] for a, u in enumerate(leaves))
        for a, u in enumerate(leaves):
            acc[u] += torch.sum(Dl[a] * tan, dim=0)
    jtj = torch.empty_like(p)
    jtj[t.flat_index] = acc
    ap = sq * jtj
    if scs is not None:
        ap = ap + scs * p
    return p, ap, torch.dot(p, ap)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _float_dtype(name, t):
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: {t.dtype}, not float32 or float64")
    return t.dtype


def graph_gather(v, idx):
    """K9: out[..., c] = v[idx[...], c] -- kernel on CUDA, plain on CPU.
    v is an (N, C) float32 or float64 block, idx an int32 index of any
    shape (S slots of E edges gather in one launch)."""
    if build.all_on_cpu(v, idx):
        return graph_gather_plain(v, idx)
    dt = _float_dtype("graph_gather", v)
    if v.ndim != 2:
        raise ValueError(f"graph_gather: v has shape {tuple(v.shape)}, "
                         "want (N, C)")
    build.check_tensors("graph_gather", {}, {"v": dt, "idx": torch.int32},
                        v=v, idx=idx)
    rows, C = idx.numel(), v.shape[1]
    out = v.new_empty((*idx.shape, C))
    if rows * C == 0:
        return out
    if rows * C >= 2 ** 31 or v.numel() >= 2 ** 31:
        raise ValueError("graph_gather: more than 2^31 - 1 elements")
    rc = build.library().opt_graph_gather(
        v.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, C,
        dt is torch.float64, build.stream())
    build.check(rc, "graph_gather")
    graph_gather.launches += 1
    return out


def graph_scatter(x, idx, order, rowptr):
    """K10: out[w, c] = sum of x[e, c] over the edges e with idx[e] = w --
    kernel on CUDA (a segmented sum over the CSR incidence (order,
    rowptr), in edge order from zero: deterministic), plain index_add_ on
    CPU.  x is an (E, C) float32 or float64 block; N = len(rowptr) - 1."""
    n = rowptr.shape[0] - 1
    if build.all_on_cpu(x, idx, order, rowptr):
        return graph_scatter_plain(x, idx, n)
    dt = _float_dtype("graph_scatter", x)
    if x.ndim != 2:
        raise ValueError(f"graph_scatter: x has shape {tuple(x.shape)}, "
                         "want (E, C)")
    E_, C = x.shape
    build.check_tensors(
        "graph_scatter", {"order": (E_,), "rowptr": (n + 1,)},
        {"x": dt, "order": torch.int32, "rowptr": torch.int32},
        x=x, order=order, rowptr=rowptr)
    out = x.new_empty((n, C))
    if n * C == 0:
        return out
    if n * C >= 2 ** 31 or E_ * C >= 2 ** 31:
        raise ValueError("graph_scatter: more than 2^31 - 1 elements")
    rc = build.library().opt_graph_scatter(
        x.data_ptr(), order.data_ptr(), rowptr.data_ptr(), out.data_ptr(), n,
        C, dt is torch.float64, build.stream())
    build.check(rc, "graph_scatter")
    graph_scatter.launches += 1
    return out


def graph_hat_apply(t, sq, scs, r, p_prev=None, beta=None):
    """K11: (p, A_hat p, <p, A_hat p>) -- kernel on CUDA, plain on CPU.
    t: HatTables; beta is a 0-d device tensor, given with p_prev; p is a
    new buffer (r itself when p_prev is None)."""
    if build.all_on_cpu(t.D, sq, scs, r, p_prev, beta):
        return graph_hat_apply_plain(t, sq, scs, r, p_prev, beta)
    if (p_prev is None) != (beta is None):
        raise ValueError("graph_hat_apply: p_prev and beta come together")
    n = r.shape[0]
    ints = {k: torch.int32 for k in ("idx", "order", "rowptr", "meta")}
    build.check_tensors(
        "graph_hat_apply",
        {"sq": (n,), "scs": (n,), "r": (n,), "p_prev": (n,), "beta": ()},
        ints,
        **build.present(D=t.D, idx=t.idx, order=t.order, rowptr=t.rowptr,
                        meta=t.meta, sq=sq, scs=scs, r=r, p_prev=p_prev,
                        beta=beta))
    lib = build.library()
    p = torch.empty_like(r) if p_prev is not None else r
    ap = torch.empty_like(r)
    parts = torch.empty(lib.opt_graph_blocks(t.n_verts), dtype=r.dtype,
                        device=r.device)
    rc = lib.opt_graph_hat_apply(
        build.ptr(t.D), build.ptr(t.idx), build.ptr(t.order),
        build.ptr(t.rowptr), build.ptr(t.meta), t.meta.numel(),
        build.ptr(sq), build.ptr(scs), build.ptr(r), build.ptr(p_prev),
        build.ptr(beta), build.ptr(p) if p_prev is not None else None,
        build.ptr(ap), build.ptr(parts), t.n_verts, build.stream())
    build.check(rc, "graph_hat_apply")
    graph_hat_apply.launches += 1
    return p, ap, torch.sum(parts)


graph_gather.launches = 0
graph_scatter.launches = 0
graph_hat_apply.launches = 0


# ---------------------------------------------------------------------------
# the gather as the evaluator sees it: torch.library operators under an
# autograd function
# ---------------------------------------------------------------------------


# Registered with the dispatcher directly (a schema and one Python kernel
# for CPU and CUDA): torch.library.custom_op's own Python layers (its
# autograd and backend wrappers) cost more host time than the launch.
_LIB = torch.library.Library("opt_tpu_torch", "FRAGMENT")
_LIB.define("graph_gather(Tensor v, Tensor idx) -> Tensor")
_LIB.define("graph_scatter(Tensor x, Tensor idx, Tensor order, "
            "Tensor rowptr) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("graph_gather",
              lambda v, idx: graph_gather(v.contiguous(), idx), _key)
    _LIB.impl("graph_scatter",
              lambda x, idx, order, rowptr: graph_scatter(
                  x.contiguous(), idx, order, rowptr), _key)


@torch.library.register_fake("opt_tpu_torch::graph_gather", lib=_LIB)
def _(v, idx):
    return v.new_empty(tuple(idx.shape) + tuple(v.shape[1:]))


@torch.library.register_fake("opt_tpu_torch::graph_scatter", lib=_LIB)
def _(x, idx, order, rowptr):
    return x.new_empty((rowptr.shape[0] - 1,) + tuple(x.shape[1:]))


_gather_op = torch.ops.opt_tpu_torch.graph_gather.default
_scatter_op = torch.ops.opt_tpu_torch.graph_scatter.default


class _Gather(torch.autograd.Function):
    """rows = v[idx]: K9 forward and tangent (the gather is linear), K10
    transpose."""

    @staticmethod
    def forward(v, idx, order, rowptr):
        return _gather_op(v, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, order, rowptr = inputs
        ctx.save_for_backward(idx, order, rowptr)
        ctx.save_for_forward(idx, order, rowptr)

    @staticmethod
    def backward(ctx, g):
        idx, order, rowptr = ctx.saved_tensors
        return _scatter_op(g, idx, order, rowptr), None, None, None

    @staticmethod
    def jvp(ctx, dv, *_):
        return _gather_op(dv, ctx.saved_tensors[0])


def gather(v, idx, order, rowptr):
    """v[idx] for an (N, C) vertex block, differentiable in v under
    torch.func (jvp, vjp, linearize) and autograd: K9 forward and tangent,
    K10 transpose over the slot's CSR incidence (order, rowptr)."""
    return _Gather.apply(v, idx, order, rowptr)


# ---------------------------------------------------------------------------
# which plans the engine holds
# ---------------------------------------------------------------------------


def plan_meta(plan):
    """The static structure of K11's apply for this plan, or None where
    the kernel cannot hold it (port of graph_pcg_kernel._plan_meta without
    its banding and VMEM conditions):

      unk           [(unknown name, channel)] in the flat layout's order
      graph_groups  per graph term group: gi (its index in funcs.groups),
                    gname, slots (ordered), n_res, leaves [(slot index,
                    unknown channel index)]
      fit           the pointwise vertex group: gi, n_res, leaves [unknown
                    channel index]; or None
    """
    funcs, spec = plan.funcs, plan.spec
    if not spec.graphs or funcs.excludes:
        return None
    spaces = {im.ispace.key() for im in spec.images.values()}
    if len(spaces) != 1 or next(iter(spec.images.values())).ispace.ndims != 1:
        return None  # one shared 1-D vertex space for every image
    unk = [(n, c) for n, s in funcs.unknown_shapes.items()
           for c in range(s[-1])]
    if len(unk) > MAX_UNKNOWN_CHANNELS:
        return None
    uidx = {nc: i for i, nc in enumerate(unk)}
    graph_groups, fit = [], None
    for gi, g in enumerate(funcs.groups):
        leaves = g.unknown_leaves
        if not leaves:
            continue
        if len(g.exprs) > MAX_RESIDUALS:
            return None
        if g.kind == "graph":
            sidx = {s: i for i, s in enumerate(g.graph.slots)}
            graph_groups.append(dict(
                gi=gi, gname=g.graph.name, slots=list(g.graph.slots),
                n_res=len(g.exprs),
                leaves=[(sidx[a.index.slot], uidx[(a.image.name, a.channel)])
                        for a in leaves]))
        else:
            if any(not isinstance(a.index, E.Offset)
                   or any(int(o) != 0 for o in a.index.data)
                   for a in leaves):
                return None  # only pointwise vertex terms
            fit = dict(gi=gi, n_res=len(g.exprs),
                       leaves=[uidx[(a.image.name, a.channel)]
                               for a in leaves])
    if not graph_groups:
        return None
    n_meta = 3 + 2 * len(unk) + sum(7 + 2 * len(gg["leaves"])
                                    for gg in graph_groups)
    if fit is not None:
        n_meta += 3 + len(fit["leaves"])
    if n_meta > META_MAX:
        return None
    return dict(unk=unk, graph_groups=graph_groups, fit=fit)


def supports_plan(plan):
    """True when K11 holds this plan's energy in float32."""
    return plan.funcs.dtype == torch.float32 and plan_meta(plan) is not None


def supports(plan):
    """supports_plan, on a CUDA device: where engine="auto" picks "graph"."""
    return supports_plan(plan) and plan.device.type == "cuda"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class HatTables:
    """What K11 reads besides the vectors: the partials D of every group in
    one flat buffer (set each outer step), the slots' indices and CSR
    incidences, the int table meta (its layout is in csrc/graph_kernels.cu),
    and the same as structured views for the plain version:

      graph  [(gi, n_res, leaves [(slot, unk)], D (n_leaves n_res, E),
               idx (n_slots, E))] per graph group
      fit    (gi, n_res, leaves [unk], D (n_leaves n_res, N)) or None
      flat_index  (n_unk, N): element of unknown channel u at vertex w in
                  the flat vectors
    """

    def __init__(self, meta, data, layout, n_verts, device):
        self.n_verts = n_verts
        bases = [(layout.offsets[name] + c, layout.shapes[name][-1])
                 for name, c in meta["unk"]]
        ar = torch.arange(n_verts, device=device)
        self.flat_index = torch.stack([b + s * ar for b, s in bases])
        table = [len(meta["unk"]), len(meta["graph_groups"]),
                 int(meta["fit"] is not None)]
        for b, s in bases:
            table += [b, s]
        # (group index, rows, row length, slot index stack) in D's order
        self._blocks = []
        idx, order, rowptr = [], [], []
        d_off = i_off = rp_off = 0
        for gg in meta["graph_groups"]:
            slots = gg["slots"]
            stack = torch.stack([data["graph_indices"][gg["gname"]][s]
                                 for s in slots])
            csr = [data["graph_incidence"][gg["gname"]][s] for s in slots]
            E_ = stack.shape[1]
            rows = len(gg["leaves"]) * gg["n_res"]
            self._blocks.append((gg, rows, E_, stack))
            idx.append(stack.reshape(-1))
            order += [o for o, _ in csr]
            rowptr += [r for _, r in csr]
            table += [E_, len(slots), gg["n_res"], len(gg["leaves"]), d_off,
                      i_off, rp_off]
            table += [s for s, _ in gg["leaves"]]
            table += [u for _, u in gg["leaves"]]
            d_off += rows * E_
            i_off += len(slots) * E_
            rp_off += len(slots) * (n_verts + 1)
        fit = meta["fit"]
        if fit is not None:
            rows = len(fit["leaves"]) * fit["n_res"]
            self._blocks.append((fit, rows, n_verts, None))
            table += [fit["n_res"], len(fit["leaves"]), d_off]
            table += list(fit["leaves"])
            d_off += rows * n_verts
        if d_off >= 2 ** 31:
            raise ValueError("graph engine: more than 2^31 - 1 partials")
        self.idx, self.order, self.rowptr = (torch.cat(ts)
                                             for ts in (idx, order, rowptr))
        self.meta = torch.tensor(table, dtype=torch.int32).to(device)
        self.D = None
        self.graph, self.fit = [], None

    def set_partials(self, D_by_group):
        """D_by_group: group index -> its (n_leaves n_res, length)
        partials, for every group of the tables."""
        self.D = torch.cat([D_by_group[m["gi"]].reshape(-1)
                            for m, _, _, _ in self._blocks])
        self.graph, self.fit, off = [], None, 0
        for m, rows, length, stack in self._blocks:
            D = self.D[off:off + rows * length].view(rows, length)
            off += rows * length
            if stack is None:
                self.fit = (m["gi"], m["n_res"], m["leaves"], D)
            else:
                self.graph.append((m["gi"], m["n_res"], m["leaves"], D,
                                   stack))


class GraphOperator:
    """The "graph" engine's operator for the solver seam (solver/core.py):
    the plain engine's cost and mask (no Exclude here), J^T F through
    torch.func.vjp, diag(J^T J) and LM's model cost from the materialized
    partials D, and the inner PCG as pcg_backend: classic_pcg on K11 and
    K2's hat mode."""

    variant = "classic"
    dot = staticmethod(torch.dot)

    def __init__(self, funcs, data, layout, uses_lambda, meta):
        self.funcs = funcs
        self.data = data
        self.layout = layout
        self.uses_lambda = uses_lambda
        n_verts = layout.shapes[meta["unk"][0][0]][0]
        self.tables = HatTables(meta, data, layout, n_verts, funcs.device)
        self._r0 = None

    def cost(self, xf):
        return self.funcs.cost(self.layout.views(xf), self.data)

    def mask(self, v):
        return v

    def outer(self, xf):
        funcs, data = self.funcs, self.data
        x = self.layout.views(xf)
        r0, vjp_fn = _vjp(lambda xx: funcs.residuals_solve(xx, data), x)
        self._r0 = r0
        jtf = self.layout.pack(vjp_fn(r0)[0])
        partials = list(funcs.leaf_partials(x, data))
        diag = self.layout.pack(funcs.diag_jtj(x, data, partials))
        self.tables.set_partials({funcs.groups.index(g): torch.cat(D)
                                  for g, _, D in partials})
        return jtf, diag

    def model_cost(self, delta):
        """0.5 sum of (r + J delta)^2 with J delta from the partials."""
        t = self.tables
        planes = delta[t.flat_index]  # (n_unk, N)
        block = planes.t().contiguous()
        jd = {}
        for gi, n_res, leaves, D, idx in t.graph:
            rows = graph_gather(block, idx)  # (n_slots, E, n_unk)
            Dl = D.view(len(leaves), n_res, -1)
            jd[gi] = sum(Dl[a] * rows[s, :, u]
                         for a, (s, u) in enumerate(leaves))
        if t.fit is not None:
            gi, n_res, leaves, D = t.fit
            Dl = D.view(len(leaves), n_res, -1)
            jd[gi] = sum(Dl[a] * planes[u] for a, u in enumerate(leaves))
        total = torch.zeros((), dtype=delta.dtype, device=delta.device)
        for gi, f0 in enumerate(self._r0):
            f = f0 + jd[gi] if gi in jd else f0
            total = total + 0.5 * torch.sum(f * f)
        return total

    def pcg_backend(self, sq, scs, b_hat, sp):
        t = self.tables

        def hat_apply(r, p_prev=None, beta=None):
            return graph_hat_apply(t, sq, scs, r, p_prev, beta)

        return classic_pcg(hat_apply, b_hat, sp, self.uses_lambda)
