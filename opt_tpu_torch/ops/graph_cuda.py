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

in the hat space (solver/hat_pcg.py): classic_pcg with K11 as its apply
and K2's hat mode as its update, GN and LM, as GraphPcgKernel.solve runs
its classic loop.  K11 is two kernels behind one C entry: an edge pass (a
thread per edge: the tangent once, then each leaf's c_a = D_a^T t, written
as rows of one (E, L_s) buffer per slot) and a vertex pass (a thread per
vertex: K10's segmented sum of those rows over its CSR runs, then the
pointwise vertex terms, p, A_hat p and the block partials of <p, A_hat p>).
graph_hat_edge and graph_hat_vertex launch each pass alone, for the checks;
graph_hat_edge_plain and graph_hat_vertex_plain are their plain versions.
The energy enters K11 only through D and a small int table (HatTables),
so it holds every graph energy whose images share one vertex space, with
no Exclude, pointwise vertex terms and at most MAX_LEAVES leaves on
MAX_SLOTS slots a graph group (the edge pass's argument): arap,
embedded_mesh_deformation, robust_nonrigid_alignment.  A plan past those
limits solves on engine="torch".  Not ported: the
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
from ..runtime.trace import LAUNCHES, kernel
from ..solver.hat_pcg import classic_pcg
from . import build
from .pcg_update import pcg_update

# K11's static limits, as csrc/graph_kernels.cu sizes its shared memory,
# its per-thread tangent and its edge pass's argument (kMaxUnk, kMaxRes,
# kMetaMax, kMaxLeaves, kMaxSlots), and its vertex pass's block (kGThreads:
# one partial of <p, A_hat p> a block of VERTEX_THREADS vertices)
MAX_UNKNOWN_CHANNELS = 16
MAX_RESIDUALS = 16
META_MAX = 1024
MAX_LEAVES = 32
MAX_SLOTS = 8
VERTEX_THREADS = 64


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


def graph_hat_edge_plain(t, sq, r, p_prev=None, beta=None):
    """K11's edge pass: per graph group, per slot s, the (E, L_s) rows
    c_s[e, k] = sum_cr D_a[cr, e] t[cr, e] for the slot's k-th leaf a, with
    the tangent t = sum_a D_a (sq p)[unk(a)] at the edge's slot(a) end and
    p = r + beta p_prev."""
    p = r if p_prev is None else r + beta * p_prev
    ps = (sq * p)[t.flat_index]  # (n_unk, N)
    out = []
    for _, n_res, leaves, D, idx in t.graph:
        g = ps[:, idx]  # (n_unk, n_slots, E)
        Dl = D.view(len(leaves), n_res, -1)
        tan = sum(Dl[a] * g[u, s] for a, (s, u) in enumerate(leaves))
        cols = [[] for _ in range(idx.shape[0])]
        for a, (s, _) in enumerate(leaves):
            cols[s].append(torch.sum(Dl[a] * tan, dim=0))
        out.append([torch.stack(c, dim=1) if c
                    else tan.new_zeros((tan.shape[1], 0)) for c in cols])
    return out


def run_sums(x, order, rowptr):
    """out[w] = ((0 + x[e_1]) + x[e_2]) + ... over vertex w's run e_1, e_2,
    ... of the CSR incidence (order, rowptr): the segmented sum in edge
    order from zero, as K10 and K11's vertex pass take it, one rank of
    every run at a time."""
    order, rowptr = order.long(), rowptr.long()
    deg = rowptr[1:] - rowptr[:-1]
    out = x.new_zeros((deg.numel(),) + tuple(x.shape[1:]))
    for k in range(int(deg.max()) if deg.numel() else 0):
        w = torch.nonzero(deg > k).squeeze(1)
        out[w] += x[order[rowptr[w] + k]]
    return out


def hat_vertex_sums(t, c):
    """J^T of the edge rows c (graph_hat_edge_plain's layout) as K11's
    vertex pass sums it: (n_unk, N), per group and slot in order, each
    column's run sums (run_sums) added into its leaf's unknown channel."""
    acc = c[0][0].new_zeros(t.flat_index.shape)
    for (_, _, leaves, _, _), rows, csr in zip(t.graph, c, t.incidence):
        for s, (cs, (order, rowptr)) in enumerate(zip(rows, csr)):
            sums = run_sums(cs, order, rowptr)
            unks = [u for ls, u in leaves if ls == s]
            for k, u in enumerate(unks):
                acc[u] += sums[:, k]
    return acc


def graph_hat_vertex_plain(t, c, sq, scs, r, p_prev=None, beta=None):
    """K11's vertex pass on the edge rows c: (p, A_hat p, partials), with
    partials[b] = <p, A_hat p> over the vertices [b VERTEX_THREADS,
    (b + 1) VERTEX_THREADS)."""
    p = r if p_prev is None else r + beta * p_prev
    acc = hat_vertex_sums(t, c)
    if t.fit is not None:
        ps = (sq * p)[t.flat_index]
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
    dots = torch.sum((p * ap)[t.flat_index], dim=0)  # per vertex
    dots = torch.nn.functional.pad(dots, (0, t.partials.numel()
                                          * VERTEX_THREADS - dots.numel()))
    return p, ap, torch.sum(dots.view(-1, VERTEX_THREADS), dim=1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _float_dtype(name, t):
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: {t.dtype}, not float32 or float64")
    return t.dtype


@kernel("K9.graph_gather")
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
    LAUNCHES["K9.graph_gather"] += 1
    return out


@kernel("K10.graph_scatter")
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
    LAUNCHES["K10.graph_scatter"] += 1
    return out


def _hat_checks(name, t, **tensors):
    """Raise unless the apply's operands (name -> tensor or None) and the
    tables' own buffers are contiguous float32 or int32 CUDA tensors of one
    device, the vectors of the tables' length, p_prev and beta given
    together."""
    if (tensors.get("p_prev") is None) != (tensors.get("beta") is None):
        raise ValueError(f"{name}: p_prev and beta come together")
    n = t.flat_index.numel()
    ints = {k: torch.int32 for k in ("idx", "order", "rowptr", "meta")}
    build.check_tensors(
        name,
        {"sq": (n,), "scs": (n,), "r": (n,), "p_prev": (n,), "beta": ()},
        ints,
        **build.present(D=t.D, idx=t.idx, order=t.order, rowptr=t.rowptr,
                        meta=t.meta, c=t.c, partials=t.partials, **tensors))


@kernel("K11.graph_hat_edge")
def graph_hat_edge(t, sq, r, p_prev=None, beta=None):
    """K11's edge pass alone -- kernel on CUDA, plain on CPU: the rows c
    as graph_hat_edge_plain lays them out; on CUDA the views of the
    tables' c buffer, which the next apply overwrites."""
    if build.all_on_cpu(t.D, sq, r, p_prev, beta):
        return graph_hat_edge_plain(t, sq, r, p_prev, beta)
    _hat_checks("graph_hat_edge", t, sq=sq, r=r, p_prev=p_prev, beta=beta)
    rc = build.library().opt_graph_hat_edge(
        build.ptr(t.D), build.ptr(t.idx), t.meta_host_ptr,
        t.meta.numel(), build.ptr(sq), build.ptr(r), build.ptr(p_prev),
        build.ptr(beta), build.ptr(t.c), build.stream())
    build.check(rc, "graph_hat_edge")
    LAUNCHES["K11.graph_hat_edge"] += 1
    return t.c_rows


@kernel("K11.graph_hat_vertex")
def graph_hat_vertex(t, c, sq, scs, r, p_prev=None, beta=None):
    """K11's vertex pass alone on the edge rows c -- kernel on CUDA, plain
    on CPU: (p, A_hat p, partials); on CUDA c is copied into the tables' c
    buffer unless it is that buffer's views, and partials is the tables'
    buffer, which the next apply overwrites."""
    if build.all_on_cpu(t.D, sq, scs, r, p_prev, beta):
        return graph_hat_vertex_plain(t, c, sq, scs, r, p_prev, beta)
    _hat_checks("graph_hat_vertex", t, sq=sq, scs=scs, r=r, p_prev=p_prev,
                beta=beta)
    for rows, views in zip(c, t.c_rows):
        for x, view in zip(rows, views):
            if x.data_ptr() != view.data_ptr():
                view.copy_(x)
    p = torch.empty_like(r) if p_prev is not None else r
    ap = torch.empty_like(r)
    rc = build.library().opt_graph_hat_vertex(
        build.ptr(t.D), build.ptr(t.order), build.ptr(t.rowptr),
        build.ptr(t.c), build.ptr(t.meta), t.meta.numel(), build.ptr(sq),
        build.ptr(scs), build.ptr(r), build.ptr(p_prev), build.ptr(beta),
        build.ptr(p) if p_prev is not None else None, build.ptr(ap),
        build.ptr(t.partials), t.n_verts, build.stream())
    build.check(rc, "graph_hat_vertex")
    LAUNCHES["K11.graph_hat_vertex"] += 1
    return p, ap, t.partials


@kernel("K11.graph_hat_apply", counts=False)
def graph_hat_apply(t, sq, scs, r, p_prev=None, beta=None):
    """K11: (p, A_hat p, <p, A_hat p>) -- kernel on CUDA (the edge pass,
    then the vertex pass, one C call), plain on CPU.  t: HatTables; beta is
    a 0-d device tensor, given with p_prev; p is a new buffer (r itself
    when p_prev is None)."""
    if build.all_on_cpu(t.D, sq, scs, r, p_prev, beta):
        return graph_hat_apply_plain(t, sq, scs, r, p_prev, beta)
    _hat_checks("graph_hat_apply", t, sq=sq, scs=scs, r=r, p_prev=p_prev,
                beta=beta)
    p = torch.empty_like(r) if p_prev is not None else r
    ap = torch.empty_like(r)
    rc = build.library().opt_graph_hat_apply(
        build.ptr(t.D), build.ptr(t.idx), build.ptr(t.order),
        build.ptr(t.rowptr), build.ptr(t.meta), t.meta_host_ptr,
        t.meta.numel(), build.ptr(sq), build.ptr(scs), build.ptr(r),
        build.ptr(p_prev), build.ptr(beta),
        build.ptr(p) if p_prev is not None else None, build.ptr(ap),
        build.ptr(t.c), build.ptr(t.partials), t.n_verts, build.stream())
    build.check(rc, "graph_hat_apply")
    LAUNCHES["K11.graph_hat_edge"] += 1
    LAUNCHES["K11.graph_hat_vertex"] += 1
    return p, ap, torch.sum(t.partials)



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
            if (len(leaves) > MAX_LEAVES
                    or len(g.graph.slots) > MAX_SLOTS):
                return None
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
    n_meta = 3 + 2 * len(unk) + sum(
        7 + 3 * len(gg["leaves"]) + 2 * len(gg["slots"])
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
    incidences, the int table meta (its layout is in csrc/graph_kernels.cu)
    on the device and as meta_host on the host, the scratch that its two
    passes share, made once: c (the edge pass's rows, each slot's block at
    a multiple of 4 floats) and partials (one float a vertex block); and
    the same as structured views for the plain versions:

      graph  [(gi, n_res, leaves [(slot, unk)], D (n_leaves n_res, E),
               idx (n_slots, E))] per graph group
      incidence  [[(order (E,), rowptr (N + 1,)) per slot]] per graph group
      c_rows [[(E, L_s) view of c per slot]] per graph group, L_s the
             leaves on slot s
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
        self.incidence, c_blocks = [], []  # c_blocks: [[(off, E, L_s)]]
        d_off = i_off = rp_off = c_off = 0
        for gg in meta["graph_groups"]:
            slots = gg["slots"]
            stack = torch.stack([data["graph_indices"][gg["gname"]][s]
                                 for s in slots])
            csr = [data["graph_incidence"][gg["gname"]][s] for s in slots]
            E_ = stack.shape[1]
            rows = len(gg["leaves"]) * gg["n_res"]
            self._blocks.append((gg, rows, E_, stack))
            self.incidence.append(csr)
            idx.append(stack.reshape(-1))
            order += [o for o, _ in csr]
            rowptr += [r for _, r in csr]
            table += [E_, len(slots), gg["n_res"], len(gg["leaves"]), d_off,
                      i_off, rp_off]
            table += [s for s, _ in gg["leaves"]]
            table += [u for _, u in gg["leaves"]]
            c_blocks.append([])
            for k in range(len(slots)):
                cols = [u for s, u in gg["leaves"] if s == k]
                table += [c_off, len(cols)] + cols
                c_blocks[-1].append((c_off, E_, len(cols)))
                c_off += -(-E_ * len(cols) // 4) * 4  # 16-byte aligned
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
        if max(d_off, c_off, len(bases) * n_verts) >= 2 ** 31:
            raise ValueError("graph engine: more than 2^31 - 1 partials, "
                             "edge rows or unknowns")
        self.idx, self.order, self.rowptr = (torch.cat(ts)
                                             for ts in (idx, order, rowptr))
        self.meta_host = np.asarray(table, np.int32)
        self.meta_host_ptr = self.meta_host.ctypes.data
        self.meta = torch.as_tensor(self.meta_host).to(device)
        self.c = torch.empty(c_off, dtype=torch.float32, device=device)
        self.c_rows = [[self.c[o:o + e * w].view(e, w) for o, e, w in blk]
                       for blk in c_blocks]
        self.partials = torch.empty(-(-n_verts // VERTEX_THREADS),
                                    dtype=torch.float32, device=device)
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

        return classic_pcg(hat_apply, pcg_update, torch.dot, b_hat, sp,
                           self.uses_lambda)
