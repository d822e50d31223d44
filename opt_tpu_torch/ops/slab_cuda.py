"""The kernels of a sharded solve: the streamed engines' apply and outer
step over a batch of extended slabs (parallel/stream_shard.py), on
hand-written CUDA.

  K15 warp_slab_apply     A_hat p = sq J^T J (sq p) at the own rows of
                          every slab: image_warping (csrc/stream_kernels.cu)
  K16 vol_slab_apply      the same for volumetric ARAP on D slabs
                          (csrc/stream3d_kernels.cu)
  K3 warp_slab_linearize  K3's global-offset mode: J^T F, diag(J^T J) and
                          the cost (or LM's model cost) at the own rows
                          (csrc/warp_kernels.cu)
  K8 vol_slab_linearize   K8's, on D slabs (csrc/vol_kernels.cu)

They replace the two TPU kernels of opt_tpu/parallel/stream_shard.py,
ShardedStreamEngine.build_apply_kernel (:158) and
ShardedStream3D.build_apply_kernel (:610).  Each of those runs one
device's slab; here one launch runs every slab that the process holds,
one per blockIdx.z, so the slab form of a mesh (all slabs on one card)
pays one launch per apply, not one per slab.

The operands (geometry `g` = (n, he, row0, total), parallel/mesh.py):
S extended slabs of n own rows (D planes) with he halo rows on each side,
slab s's row 0 at global row row0 + s n of a grid of `total` rows.  x, sq
and p are (S, m): each slab's flat unknown layout over its n + 2 he rows
(image_warping: Offset then Angle, m = 3 (n + 2 he) W; volumetric ARAP:
m = 6 (n + 2 he) H W), one slab after another; the constants are
(S, n + 2 he, ..., C).  Outputs cover the own rows only, in the local
layout of parallel/mesh.SlabLayout (every unknown's (S, n, ..., C) slabs,
flattened and concatenated: in the slab form the global layout itself).
The energy's InBounds tests global rows, so a zero-filled halo row past
the global edge is no neighbour (csrc/warp_energy.cuh Grid,
csrc/vol_energy.cuh Vol).

Bound on the card: device memory.  K15 reads x's Angle (4 B a pixel), sq
and p (24 B), UrShape (8 B) and Mask (4 B) on its own rows and one halo
row a side, Constraints (8 B) at its own pixels, and writes A_hat p
(12 B): at 2048^2 on 4 slabs of 512 + 2 x 2 rows, 252.3 MB a launch.  K16
reads the angles, UrShape, sq and p (72 B a voxel) on its own planes and
one halo plane a side, Constraints' channel 0 (4 B) on its own planes,
and writes 24 B: at 128^3 on 4 slabs of 32 + 2 x 2 planes, 219 MB a
launch.  K15 runs on K1's row-marching core (csrc/warp_tile.cuh), a
warp marching a strip of 32 columns down a chunk of own rows; K16 on K6's
shared-memory tile core (csrc/vol_tile.cuh), a block marching a tile of
columns through a chunk of own planes.  No reductions inside: the slab loop takes its dots
outside, as the TPU kernel's loop does.  K3 and K8 keep their per-block
cost partials, in slab order, summed per slab by the wrappers.

Beside each wrapper sits its plain torch version (the *_plain functions),
built on the whole-grid plain versions with the global bounds; the
wrappers run them for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build
from .vol_cuda import (linearize_fields as vol_fields, vol_jtj_apply_plain,
                       vol_linearize)
from .warp_cuda import (_split, linearize_fields as warp_fields,
                        warp_jtj_apply_plain, warp_linearize)


def _own(g):
    n, he = g[0], g[1]
    return slice(he, he + n)


def _slab_bounds(g, s):
    """(global row of slab s's array row 0, global rows)."""
    n, _, row0, total = g
    return row0 + s * n, total


def _local(parts_by_slab):
    """Local flat layout from per-slab (Offset part, Angle part) pairs."""
    return torch.cat([torch.stack(parts).reshape(-1)
                      for parts in zip(*parts_by_slab)])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def warp_slab_apply_plain(x, ur, cons, mask, params, sq, p, g):
    """A_hat p at every slab's own rows, in the local layout."""
    S, Hs, W = mask.shape[:3]
    own = _own(g)
    out = []
    for s in range(S):
        jtj, _ = warp_jtj_apply_plain(x[s], sq[s] * p[s], ur[s], cons[s],
                                      mask[s], params,
                                      rows=_slab_bounds(g, s))
        o, a = _split(sq[s] * jtj, Hs, W)
        out.append((o[own], a[own]))
    return _local(out)


def warp_slab_linearize_plain(x, ur, cons, mask, params, g, cost_only=False,
                              delta=None):
    """(J^T F, diag(J^T J)) at every slab's own rows in the local layout
    (None when cost_only or given delta) and the (S,) per-slab masked costs
    of the residuals centred on own rows (LM's model cost given delta)."""
    derivs = not (cost_only or delta is not None)
    own = _own(g)
    costs, jtf, diag = [], [], []
    for s in range(x.shape[0]):
        jO, jA, gO, gA, ssq = warp_fields(
            x[s], ur[s], cons[s], mask[s], params, derivs,
            None if delta is None else delta[s], rows=_slab_bounds(g, s))
        costs.append(0.5 * torch.sum(ssq[own]))
        if derivs:
            jtf.append((jO[own], jA[own]))
            diag.append((gO[own], gA[own]))
    costs = torch.stack(costs)
    if not derivs:
        return None, None, costs
    return _local(jtf), _local(diag), costs


def vol_slab_apply_plain(x, ur, cons, params, sq, p, g):
    """A_hat p at every D slab's own planes, in the local layout."""
    S, Ds = ur.shape[:2]
    own = _own(g)
    out = []
    for s in range(S):
        jtj, _ = vol_jtj_apply_plain(x[s], sq[s] * p[s], ur[s], cons[s],
                                     params, planes=_slab_bounds(g, s))
        ap = (sq[s] * jtj).view(2, Ds, *ur.shape[2:])
        out.append((ap[0, own], ap[1, own]))
    return _local(out)


def vol_slab_linearize_plain(x, ur, cons, params, g, cost_only=False,
                             delta=None):
    """K8's offset mode in plain torch: as warp_slab_linearize_plain."""
    derivs = not (cost_only or delta is not None)
    own = _own(g)
    costs, jtf, diag = [], [], []
    for s in range(x.shape[0]):
        jO, jA, gO, gA, ssq = vol_fields(
            x[s], ur[s], cons[s], params, derivs,
            None if delta is None else delta[s], planes=_slab_bounds(g, s))
        costs.append(0.5 * torch.sum(ssq[own]))
        if derivs:
            jtf.append((jO[own], jA[own]))
            diag.append((gO[own][..., None].expand_as(jO[own]), gA[own]))
    costs = torch.stack(costs)
    if not derivs:
        return None, None, costs
    return _local(jtf), _local(diag), costs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _warp_shapes(S, Hs, W):
    m = (S, 3 * Hs * W)
    return {"x": m, "sq": m, "p": m, "delta": m, "ur": (S, Hs, W, 2),
            "cons": (S, Hs, W, 2), "mask": (S, Hs, W, 1), "params": (2,)}


def _vol_shapes(S, Ds, H, W):
    m = (S, 6 * Ds * H * W)
    return {"x": m, "sq": m, "p": m, "delta": m, "ur": (S, Ds, H, W, 3),
            "cons": (S, Ds, H, W, 3), "params": (2,)}


def _check_geometry(name, g, rows):
    n, he, _, _ = g
    if n < 1 or he < 1 or rows != n + 2 * he:
        raise ValueError(f"{name}: {rows} array rows for {n} own rows and "
                         f"a halo of {he}")


def warp_slab_apply(x, ur, cons, mask, params, sq, p, g):
    """K15: A_hat p at every slab's own rows -- kernel on CUDA, plain on
    CPU."""
    if build.all_on_cpu(x, ur, cons, mask, params, sq, p):
        return warp_slab_apply_plain(x, ur, cons, mask, params, sq, p, g)
    S, Hs, W = mask.shape[:3]
    _check_geometry("warp_slab_apply", g, Hs)
    build.check_tensors("warp_slab_apply", _warp_shapes(S, Hs, W), x=x,
                        ur=ur, cons=cons, mask=mask, params=params, sq=sq,
                        p=p)
    n, he, row0, total = g
    lib = build.library()
    ap = torch.empty(3 * S * n * W, dtype=p.dtype, device=p.device)
    rc = lib.opt_warp_slab_apply(
        *map(build.ptr, (x, ur, cons, mask, params, sq, p, ap)), S, n, he,
        W, row0, total, build.stream())
    build.check(rc, "warp_slab_apply")
    warp_slab_apply.launches += 1
    return ap


def warp_slab_linearize(x, ur, cons, mask, params, g, cost_only=False,
                        delta=None):
    """K3's global-offset mode: (J^T F, diag, (S,) per-slab costs) --
    kernel on CUDA, plain on CPU.  Counted as a K3 launch."""
    if build.all_on_cpu(x, ur, cons, mask, params, delta):
        return warp_slab_linearize_plain(x, ur, cons, mask, params, g,
                                         cost_only, delta)
    S, Hs, W = mask.shape[:3]
    _check_geometry("warp_slab_linearize", g, Hs)
    build.check_tensors("warp_slab_linearize", _warp_shapes(S, Hs, W),
                        **build.present(x=x, ur=ur, cons=cons, mask=mask,
                                        params=params, delta=delta))
    n, he, row0, total = g
    lib = build.library()
    mode, jtf, diag = _mode(cost_only, delta, 3 * S * n * W, x)
    parts = torch.empty(build.coop_blocks(
        lib.opt_warp_linearize_blocks(S, n, W, mode), "warp_slab_linearize"),
        dtype=x.dtype, device=x.device)
    rc = lib.opt_warp_slab_linearize(
        *map(build.ptr, (x, ur, cons, mask, params, delta, jtf, diag,
                         parts)), S, n, he, W, row0, total, mode,
        build.stream())
    build.check(rc, "warp_slab_linearize")
    warp_linearize.launches += 1
    return jtf, diag, parts.view(S, -1).sum(1)


def vol_slab_apply(x, ur, cons, params, sq, p, g):
    """K16: A_hat p at every D slab's own planes -- kernel on CUDA, plain
    on CPU."""
    if build.all_on_cpu(x, ur, cons, params, sq, p):
        return vol_slab_apply_plain(x, ur, cons, params, sq, p, g)
    S, Ds, H, W = ur.shape[:4]
    _check_geometry("vol_slab_apply", g, Ds)
    build.check_tensors("vol_slab_apply", _vol_shapes(S, Ds, H, W), x=x,
                        ur=ur, cons=cons, params=params, sq=sq, p=p)
    n, he, d0, total = g
    lib = build.library()
    ap = torch.empty(6 * S * n * H * W, dtype=p.dtype, device=p.device)
    rc = lib.opt_vol_slab_apply(
        *map(build.ptr, (x, ur, cons, params, sq, p, ap)), S, n, he, H, W,
        d0, total, build.stream())
    build.check(rc, "vol_slab_apply")
    vol_slab_apply.launches += 1
    return ap


def vol_slab_linearize(x, ur, cons, params, g, cost_only=False,
                       delta=None):
    """K8's global-offset mode: (J^T F, diag, (S,) per-slab costs) --
    kernel on CUDA, plain on CPU.  Counted as a K8 launch."""
    if build.all_on_cpu(x, ur, cons, params, delta):
        return vol_slab_linearize_plain(x, ur, cons, params, g, cost_only,
                                        delta)
    S, Ds, H, W = ur.shape[:4]
    _check_geometry("vol_slab_linearize", g, Ds)
    build.check_tensors("vol_slab_linearize", _vol_shapes(S, Ds, H, W),
                        **build.present(x=x, ur=ur, cons=cons, params=params,
                                        delta=delta))
    n, he, d0, total = g
    lib = build.library()
    mode, jtf, diag = _mode(cost_only, delta, 6 * S * n * H * W, x)
    parts = torch.empty(build.coop_blocks(
        lib.opt_vol_linearize_blocks(S, n, H, W, mode), "vol_slab_linearize"),
        dtype=x.dtype, device=x.device)
    rc = lib.opt_vol_slab_linearize(
        *map(build.ptr, (x, ur, cons, params, delta, jtf, diag, parts)), S,
        n, he, H, W, d0, total, mode, build.stream())
    build.check(rc, "vol_slab_linearize")
    vol_linearize.launches += 1
    return jtf, diag, parts.view(S, -1).sum(1)


def _mode(cost_only, delta, size, x):
    """(kernel mode, J^T F and diag buffers or None): 0 both and the
    cost, 1 the cost alone, 2 the model cost."""
    if delta is not None:
        return 2, None, None
    if cost_only:
        return 1, None, None
    return 0, x.new_empty(size), x.new_empty(size)


warp_slab_apply.launches = 0
vol_slab_apply.launches = 0
