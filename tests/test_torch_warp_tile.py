"""The algebra of the row-marching 2-D apply core (csrc/warp_tile.cuh) that
K1 warp_jtj_apply, K4 warp_hat_apply and K15 warp_slab_apply run on, on
the CPU.

The kernels cannot run here, so a torch rendering of their decomposition
stands in for them: `march` walks a grid strip by strip (a warp of 32
lanes, one a column: 30 own columns and the column on each side of them)
and chunk by chunk of own rows, one row at a time, and forms each
image_warping residual's jp once per (pixel, offset), in the kernel's
order at each row: the H pair r_{i-1,+H}, r_{i,-H} with the row before,
each half into its pixel's sums; the row before, now whole, gets its fit
term and is written at the own columns; then each pixel's two W
residuals, the neighbour's operand and UrShape taken from the lane beside
it (the edge lanes have one neighbour in the warp), the centre halves
into the pixel's sums; then the W halves each pixel is handed, from the
lane before and then the lane after.  A chunk's face rows are read for
the pair that crosses them.  It is held (rtol 1e-5) against:

* warp_jtj_apply_plain, warp_hat_apply_plain and warp_slab_apply_plain,
  the versions the kernels are held to on the card: at ragged W and H
  (K4 also at widths of 0, 1 and 29 mod 30 on fewer rows than a chunk's
  least, in its four modes), with and without LM's ctc or scs, with
  excluded pixels beside the strips' edges and negative Constraints, in
  the kernel's chunks and in chunks of 4 and 1 rows; on 3 slabs of 1 and
  of 17 rows with a halo of 2, the first slab's halo before the global
  edge and the last's past it;
* the JAX package: J^T J p through its linearize of energies.image_warping
  at 37x23, and ShardedStreamEngine.build_apply_kernel in interpret mode
  on 4 slabs (as tests/test_torch_shard_stream.py runs it, at its gates'
  128 x 8 rows).

The JAX references are built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opt_tpu.parallel import stream_shard as jss
from opt_tpu_torch.ops import slab_cuda, stream_cuda, warp_cuda
from opt_tpu_torch.ops.warp_cuda import _split
from tests.test_torch_evaluate import assert_close, plans
from tests.test_torch_plan_fns import pack
from tests.test_torch_shard_stream import N, W2, WARP, _jax_apply, _mesh
from tests.test_torch_shard_stream import _plans, _t

torch.set_num_threads(1)

RTOL = 1e-5
STRIP, OWN = 32, 30  # kStrip lanes a warp, kOwn of them own columns
STRIP_WARPS, MARCH_MIN = 4, 4  # kStripWarps, kMarchMin
# blocks a card holds at once (warp_tile_capacity): an H100's 132 SMs at 5
# blocks each, for the rendering's default chunks
CAPACITY = 660
SIZES = [(37, 23), (70, 9), (33, 1), (1, 5), (61, 6)]


def tile_gx(W):
    """warp_tile_gx: blocks along W."""
    return -(-(-(-W // OWN)) // STRIP_WARPS)


def tile_rows(S, n, W, capacity=CAPACITY):
    """warp_tile_rows: the own rows a warp marches."""
    chunks = max(1, capacity // (S * tile_gx(W)))
    return max(MARCH_MIN, -(-n // chunks))


# ---------------------------------------------------------------------------
# the rendering
# ---------------------------------------------------------------------------


def _residual(c, nO, nU, valid, w_reg):
    """jp of the residuals centred at the row segment c reading (nO, nU),
    zero where not valid; the centre halves go into c's sums."""
    e = c["U"] - nU
    s, co = c["s"], c["c"]
    G = torch.stack((-s * e[:, 0] - co * e[:, 1], co * e[:, 0] - s * e[:, 1]),
                    -1)
    jp = w_reg * ((c["O"] - nO) - G * c["A"][:, None])
    jp = torch.where(valid[:, None], jp, torch.zeros(()))
    c["aO"] = c["aO"] + w_reg * jp
    c["aA"] = c["aA"] + (-w_reg * G * jp).sum(-1)
    return jp


def march(x, ur, cons, mask, params, v, own=None, rows_at=None, rows=None):
    """J^T J v at the own rows [lo, hi) of an (H, W) array (all of them by
    default), as the core's warps form it, in chunks of `rows` own rows
    (warp_tile_rows's by default); rows_at = (row0, Hg) places array row 0
    at global row row0 of Hg (an extended slab).  Returns the (Offset
    (H, W, 2), Angle (H, W)) parts with the fit term, zero off the own
    rows and at excluded pixels."""
    H, W = mask.shape[:2]
    w_fit, w_reg = params[0], params[1]
    _, ang = _split(x, H, W)
    vO, vA = _split(v, H, W)
    lo, hi = own or (0, H)
    row0, Hg = rows_at or (0, H)
    rows = rows or tile_rows(1, hi - lo, W)
    keep = mask.view(H, W) == 0
    fit = (cons >= 0).all(-1)
    sn, cs = torch.sin(ang), torch.cos(ang)
    outO, outA = torch.zeros_like(vO), torch.zeros_like(vA)
    inside = lambda i: 0 <= i < H and 0 <= row0 + i < Hg

    def seg(i, cols):
        """Row i at the columns cols (a list; -1 or W: no pixel)."""
        ok = torch.tensor([0 <= j < W for j in cols])
        jj = torch.tensor([min(max(j, 0), W - 1) for j in cols])
        return {"O": vO[i, jj], "A": vA[i, jj], "U": ur[i, jj], "s": sn[i, jj],
                "c": cs[i, jj], "keep": keep[i, jj] & ok & inside(i),
                "aO": torch.zeros(len(cols), 2), "aA": torch.zeros(len(cols))}

    for w0 in range(0, W, OWN):
        lanes = list(range(w0 - 1, w0 - 1 + STRIP))
        mine = [j for j in lanes[1:-1] if j < W]  # the columns written
        at = slice(1, 1 + len(mine))
        for c0 in range(lo, hi, rows):
            c1 = min(c0 + rows, hi)
            prev = None
            for i in range(c0 - 1, c1 + 1):
                cur = seg(i, lanes) if inside(i) else None
                if prev is not None and cur is not None:
                    # the H pair: r_{i-1,+H}, then r_{i,-H}
                    both = prev["keep"] & cur["keep"]
                    jp = _residual(prev, cur["O"], cur["U"], both, w_reg)
                    cur["aO"] = cur["aO"] - w_reg * jp
                    jp = _residual(cur, prev["O"], prev["U"], both, w_reg)
                    prev["aO"] = prev["aO"] - w_reg * jp
                if prev is not None and i - 1 >= c0 and mine:
                    # the row before is whole: its fit term, its output
                    k = prev["keep"][at]
                    f = (k & fit[i - 1, mine])[:, None]
                    aO = prev["aO"][at] + torch.where(
                        f, w_fit * (w_fit * prev["O"][at]), torch.zeros(()))
                    outO[i - 1, mine] = torch.where(k[:, None], aO,
                                                    torch.zeros(()))
                    outA[i - 1, mine] = torch.where(k, prev["aA"][at],
                                                    torch.zeros(()))
                if cur is not None and c0 <= i < c1:
                    none = torch.zeros(1, dtype=torch.bool)
                    # the right neighbour: the next lane (lane 31: none)
                    down = lambda a: torch.cat((a[1:], a[-1:]))  # lane + 1
                    up = lambda a: torch.cat((a[:1], a[:-1]))  # lane - 1
                    # the right neighbour: the next lane (lane 31: none)
                    nk = torch.cat((cur["keep"][1:], none))
                    jr = _residual(cur, down(cur["O"]), down(cur["U"]),
                                   cur["keep"] & nk, w_reg)
                    # the left neighbour: the lane before (lane 0: none)
                    nk = torch.cat((none, cur["keep"][:-1]))
                    jl = _residual(cur, up(cur["O"]), up(cur["U"]),
                                   cur["keep"] & nk, w_reg)
                    # the halves handed on: from the lane before, then the
                    # lane after (lanes 0 and 31 take their own back)
                    cur["aO"] = cur["aO"] - w_reg * up(jr)
                    cur["aO"] = cur["aO"] - w_reg * down(jl)
                prev = cur
    return outO, outA


def jtj_march(x, p, ur, cons, mask, params, ctc=None, rows=None):
    """K1's function by the march: (mask(J^T J p + ctc p), <p, Ap>)."""
    H, W = mask.shape[:2]
    O, A = march(x, ur, cons, mask, params, p, rows=rows)
    ap = torch.cat((O.reshape(-1), A.reshape(-1)))
    if ctc is not None:
        keep = warp_cuda._flat_keep(mask.view(H, W) == 0)
        ap = ap + torch.where(keep, ctc * p, torch.zeros(()))
    return ap, torch.dot(p, ap)


def hat_march(x, ur, cons, mask, params, sq, scs, r, p_prev=None,
              beta=None, rows=None):
    """K4's function by the march: p = r + beta p_prev (r alone without
    p_prev), A_hat p = sq J^T J (sq p) (+ scs p), zero at excluded pixels,
    and <p, A_hat p>."""
    H, W = mask.shape[:2]
    p = r if p_prev is None else r + beta * p_prev
    O, A = march(x, ur, cons, mask, params, sq * p, rows=rows)
    ap = sq * torch.cat((O.reshape(-1), A.reshape(-1)))
    if scs is not None:
        keep = warp_cuda._flat_keep(mask.view(H, W) == 0)
        ap = ap + torch.where(keep, scs * p, torch.zeros(()))
    return p, ap, torch.dot(p, ap)


def slab_march(x, ur, cons, mask, params, sq, p, g, rows=None):
    """K15's function by the march: A_hat p at every slab's own rows, in
    the local layout."""
    n, he, row0, total = g
    S, Hs, W = mask.shape[:3]
    rows = rows or tile_rows(S, n, W)
    own = slice(he, he + n)
    out = []
    for s in range(S):
        O, A = march(x[s], ur[s], cons[s], mask[s], params, sq[s] * p[s],
                     own=(he, he + n), rows_at=(row0 + s * n, total),
                     rows=rows)
        sO, sA = _split(sq[s], Hs, W)
        out.append(((sO * O)[own], (sA * A)[own]))
    return slab_cuda._local(out)


# ---------------------------------------------------------------------------
# against the plain versions
# ---------------------------------------------------------------------------


def _operands(W, H, seed=15):
    """kernel_operands on the CPU, with excluded pixels beside the strips'
    edge columns and on a chunk's first row where the grid has them, and
    one negative Constraints channel on a constrained row."""
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(
        torch, W, H, torch.device("cpu"), seed)
    cons[0, -1, 1] = -0.5
    for i, j in ((1, 31), (H - 1, 32), (4, 0), (4, 63), (5, 64)):
        if i < H and j < W:
            mask[i, j] = 1.0
    return x, ur, cons, mask, params, t


@pytest.mark.parametrize("capacity", [1, 660, 924])
def test_tile_rows_make_one_wave(capacity):
    """The chunk rule: the fewest rows (4 at least) whose grid the card
    holds at once, at the paths' grids and a ragged one."""
    for S, n, W in ((1, 2048, 2048), (4, 512, 2048), (1, 512, 512),
                    (3, 17, 37)):
        rows = tile_rows(S, n, W, capacity)
        blocks = lambda r: S * tile_gx(W) * -(-n // r)
        if rows > MARCH_MIN:
            assert blocks(rows) <= max(capacity, S * tile_gx(W))
            assert blocks(rows - 1) > capacity


@pytest.mark.parametrize("rows", [None, 4, 1])
@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", SIZES)
def test_march_matches_plain_jtj_apply(W, H, lm, rows):
    x, ur, cons, mask, params, t = _operands(W, H)
    assert (cons < 0).any() and (mask != 0).any()
    args = (x, t["p"], ur, cons, mask, params, t["ctc"] if lm else None)
    got = jtj_march(*args, rows=rows)
    want = warp_cuda.warp_jtj_apply_plain(*args)
    assert_close(got[0].numpy(), want[0].numpy(), RTOL, "Ap")
    assert float(got[1]) == pytest.approx(float(want[1]), rel=RTOL)


# K4's grids: a ragged one, widths of 0, 1 and 29 mod OWN on fewer rows
# than MARCH_MIN, one pixel
HAT_SIZES = [(37, 23), (60, 3), (61, 2), (59, 1), (1, 1)]


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("W,H", HAT_SIZES)
def test_march_matches_plain_hat_apply(W, H, lm, prev):
    """K4's four modes on the march against warp_hat_apply_plain, the
    grid's border excluded besides _operands' pixels."""
    x, ur, cons, mask, params, t = _operands(W, H)
    for edge in (mask[0], mask[-1], mask[:, 0], mask[:, -1]):
        edge[: max(1, len(edge) // 2)] = 1.0
    beta = torch.tensor(0.61)
    args = (x, ur, cons, mask, params, t["sq"], t["scs"] if lm else None,
            t["r"]) + ((t["p"], beta) if prev else ())
    got = hat_march(*args)
    want = stream_cuda.warp_hat_apply_plain(*args)
    assert_close(got[0].numpy(), want[0].numpy(), RTOL, "p")
    assert_close(got[1].numpy(), want[1].numpy(), RTOL, "A_hat p")
    assert float(got[2]) == pytest.approx(float(want[2]), rel=RTOL)


@pytest.mark.parametrize("rows", [None, 4])
@pytest.mark.parametrize("n", [1, 17])
def test_march_on_slabs_matches_plain(n, rows):
    """3 slabs of n own rows at W = 37, a halo of 2."""
    x, ur, cons, mask, params, t, g = chip_smoke.slab_operands(
        torch, 37, 3 * n, 3, torch.device("cpu"), seed=16)
    assert g[:2] == (n, 2)
    got = slab_march(x, ur, cons, mask, params, t["sq"], t["p"], g, rows)
    want = slab_cuda.warp_slab_apply_plain(x, ur, cons, mask, params,
                                           t["sq"], t["p"], g)
    assert_close(got.numpy(), want.numpy(), RTOL, "A_hat p")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_jtj():
    """At 37x23 on kernel_inputs (an excluded pixel, a constraint band,
    angles ~0.3 rad): the port's bound operands, p, and J^T J p through
    JAX's linearize, masked as K1 masks it."""
    W, H = 37, 23
    inputs = chip_smoke.kernel_inputs(W, H, seed=17)[0]
    inputs["Mask"][1, 31] = inputs["Mask"][7, 32] = 1.0
    jplan, tplan = plans("image_warping", [W, H])
    jx, jdata = jplan.bind(inputs)
    f = jplan.funcs
    masks = f.unknown_masks(jx, jdata)
    rng = np.random.RandomState(18)
    p = f.mask_unknown_tree(
        {n: jnp.asarray(rng.randn(*s).astype(np.float32))
         for n, s in f.unknown_shapes.items()}, masks)
    _, jvp, jt = f.linearize(jx, jdata)
    names = ("Offset", "Angle")
    ref = pack(f.mask_unknown_tree(jt(jvp(p)), masks), names)
    tx, tdata = tplan.bind(inputs)
    op = warp_cuda.WarpOperator(tdata)
    return tx, op, torch.as_tensor(pack(p, names)), ref


@pytest.mark.parametrize("rows", [None, 4])
def test_march_matches_jax_linearize(jax_jtj, rows):
    x, op, p, ref = jax_jtj
    ap, pap = jtj_march(x, p, op.ur, op.cons, op.mask_img, op.params,
                        rows=rows)
    assert_close(ap.numpy(), ref, RTOL, "J^T J p")
    assert float(pap) == pytest.approx(float(p.numpy() @ ref), rel=RTOL)


def test_march_on_slabs_matches_the_tpu_kernel():
    """4 slabs of 8 rows at W = 128 (the JAX gates), he = 8, against
    ShardedStreamEngine's apply kernel in interpret mode on every slab."""
    jplan, _ = _plans(WARP, [W2, 4 * 8])
    eng = jss.ShardedStreamEngine(jplan, _mesh())
    kern = jax.jit(eng.build_apply_kernel(interpret=True))
    n, he, h = eng.n_local, eng.he, eng.h
    rows = n + 2 * he
    rng = np.random.RandomState(19)
    f = lambda *s: rng.randn(N, rows, W2, *s).astype(np.float32)
    off, ang, ur = 0.3 * f(2), 0.4 * f(1), f(2)
    cons = np.where(rng.rand(N, rows, W2, 2) < 0.3, f(2), -1.0)
    mask = (rng.rand(N, rows, W2, 1) < 0.05).astype(np.float32)
    sq = np.where(mask == 0, rng.rand(N, rows, W2, 3), 0).astype(np.float32)
    p = f(3)
    params = np.array([0.7, 1.3], np.float32)
    g = (n, he, -he, N * n)
    flat = lambda o, a: _t(np.concatenate(
        [o.reshape(N, -1), a.reshape(N, -1)], 1))
    got = slab_march(flat(off, ang), _t(ur), _t(cons.astype(np.float32)),
                     _t(mask), _t(params), flat(sq[..., :2], sq[..., 2:]),
                     flat(p[..., :2], p[..., 2:]), g, rows=4)
    got_o = got[:2 * N * n * W2].view(N, n, W2, 2).numpy()
    got_a = got[2 * N * n * W2:].view(N, n, W2).numpy()
    pad = ((0, 0), (h, h), (0, 0))
    own = slice(he, he + n)
    for s in range(N):  # the first, two interior and the last slab
        ins = np.stack([ang[s, ..., 0], off[s, ..., 0], off[s, ..., 1],
                        cons[s, ..., 0], cons[s, ..., 1], mask[s, ..., 0],
                        ur[s, ..., 0], ur[s, ..., 1], sq[s, ..., 2],
                        sq[s, ..., 0], sq[s, ..., 1]]).astype(np.float32)
        pp = np.stack([p[s, ..., 2], p[s, ..., 0], p[s, ..., 1]])
        out = _jax_apply(kern, ins, pp, params, s * n - he, pad)
        assert_close(got_o[s], np.stack([out[1, own], out[2, own]], -1),
                     RTOL, f"slab {s} Offset")
        assert_close(got_a[s], out[0, own], RTOL, f"slab {s} Angle")
