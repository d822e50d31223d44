"""The algebra of K3 warp_linearize's march on the row-marching 2-D core
(csrc/warp_kernels.cu warp_linearize_march, beside csrc/warp_tile.cuh's
apply march), on the CPU.

The kernel cannot run here, so a torch rendering of its decomposition
stands in for it: `march` walks a grid strip by strip (a warp of 32
lanes, one a column: 30 own columns and the column on each side of them)
and chunk by chunk of own rows, one row at a time, and forms each
image_warping reg residual once, by its centre, in the kernel's order at
each row: the H pair r_{i-1,+H}, r_{i,-H} with the row before, each
centre keeping its r^2 and (full mode) its halves, -w_reg r handed to the
other; the row before, now whole, adds its fit term and, at an own column,
its cost (where Mask is 0) and output; then each pixel's two W residuals,
the neighbour's Offset, UrShape and delta taken from the lane beside it
(the edge lanes have one neighbour in the warp), and (full mode) the W
halves each pixel is handed, from the lane before and then the lane
after.  In the cost modes only own pixels form residuals; in full mode the
edge lanes and the face rows form theirs too and hand their halves in, but
count no cost.  Diag's Offset part is w_reg^2 per residual half: two for
each valid residual a pixel centres.  It is held (rtol 1e-5) against:

* warp_linearize_plain and warp_slab_linearize_plain, the versions the
  kernel is held to on the card, in each mode (J^T F, diag and the cost;
  the cost alone; LM's model cost): at ragged W and H, with excluded
  pixels beside the strips' edges and negative Constraints, in the
  kernel's chunks and in chunks of 4 and 1 rows; on 3 slabs of 1 and of
  17 rows with a halo of 2, the first slab's halo before the global edge
  and the last's past it, the whole grid's cost the sum of the slabs';
* the JAX package: J^T F, diag(J^T J), the cost and LM's model cost
  through its linearize of energies.image_warping at 37x23.

The JAX reference is built once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opt_tpu_torch.ops import slab_cuda, warp_cuda
from opt_tpu_torch.ops.warp_cuda import _split
from tests.test_torch_evaluate import assert_close, plans
from tests.test_torch_plan_fns import pack
from tests.test_torch_warp_tile import OWN, SIZES, STRIP, tile_rows

torch.set_num_threads(1)

RTOL = 1e-5
MODES = ["full", "cost_only", "model_cost"]
NAMES = ("Offset", "Angle")


# ---------------------------------------------------------------------------
# the rendering
# ---------------------------------------------------------------------------


def _centre(c, n, valid, w_reg, mode):
    """The reg residuals centred at the lanes c reading their neighbours n
    (Offset, UrShape, delta), zero where not valid: r, plus J delta in the
    model cost.  r^2 goes into c's ssq; in full mode c's halves go into its
    sums and two w_reg^2 halves into its diag count."""
    zero = torch.zeros(())
    e = c["U"] - n["U"]
    s, co = c["s"], c["c"]
    rot = torch.stack((co * e[:, 0] - s * e[:, 1], s * e[:, 0] + co * e[:, 1]),
                      -1)
    G = torch.stack((-s * e[:, 0] - co * e[:, 1], co * e[:, 0] - s * e[:, 1]),
                    -1)
    r = w_reg * ((c["O"] - n["O"]) - rot)
    if mode == "model_cost":
        r = r + w_reg * ((c["d"] - n["d"]) - G * c["dA"][:, None])
    r = torch.where(valid[:, None], r, zero)
    c["ssq"] = c["ssq"] + (r * r).sum(-1)
    if mode == "full":
        Gw = torch.where(valid[:, None], -w_reg * G, zero)
        c["j"] = c["j"] + w_reg * r
        c["jA"] = c["jA"] + (Gw * r).sum(-1)
        c["gA"] = c["gA"] + (Gw * Gw).sum(-1)
        c["nreg"] = c["nreg"] + 2 * valid
    return r


def march(x, ur, cons, mask, params, mode="full", delta=None, own=None,
          rows_at=None, rows=None):
    """K3's march over the own rows [lo, hi) of an (H, W) array (all of
    them by default), in chunks of `rows` own rows (warp_tile_rows's by
    default); rows_at = (row0, Hg) places array row 0 at global row row0
    of Hg (an extended slab).  Returns J^T F (Offset (H, W, 2), Angle
    (H, W)), diag (the Offset channels' common value (H, W), Angle (H, W))
    and the masked squared residuals (H, W) each pixel centres, zero off
    the own rows."""
    H, W = mask.shape[:2]
    w_fit, w_reg = params[0], params[1]
    O, ang = _split(x, H, W)
    dO, dA = _split(delta, H, W) if delta is not None else (O, ang)
    lo, hi = own or (0, H)
    row0, Hg = rows_at or (0, H)
    rows = rows or tile_rows(1, hi - lo, W)
    full = mode == "full"
    zero = torch.zeros(())
    keep = mask.view(H, W) == 0
    fit = (cons >= 0).all(-1)
    sn, cs = torch.sin(ang), torch.cos(ang)
    jO, jA = torch.zeros(H, W, 2), torch.zeros(H, W)
    gO, gA, ssq = torch.zeros(H, W), torch.zeros(H, W), torch.zeros(H, W)
    inside = lambda i: 0 <= i < H and 0 <= row0 + i < Hg

    def seg(i, cols, mine):
        """Row i at the columns cols (-1 or W: no pixel); mine: the lanes'
        own pixels."""
        ok = torch.tensor([0 <= j < W for j in cols])
        jj = torch.tensor([min(max(j, 0), W - 1) for j in cols])
        px = {"O": O[i, jj], "U": ur[i, jj], "d": dO[i, jj], "dA": dA[i, jj],
              "s": sn[i, jj], "c": cs[i, jj], "keep": keep[i, jj] & ok,
              "mine": mine & ok, "fit": mine & ok & fit[i, jj],
              "j": torch.zeros(len(cols), 2), "jA": torch.zeros(len(cols)),
              "gA": torch.zeros(len(cols)), "ssq": torch.zeros(len(cols)),
              "nreg": torch.zeros(len(cols))}
        f = w_fit * (O[i, jj] - cons[i, jj])
        if mode == "model_cost":
            f = f + w_fit * dO[i, jj]
        px["f"] = torch.where(px["fit"][:, None], f, zero)
        return px

    down = lambda a: torch.cat((a[1:], a[-1:]))  # lane + 1 (31: its own)
    up = lambda a: torch.cat((a[:1], a[:-1]))  # lane - 1 (0: its own)
    none = torch.zeros(1, dtype=torch.bool)
    for w0 in range(0, W, OWN):
        lanes = list(range(w0 - 1, w0 - 1 + STRIP))
        edge = torch.tensor([k in (0, STRIP - 1) for k in range(STRIP)])
        mine_cols = [j for j in lanes[1:-1] if j < W]  # the columns written
        at = slice(1, 1 + len(mine_cols))
        for c0 in range(lo, hi, rows):
            c1 = min(c0 + rows, hi)
            prev = None
            for i in range(c0 - 1, c1 + 1):
                own_row = c0 <= i < c1
                cur = seg(i, lanes, ~edge & own_row) if inside(i) else None
                if prev is not None and cur is not None:
                    # the H pair: r_{i-1,+H}, then r_{i,-H}
                    both = prev["keep"] & cur["keep"]
                    r = _centre(prev, cur, both & (full | prev["mine"]),
                                w_reg, mode)
                    cur["j"] = cur["j"] - w_reg * r
                    r = _centre(cur, prev, both & (full | cur["mine"]),
                                w_reg, mode)
                    prev["j"] = prev["j"] - w_reg * r
                if prev is not None and i - 1 >= c0 and mine_cols:
                    # the row before is whole: its cost, fit term, output
                    k, f = prev["keep"][at], prev["f"][at]
                    ssq[i - 1, mine_cols] = torch.where(
                        k, prev["ssq"][at] + (f * f).sum(-1), zero)
                    jO[i - 1, mine_cols] = prev["j"][at] + w_fit * f
                    jA[i - 1, mine_cols] = prev["jA"][at]
                    gO[i - 1, mine_cols] = (
                        prev["nreg"][at] * (w_reg * w_reg)
                        + torch.where(prev["fit"][at], w_fit * w_fit, zero))
                    gA[i - 1, mine_cols] = prev["gA"][at]
                if cur is not None and own_row:
                    shifted = lambda move: {k: move(cur[k])
                                            for k in ("O", "U", "d")}
                    # the right neighbour: the next lane (lane 31: none)
                    nk = torch.cat((cur["keep"][1:], none))
                    jr = _centre(cur, shifted(down),
                                 cur["keep"] & nk & (full | cur["mine"]),
                                 w_reg, mode)
                    # the left neighbour: the lane before (lane 0: none)
                    nk = torch.cat((none, cur["keep"][:-1]))
                    jl = _centre(cur, shifted(up),
                                 cur["keep"] & nk & (full | cur["mine"]),
                                 w_reg, mode)
                    # the halves handed on: from the lane before, then the
                    # lane after
                    cur["j"] = cur["j"] - w_reg * up(jr)
                    cur["j"] = cur["j"] - w_reg * down(jl)
                prev = cur
    return jO, jA, gO, gA, ssq


def _mode_args(mode, delta):
    return {"full": {}, "cost_only": {"cost_only": True},
            "model_cost": {"delta": delta}}[mode]


def lin_march(x, ur, cons, mask, params, mode="full", delta=None,
              rows=None):
    """K3's function by the march: (J^T F, diag, masked cost) as
    warp_linearize_plain returns them."""
    jO, jA, gO, gA, ssq = march(x, ur, cons, mask, params, mode, delta,
                                rows=rows)
    cost = 0.5 * torch.sum(ssq)
    if mode != "full":
        return None, None, cost
    H, W = mask.shape[:2]
    return (torch.cat((jO.reshape(-1), jA.reshape(-1))),
            torch.cat((gO[..., None].expand(H, W, 2).reshape(-1),
                       gA.reshape(-1))), cost)


def slab_lin_march(x, ur, cons, mask, params, g, mode="full", delta=None,
                   rows=None):
    """K3's offset mode by the march: (J^T F, diag) at every slab's own
    rows in the local layout (None in the cost modes) and the (S,)
    per-slab costs."""
    n, he, row0, total = g
    S, _, W = mask.shape[:3]
    rows = rows or tile_rows(S, n, W)
    own = slice(he, he + n)
    costs, jtf, diag = [], [], []
    for s in range(S):
        jO, jA, gO, gA, ssq = march(
            x[s], ur[s], cons[s], mask[s], params, mode,
            None if delta is None else delta[s], own=(he, he + n),
            rows_at=(row0 + s * n, total), rows=rows)
        costs.append(0.5 * torch.sum(ssq[own]))
        jtf.append((jO[own], jA[own]))
        diag.append((gO[own][..., None].expand(n, W, 2), gA[own]))
    costs = torch.stack(costs)
    if mode != "full":
        return None, None, costs
    return slab_cuda._local(jtf), slab_cuda._local(diag), costs


def _close(got, want, what):
    for name, a, b in zip(("J^T F", "diag", "cost"), got, want):
        if b is None:
            assert a is None, f"{what}: {name}"
            continue
        assert_close(a.numpy(), b.numpy(), RTOL, f"{what}: {name}")


# ---------------------------------------------------------------------------
# against the plain versions
# ---------------------------------------------------------------------------


def _operands(W, H, seed=31):
    """kernel_operands on the CPU, with excluded pixels beside the strips'
    edge columns (lanes 0, 1, 30, 31) and on a chunk's first row where the
    grid has them, and one negative Constraints channel on a constrained
    row."""
    x, ur, cons, mask, params, t = chip_smoke.kernel_operands(
        torch, W, H, torch.device("cpu"), seed)
    cons[0, -1, 1] = -0.5
    for i, j in ((1, 31), (H - 1, 32), (4, 0), (4, 63), (5, 64), (0, 29),
                 (2, 30), (3, 59)):
        if i < H and j < W:
            mask[i, j] = 1.0
    return x, ur, cons, mask, params, t


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [None, 4, 1])
@pytest.mark.parametrize("W,H", SIZES)
def test_march_matches_plain_linearize(W, H, rows, mode):
    x, ur, cons, mask, params, t = _operands(W, H)
    assert (cons < 0).any() and (mask != 0).any()
    args = (x, ur, cons, mask, params)
    got = lin_march(*args, mode, t["delta"] if mode == "model_cost" else None,
                    rows=rows)
    want = warp_cuda.warp_linearize_plain(*args,
                                          **_mode_args(mode, t["delta"]))
    _close(got, want, f"{W}x{H} {mode}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [None, 4])
@pytest.mark.parametrize("n", [1, 17])
def test_march_on_slabs_matches_plain(n, rows, mode):
    """3 slabs of n own rows at W = 37, a halo of 2; the whole grid's cost
    by the march is the sum of the slabs'."""
    W, H, S = 37, 3 * n, 3
    x, ur, cons, mask, params, t, g = chip_smoke.slab_operands(
        torch, W, H, S, torch.device("cpu"), seed=32)
    assert g[:2] == (n, 2)
    delta = t["delta"] if mode == "model_cost" else None
    got = slab_lin_march(x, ur, cons, mask, params, g, mode, delta, rows)
    want = slab_cuda.warp_slab_linearize_plain(
        x, ur, cons, mask, params, g, **_mode_args(mode, t["delta"]))
    _close(got, want, f"3 slabs of {n} {mode}")
    xw, urw, consw, maskw, paramsw, tw = chip_smoke.kernel_operands(
        torch, W, H, torch.device("cpu"), 32)
    whole = lin_march(xw, urw, consw, maskw, paramsw, mode,
                      tw["delta"] if delta is not None else None, rows)[2]
    assert float(torch.sum(got[2])) == pytest.approx(float(whole), rel=RTOL)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_linearized():
    """At 37x23 on kernel_inputs (excluded pixels beside the strips' edges,
    a constraint band, angles ~0.3 rad): the port's bound operands, a
    masked delta, and JAX's J^T F, diag(J^T J), cost and model cost."""
    W, H = 37, 23
    inputs = chip_smoke.kernel_inputs(W, H, seed=33)[0]
    for i, j in ((1, 31), (7, 32), (4, 0), (2, 30)):
        inputs["Mask"][i, j] = 1.0
    jplan, tplan = plans("image_warping", [W, H])
    jx, jdata = jplan.bind(inputs)
    f = jplan.funcs
    masks = f.unknown_masks(jx, jdata)
    rng = np.random.RandomState(34)
    delta = f.mask_unknown_tree(
        {n: jnp.asarray(rng.randn(*s).astype(np.float32))
         for n, s in f.unknown_shapes.items()}, masks)
    r0, jvp, jt = f.linearize(jx, jdata)
    ref = {"jtf": pack(f.jtf(r0, jt), NAMES),
           "diag": pack(f.diag_jtj(jx, jdata), NAMES),
           "cost": float(f.cost(jx, jdata)),
           "model_cost": float(f.model_cost(r0, jvp, delta, jx, jdata))}
    tx, tdata = tplan.bind(inputs)
    op = warp_cuda.WarpOperator(tdata)
    return tx, op, torch.as_tensor(pack(delta, NAMES)), ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [None, 4])
def test_march_matches_jax_linearize(jax_linearized, rows, mode):
    x, op, delta, ref = jax_linearized
    jtf, diag, cost = lin_march(
        x, op.ur, op.cons, op.mask_img, op.params, mode,
        delta if mode == "model_cost" else None, rows)
    want = ref["model_cost" if mode == "model_cost" else "cost"]
    assert float(cost) == pytest.approx(want, rel=RTOL)
    if mode == "full":
        assert_close(jtf.numpy(), ref["jtf"], RTOL, "J^T F")
        assert_close(diag.numpy(), ref["diag"], RTOL, "diag")
