"""A stencil energy on a regular grid, in plain torch.

The unknowns are one (*grid, U) tensor.  A residual family is a closed-form
function fn(uc, un, cc, cn) -> (*grid, R) of the unknowns and constants at
a point (c) and at its neighbour k + offset (n), with a validity mask over
the points; a family with no offset (the fit) reads the point alone.  At a
linearization point each family keeps its residuals and its Jacobian in
local blocks, (*grid, R, U) for the point and for the neighbour, each row
from one backward pass of a residual channel's sum (a point's residuals
depend on its own two arguments alone, so the gradient of the sum over the
grid is each point's row).  Then

  J p       = Jc p(k) + Jn p(k + offset), family by family;
  J^T v     = Jc^T v at k, and Jn^T v moved back to k + offset;
  diag      = the squared blocks summed over R, placed the same way;
  J^T J p   = sum over the stencil's offsets s of A_s(k) p(k + s), with the
              (U, U) blocks A_s assembled once a linearization from the
              families' blocks (A_0 gets Jc^T Jc at k and Jn^T Jn moved back
              to k + offset, A_offset gets Jc^T Jn, A_-offset gets Jn^T Jc
              moved back), so that a PCG iteration is a few batched
              products and not a pass over every family.

As the reference solver has it (opt_tpu_torch/compile/plan_fns.py's
contract), J keeps the rows of an excluded point; only the cost leaves
them out (`counted`), and excluded unknowns never move (`free`).
"""

from __future__ import annotations

import torch


def _slices(shape, offset):
    """(destination, source) slices of a shift by offset over shape."""
    dst, src = [], []
    for o, n in zip(offset, shape):
        if o >= 0:
            dst.append(slice(0, max(n - o, 0)))
            src.append(slice(min(o, n), n))
        else:
            dst.append(slice(min(-o, n), n))
            src.append(slice(0, max(n + o, 0)))
    return tuple(dst), tuple(src)


def shift(v, offset):
    """q[k] = v[k + offset] where k + offset lies on the grid, else 0.
    v: (*grid, C)."""
    out = torch.zeros_like(v)
    dst, src = _slices(v.shape[:len(offset)], offset)
    out[dst] = v[src]
    return out


def inside(shape, offset, device):
    """Bool (*grid): k + offset lies on the grid."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    dst, _ = _slices(shape, offset)
    m[dst] = True
    return m


def _shift_blocks(b, offset):
    """shift() of (*grid, U, U) blocks."""
    g = b.shape[:-2]
    return shift(b.reshape(*g, -1), offset).reshape(b.shape)


class Family:
    """fn(uc, un, cc, cn) -> (*grid, R); valid: bool (*grid); consts:
    (*grid, Cc); offset: along the grid's axes, or None for a point
    family (fn then gets None for un and cn)."""

    def __init__(self, fn, valid, consts, offset=None):
        self.fn, self.valid, self.consts, self.offset = (
            fn, valid, consts, offset)


class GridEnergy:
    """The energy's families over one set of inputs.  x0: (*grid, U), the
    starting unknowns; names: ((unknown, channels), ...) in x0's channel
    order; counted: bool (*grid) of the points whose residuals the cost
    counts, or None; free: bool (*grid) of the points whose unknowns may
    move, or None."""

    def __init__(self, x0, names, families, counted=None, free=None):
        self.x0, self.names, self.families = x0, names, families
        self.counted, self.free = counted, free
        self._blocks = None

    # -- residuals ------------------------------------------------------------

    def _args(self, f, x):
        if f.offset is None:
            return None, None
        return shift(x, f.offset), shift(f.consts, f.offset)

    def _residual(self, f, x):
        un, cn = self._args(f, x)
        r = f.fn(x, un, f.consts, cn)
        return torch.where(f.valid[..., None], r, torch.zeros_like(r))

    def _counted(self, r):
        if self.counted is None:
            return r
        return torch.where(self.counted[..., None], r, torch.zeros_like(r))

    def cost(self, x):
        """0.5 * the sum of the counted squared residuals at x."""
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for f in self.families:
            r = self._counted(self._residual(f, x))
            total = total + 0.5 * torch.sum(r * r)
        return total

    # -- linearization --------------------------------------------------------

    def linearize(self, x):
        """Keep each family's residuals and Jacobian blocks at x."""
        blocks = []
        for f in self.families:
            un, cn = self._args(f, x)
            keep = f.valid[..., None, None]
            r = self._residual(f, x)
            args = [x.detach().requires_grad_()]
            if f.offset is not None:
                args.append(un.detach().requires_grad_())
            with torch.enable_grad():
                out = f.fn(args[0], args[1] if len(args) > 1 else None,
                           f.consts, cn)
                rows = [torch.autograd.grad(out[..., k].sum(), args,
                                            retain_graph=True,
                                            allow_unused=True)
                        for k in range(out.shape[-1])]
            jc, *jn = [torch.where(keep, torch.stack(
                [torch.zeros_like(a) if g[i] is None else g[i]
                 for g in rows], -2), torch.zeros(
                    (), dtype=x.dtype, device=x.device))
                for i, a in enumerate(args)]
            blocks.append((f, r, jc, jn[0] if jn else None))
        self._blocks = blocks
        self._stencil = self._assemble()

    def _assemble(self):
        """{offset: (*grid, U, U) block of J^T J}."""
        def tt(a, b):  # a^T b over R, blockwise
            return torch.matmul(a.transpose(-1, -2), b)

        A = {}

        def add(offset, block):
            A[offset] = block if offset not in A else A[offset] + block

        for f, _, jc, jn in self._blocks:
            zero = (0,) * (jc.dim() - 2)
            add(zero, tt(jc, jc))
            if jn is None:
                continue
            back = tuple(-o for o in f.offset)
            add(zero, _shift_blocks(tt(jn, jn), back))
            add(tuple(f.offset), tt(jc, jn))
            add(back, _shift_blocks(tt(jn, jc), back))
        return A

    def _jt(self, vs):
        """J^T v from one (*grid, R) v a family."""
        out = None
        for (f, _, jc, jn), v in zip(self._blocks, vs):
            g = torch.sum(jc * v[..., :, None], dim=-2)
            if jn is not None:
                g = g + shift(torch.sum(jn * v[..., :, None], dim=-2),
                              tuple(-o for o in f.offset))
            out = g if out is None else out + g
        return out

    def _j(self, p):
        """[J p] a family, at the linearization point."""
        out = []
        for f, _, jc, jn in self._blocks:
            v = torch.sum(jc * p[..., None, :], dim=-1)
            if jn is not None:
                v = v + torch.sum(jn * shift(p, f.offset)[..., None, :],
                                  dim=-1)
            out.append(v)
        return out

    def jtf(self):
        return self._jt([r for _, r, _, _ in self._blocks])

    def diag(self):
        """diag(J^T J) at the linearization point."""
        out = None
        for f, _, jc, jn in self._blocks:
            g = torch.sum(jc * jc, dim=-2)
            if jn is not None:
                g = g + shift(torch.sum(jn * jn, dim=-2),
                              tuple(-o for o in f.offset))
            out = g if out is None else out + g
        return out

    def jtj(self, p):
        """J^T J p at the linearization point."""
        out = None
        for offset, a in self._stencil.items():
            q = p if not any(offset) else shift(p, offset)
            v = torch.sum(a * q[..., None, :], dim=-1)
            out = v if out is None else out + v
        return out

    def model_cost(self, delta):
        """0.5 * the sum of the counted (F + J delta)^2."""
        total = torch.zeros((), dtype=delta.dtype, device=delta.device)
        for (_, r, _, _), jd in zip(self._blocks, self._j(delta)):
            m = self._counted(r + jd)
            total = total + 0.5 * torch.sum(m * m)
        return total

    def mask(self, v):
        """v with the unknowns of excluded points zeroed."""
        if self.free is None:
            return v
        return torch.where(self.free[..., None], v, torch.zeros_like(v))

    def unknowns(self, x):
        """name -> (*grid, C) view of x."""
        out, c = {}, 0
        for name, k in self.names:
            out[name] = x[..., c:c + k]
            c += k
        return out
