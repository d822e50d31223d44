"""An energy over a graph, in plain torch.

The unknowns are one (N, U) tensor over the vertices.  A residual family
is a closed-form function fn(us, cs) -> (M, R), where us holds the
unknowns and cs the constants gathered at each of the family's slots: for
an edge family, one (E,) index a slot (the graph's v0, v1), each row of us
and cs taken from that slot's vertex by index_select; for a pointwise
family (the fit), no index, every vertex its own row.  A family may have a
validity mask over its rows.  At a linearization point each family keeps
its residuals and its Jacobian in local blocks, one (M, R, U) block a slot,
each row from one backward pass of a residual channel's sum (a row's
residuals depend on its own arguments alone, so the gradient of the sum is
each row's).  Then

  J p     = sum over slots s of J_s p[idx_s], family by family;
  J^T v   = J_s^T v added back to each slot's vertices by index_add_;
  diag    = the squared blocks summed over R, added back the same way;
  J^T J p = J^T (J p).

The graph energies this holds exclude no vertex: every unknown may move
and the cost counts every residual.
"""

from __future__ import annotations

import torch


class Family:
    """fn(us, cs) -> (M, R); slots: [(E,) int64 index] a slot, or None for
    a pointwise family (M = N); consts: [(N, C)] a slot (one for a
    pointwise family), gathered once here; valid: bool (M,) or None."""

    def __init__(self, fn, slots, consts, valid=None):
        self.fn, self.slots, self.valid = fn, slots, valid
        self.consts = (consts if slots is None else
                       [c.index_select(0, i) for c, i in zip(consts, slots)])

    def rows(self, v):
        """v (N, U) at each slot's vertices."""
        if self.slots is None:
            return [v]
        return [v.index_select(0, i) for i in self.slots]

    def add_back(self, out, parts):
        """out (N, U) plus each slot's (M, U) part at its vertices."""
        if self.slots is None:
            return out + parts[0]
        for i, part in zip(self.slots, parts):
            out = out.index_add(0, i, part)
        return out


class GraphEnergy:
    """The energy's families over one set of inputs.  x0: (N, U), the
    starting unknowns; names: ((unknown, channels), ...) in x0's channel
    order."""

    def __init__(self, x0, names, families):
        self.x0, self.names, self.families = x0, names, families
        self._blocks = None

    # -- residuals ------------------------------------------------------------

    def _residual(self, f, x):
        r = f.fn(f.rows(x), f.consts)
        if f.valid is None:
            return r
        return torch.where(f.valid[:, None], r, torch.zeros_like(r))

    def cost(self, x):
        """0.5 * the sum of the squared residuals at x."""
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for f in self.families:
            r = self._residual(f, x)
            total = total + 0.5 * torch.sum(r * r)
        return total

    # -- linearization --------------------------------------------------------

    def linearize(self, x):
        """Keep each family's residuals and Jacobian blocks at x."""
        blocks = []
        for f in self.families:
            r = self._residual(f, x)
            args = [u.detach().requires_grad_() for u in f.rows(x)]
            with torch.enable_grad():
                out = f.fn(args, f.consts)
                rows = [torch.autograd.grad(out[:, k].sum(), args,
                                            retain_graph=True,
                                            allow_unused=True)
                        for k in range(out.shape[-1])]
            js = []
            for i, a in enumerate(args):
                j = torch.stack([torch.zeros_like(a) if g[i] is None
                                 else g[i] for g in rows], -2)
                if f.valid is not None:
                    j = torch.where(f.valid[:, None, None], j,
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device))
                js.append(j)
            blocks.append((f, r, js))
        self._blocks = blocks

    def _j(self, p):
        """[J p] a family, at the linearization point."""
        out = []
        for f, _, js in self._blocks:
            v = None
            for j, q in zip(js, f.rows(p)):
                jq = torch.sum(j * q[:, None, :], dim=-1)
                v = jq if v is None else v + jq
            out.append(v)
        return out

    def _jt(self, vs):
        """J^T v from one (M, R) v a family."""
        out = torch.zeros_like(self.x0)
        for (f, _, js), v in zip(self._blocks, vs):
            out = f.add_back(out, [torch.sum(j * v[:, :, None], dim=-2)
                                   for j in js])
        return out

    def jtf(self):
        return self._jt([r for _, r, _ in self._blocks])

    def diag(self):
        """diag(J^T J) at the linearization point."""
        out = torch.zeros_like(self.x0)
        for f, _, js in self._blocks:
            out = f.add_back(out, [torch.sum(j * j, dim=-2) for j in js])
        return out

    def jtj(self, p):
        """J^T J p at the linearization point."""
        return self._jt(self._j(p))

    def model_cost(self, delta):
        """0.5 * the sum of (F + J delta)^2."""
        total = torch.zeros((), dtype=delta.dtype, device=delta.device)
        for (_, r, _), jd in zip(self._blocks, self._j(delta)):
            m = r + jd
            total = total + 0.5 * torch.sum(m * m)
        return total

    def mask(self, v):
        """Every unknown may move."""
        return v

    def unknowns(self, x):
        """name -> (N, C) view of x."""
        out, c = {}, 0
        for name, k in self.names:
            out[name] = x[:, c:c + k]
            c += k
        return out
