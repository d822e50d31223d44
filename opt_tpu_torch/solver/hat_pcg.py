"""The two hat-space PCG loops that every streamed engine runs: "stream"
(ops/stream_cuda.py), "stream3d" (ops/stream3d_cuda.py), "graph"
(ops/graph_cuda.py), the two mesh engines (parallel/stream_shard.py) and
K13's plain path (stream_cuda.resident_pcg_plain).

An engine's pcg_backend (solver/core.py's seam) gets sq, scs = sq^2 ctc
(LM; None for GN) and b_hat = sq b, and solves A_hat d_hat = b_hat in the
Jacobi-scaled ("hat") space A_hat = S (J^T J [+ CtC]) S, S = diag(sq),
sq = sqrt(pre), where the preconditioner is the identity, so z == r;
excluded unknowns have sq = 0, which is their masking
(opt_tpu/ops/stream_solver.py:17-28).  The solver then takes
delta = sq d_hat.

  classic    (stream_solver.py:763-1200, stream3d.py:842-1299) per
             iteration one apply, p = r + beta p_prev, A_hat p and
             <p, A_hat p>, then one update: delta += alpha p,
             r -= alpha A_hat p, <r, r> and LM's q = 0.5 <delta, r + b_hat>;
             LM adds, every residual_reset_period iterations, the exact
             reset r = b_hat - A_hat delta, and the Q/zeta exit;
  pipelined  (stream_solver.py:1216-1700, stream3d.py:407-824) one apply
             for w_0 = A_hat r_0, then per iteration one sweep:
             n = A_hat w and the Ghysels-Vanroose recurrences with M = I
             (u = r, q = s, m = w of solver/core.pcg_pipelined), with the
             next <r, r> and <w, r> (and LM's q).  LM adds the Q/zeta exit
             and, every residual_reset_period iterations, the residual
             replacement r = b_hat - A_hat delta, w = A_hat r
             (stream3d.py:776-793).

What differs between the callers comes in as arguments, with no
defaults: the apply (a fused-beta kernel on one card, K15 or K16 and plain
torch on a mesh), the update and the sweep (a kernel, or plain torch), and
dot, the loop's own sums (torch.dot on one card, the mesh's global sum).
The loops run a fixed number of iterations: what depends on the counter
(the first pipelined iteration, the reset) the host decides, and LM's zeta
exit freezes delta by alpha = 0 from then on, as the JAX while loop's stop
leaves it.  alpha and beta stay 0-d tensors on the vectors' device.
"""

from __future__ import annotations

import torch

from .core import safe_div


def classic_pcg(apply, update, dot, b_hat, sp, lm):
    """Classic PCG on A_hat d_hat = b_hat; returns d_hat.

    apply(r, p_prev, beta) -> (p, A_hat p, <p, A_hat p>) for
    p = r + beta p_prev, and p = r where p_prev and beta are None;
    update(alpha, p, ap, delta, r, pre, b) -> (delta', r', z', <z', r'>, q)
    on K2's contract (ops/pcg_update.py), called with pre None and b the
    b_hat in LM, else None; dot(a, b) -> 0-d <a, b>.  sp: the solver
    parameters, lIterations and, in LM, residual_reset_period and
    q_tolerance."""
    if lm:
        period = int(sp["residual_reset_period"])
        q_tol = float(sp["q_tolerance"])
    delta = torch.zeros_like(b_hat)
    r = b_hat
    p = torch.zeros_like(b_hat)  # beta = 0 at it 0 reads it: not garbage
    an = dot(b_hat, b_hat)
    beta = torch.zeros_like(an)
    Q0 = torch.zeros_like(an)
    brk = torch.zeros((), dtype=torch.bool, device=an.device)
    for it in range(int(sp["lIterations"])):
        p, ap, pap = apply(r, p, beta)
        alpha = safe_div(an, pap)
        if lm:  # after the zeta exit alpha = 0 leaves delta as it was
            alpha = torch.where(brk, 0.0, alpha)
        delta, r, _, bn, q = update(alpha, p, ap, delta, r, None,
                                    b_hat if lm else None)
        if lm and (it + 1) % period == 0:
            # r = b_hat - A_hat delta, exactly (stream_solver.py:1118)
            r = b_hat - apply(delta, None, None)[1]
            bn = dot(r, r)
            q = 0.5 * dot(delta, r + b_hat)
        beta = safe_div(bn, an)
        an = bn
        if lm:
            zeta = (it + 1) * safe_div(q - Q0, q)
            brk = brk | (zeta < q_tol)
            Q0 = q
    return delta


def pipelined_pcg(apply, sweep, dot, b_hat, sp, lm):
    """Pipelined PCG on A_hat d_hat = b_hat; returns d_hat.

    apply(r) -> (r, A_hat r, <r, A_hat r>), for w_0 and LM's replacement;
    sweep(w_in, w_out, z, s, p, delta, r, alpha, beta) runs one sweep in
    place (n = A_hat w_in, z = n + beta z, s = w_in + beta s,
    p = r + beta p, delta += alpha p, r -= alpha s, w_out = w_in - alpha z)
    and returns (<r, r>, <w_out, r>, q), q = 0.5 <delta, r + b_hat> in LM;
    dot(a, b) -> 0-d <a, b>.  sp as classic_pcg's."""
    period = int(sp["residual_reset_period"])
    q_tol = float(sp["q_tolerance"])
    r = b_hat.clone()  # the sweeps update r in place
    z, s, p, delta = (torch.zeros_like(b_hat) for _ in range(4))
    gamma = dot(b_hat, b_hat)
    _, w, dd = apply(r)
    w_next = torch.empty_like(w)
    zero = torch.zeros_like(gamma)
    Q0 = zero
    brk = torch.zeros((), dtype=torch.bool, device=gamma.device)
    gamma_prev = alpha_prev = None
    for it in range(int(sp["lIterations"])):
        if it == 0:
            beta = zero
            alpha = safe_div(gamma, dd)
        else:
            beta = safe_div(gamma, gamma_prev)
            alpha = safe_div(gamma,
                             dd - beta * safe_div(gamma, alpha_prev))
        if lm:
            alpha = torch.where(brk, 0.0, alpha)
        g2, dd2, q = sweep(w, w_next, z, s, p, delta, r, alpha, beta)
        w, w_next = w_next, w
        if lm and (it + 1) % period == 0:
            r = b_hat - apply(delta)[1]
            _, w, dd2 = apply(r)
            g2 = dot(r, r)
            q = 0.5 * dot(delta, r + b_hat)
        if lm:
            zeta = (it + 1) * safe_div(q - Q0, q)
            brk = brk | (zeta < q_tol)
            Q0 = q
        gamma_prev, alpha_prev = gamma, alpha
        gamma, dd = g2, dd2
    return delta


def hat_pcg(variant, apply, update, sweep, dot, b_hat, sp, lm):
    """d_hat from the named loop, "classic" or "pipelined"; apply serves
    both, update only the classic loop and sweep only the pipelined one."""
    if variant == "classic":
        return classic_pcg(apply, update, dot, b_hat, sp, lm)
    return pipelined_pcg(apply, sweep, dot, b_hat, sp, lm)
