"""Gauss-Newton / Levenberg-Marquardt solver with a Jacobi-preconditioned
PCG inner loop (port of opt_tpu/solver/core.py).

Numerics follow the reference engine (API/src/solverGPUGaussNewton.t):
 * guardedInvert (CERES / MODIFIED_CERES / EPSILON_ADD), :478-507;
 * PCGInit1: r = -J^T F, pre = 1/guard(diag(J^T J)), p = M^-1 r,
   alpha_num = r.p (:521-598);
 * PCGStep1/2/3 (:607-852) incl. LM q = 0.5*delta.(r+b) (:713-719);
 * LM residual re-computation every residual_reset_period iterations
   (:738-813, 2128-2139);
 * PCGComputeCtC, PCGSaveSSq, PCGFinalizeDiagonal (Jacobi scaling,
   clamping, pre = 1/(CtC + diag)) (:1042-1103);
 * Q-based zeta early exit: zeta = (i+1)(Q1-Q0)/Q1 < q_tolerance
   (:2211-2220);
 * trust-region accept/reject as Ceres' StepAccepted (:2247-2292).

The outer logic exists once, here.  Every engine runs through it behind
one operator seam, an object with
  cost(x)          -> 0-d masked cost at x
  outer(x)         -> (J^T F, diag(J^T J)) at x, unmasked; x becomes the
                      linearization point of apply() and model_cost()
  mask(v)          -> v with the excluded unknowns zeroed
  apply(p, ctc)    -> (mask(J^T J p + ctc p), <p, Ap>); ctc None for GN
  update           -> the PCG Step2, pcg_update_plain's contract
  dot(a, b)        -> 0-d <a, b>: torch.dot on one device; the sharded
                      operators (parallel/) sum their slabs' partials over
                      the mesh (opt_tpu's SolverConfig.psum_axis, :188-194),
                      as their cost, model_cost and apply's <p, Ap> do
  model_cost(d)    -> 0-d 0.5 * sum of masked (F + J d)^2 (LM)
  pcg_backend      -> None, or a callable (sq, scs, b_hat, sp) -> d_hat
                      that solves S (J^T J [+ CtC]) S d_hat = b_hat,
                      S = diag(sq), in place of the PCG loop here
                      (opt_tpu's SolverConfig.pcg_backend, :145-153)
The plain engine's operator is compile/plan_fns.FuncsOperator; the CUDA
engines' are ops/warp_cuda.WarpOperator and ops/stream_cuda.StreamOperator;
a solve over a mesh runs the same loop on parallel/'s sharded operators.
The loop's spans (runtime/trace.py): opt.init around the initial cost,
opt.step around each outer step, and inside it opt.linearize, opt.pcg and
opt.update.

Every vector is one flat buffer over all unknowns (Layout gives the
per-unknown views).  Scalars (alpha, beta, <r, z>) stay 0-d tensors on the
vectors' device: nothing in a solve waits on the host.  The JAX package's
while loops become Python ranges with a fixed trip count: what depends
only on the loop counter (the residual reset, the first pipelined
iteration) the host decides; the data-dependent exits (LM's zeta break and
its `done` flag) become predicated updates that freeze delta (alpha = 0),
or the whole state, for the remaining iterations.
"""

from __future__ import annotations

import math

import torch

from ..runtime.trace import span

SOLVER_PARAMETER_DEFAULTS = {
    "residual_reset_period": 10,
    "min_relative_decrease": 1e-3,
    "min_trust_region_radius": 1e-32,
    "max_trust_region_radius": 1e16,
    "q_tolerance": 0.0001,
    "function_tolerance": 0.000001,
    "trust_region_radius": 1e4,
    "radius_decrease_factor": 2.0,
    "min_lm_diagonal": 1e-6,
    "max_lm_diagonal": 1e32,
    "nIterations": 10,
    "lIterations": 10,
}

GUARDED_INVERT_TYPES = ("CERES", "MODIFIED_CERES", "EPSILON_ADD")
JACOBI_SCALING_TYPES = ("NONE", "ONCE_PER_SOLVE", "EVERY_ITERATION")


def _safe_div(a, b):
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def guarded_invert(d, kind):
    """solverGPUGaussNewton.t:478-507."""
    if kind == "CERES":
        return 1.0 / torch.square(1.0 + torch.sqrt(torch.clamp_min(d, 0.0)))
    if kind == "MODIFIED_CERES":
        return 1.0 / (1.0 + d)
    if kind == "EPSILON_ADD":
        return 1.0 / (torch.finfo(d.dtype).eps + d)
    raise ValueError(kind)


class Layout:
    """Where each unknown lives in the flat solver vectors: the unknowns in
    declaration order, each flattened from its (*spatial, C) shape."""

    def __init__(self, shapes):
        self.shapes = dict(shapes)  # name -> (*spatial, C)
        self.offsets = {}
        o = 0
        for n, s in self.shapes.items():
            self.offsets[n] = o
            o += math.prod(s)

    def views(self, buf):
        """name -> view of buf shaped like the unknown (no copy)."""
        return {n: buf[o:o + math.prod(s)].view(s)
                for (n, s), o in zip(self.shapes.items(),
                                     self.offsets.values())}

    def pack(self, tree):
        return torch.cat([tree[n].reshape(-1) for n in self.shapes])


class SolverConfig:
    """Compile-time knobs (initialization_parameters,
    solverGPUGaussNewton.t:29-39)."""

    def __init__(
        self,
        uses_lambda=False,
        guarded_invert_type="CERES",
        jacobi_scaling="ONCE_PER_SOLVE",
        use_materialized_jacobian=False,
        use_fused_jtj=False,
        pcg_variant="classic",
    ):
        for name, value, allowed in (
            ("guarded_invert_type", guarded_invert_type,
             GUARDED_INVERT_TYPES),
            ("jacobi_scaling", jacobi_scaling, JACOBI_SCALING_TYPES),
            ("pcg_variant", pcg_variant, ("classic", "pipelined")),
        ):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}: "
                                 f"{value!r}")
        if use_materialized_jacobian or use_fused_jtj:
            raise NotImplementedError(
                "the materialized Jacobian is not ported to opt_tpu_torch "
                "yet (ROADMAP.md queue A item 9)")
        self.uses_lambda = uses_lambda
        self.guarded_invert_type = guarded_invert_type
        self.jacobi_scaling = jacobi_scaling
        self.pcg_variant = pcg_variant


def make_solver(config: SolverConfig, dtype, use_preconditioner=True):
    """Build (init_fn, step_fn, cost_fn, full_solve_fn) over an operator.

    State dict:
      x            flat unknown vector
      prev_cost    0-d: the published cost, printed as 'final cost='
      radius       0-d LM trust-region radius
      decrease_f   0-d LM radius decrease factor
      ssq          LM: flat saved guarded-invert diag of the first step
                   (PCGSaveSSq); GN: a 0-d placeholder
      n_iter       0-d int32
      done         0-d bool (LM early exits; GN never sets it)
    """
    kind = config.guarded_invert_type
    lm = config.uses_lambda

    def init_fn(x, op, sp):
        dev = x.device
        with span("opt.init"):
            cost = op.cost(x)
        return {
            "x": x,
            "prev_cost": cost,
            "radius": torch.tensor(sp["trust_region_radius"], dtype=dtype,
                                   device=dev),
            "decrease_f": torch.tensor(sp["radius_decrease_factor"],
                                       dtype=dtype, device=dev),
            "ssq": (torch.ones_like(x) if lm
                    else torch.zeros((), dtype=dtype, device=dev)),
            "n_iter": torch.zeros((), dtype=torch.int32, device=dev),
            "done": torch.zeros((), dtype=torch.bool, device=dev),
        }

    def pcg_pipelined(op, pre, r, sp):
        """Pipelined PCG (Ghysels & Vanroose 2014; opt_tpu's pcg_pipelined,
        :213-268), GN only: recurrences for s = A p, q = M^-1 s, z = A q
        make the two dots of an iteration independent of its apply."""
        M = lambda v: op.mask(pre * v)
        u = M(r)
        w, _ = op.apply(u)
        delta = torch.zeros_like(r)
        z = q = s = p = torch.zeros_like(r)
        gamma_prev = alpha_prev = None
        for i in range(int(sp["lIterations"])):
            gamma = op.dot(r, u)
            dd = op.dot(w, u)
            m = M(w)
            n, _ = op.apply(m)
            if i == 0:
                beta = 0.0
                alpha = _safe_div(gamma, dd)
            else:
                beta = _safe_div(gamma, gamma_prev)
                alpha = _safe_div(gamma,
                                  dd - beta * _safe_div(gamma, alpha_prev))
            z = n + beta * z
            q = m + beta * q
            s = w + beta * s
            p = u + beta * p
            delta = delta + alpha * p
            r = r - alpha * s
            u = u - alpha * q
            w = w - alpha * z
            gamma_prev, alpha_prev = gamma, alpha
        return delta

    def pcg_loop(op, pre, r, b, ctc, sp):
        """The classic PCG inner loop on A = mask(J^T J + CtC), M^-1 = pre;
        LM adds the periodic exact residual reset and the Q/zeta exit."""
        if config.pcg_variant == "pipelined" and not lm:
            return pcg_pipelined(op, pre, r, sp)
        period = int(sp["residual_reset_period"])
        q_tol = float(sp["q_tolerance"])
        p = op.mask(pre * r)
        an = op.dot(r, p)
        delta = torch.zeros_like(r)
        Q0 = torch.zeros((), dtype=r.dtype, device=r.device)
        brk = torch.zeros((), dtype=torch.bool, device=r.device)
        for i in range(int(sp["lIterations"])):
            ap, ad = op.apply(p, ctc)  # PCGStep1
            alpha = _safe_div(an, ad)
            if lm:
                # the JAX while loop stops after the iteration that sets
                # brk; here alpha = 0 from then on leaves delta as it was
                alpha = torch.where(brk, 0.0, alpha)
            if lm and (i + 1) % period == 0:
                # r = b - A delta, exactly (:2128-2139)
                delta = delta + alpha * p
                r = b - op.apply(delta, ctc)[0]
                z = op.mask(pre * r)
                bn = op.dot(z, r)
                q = 0.5 * op.dot(delta, r + b)
            else:
                delta, r, z, bn, q = op.update(
                    alpha, p, ap, delta, r, pre, b if lm else None)
            beta = _safe_div(bn, an)
            p = z + beta * p  # PCGStep3
            an = bn
            if lm:
                zeta = (i + 1) * _safe_div(q - Q0, q)
                brk = brk | (zeta < q_tol)
                Q0 = q
        return delta

    def linearize(state, op, sp):
        """PCGInit1 at x (:521-598), and LM's CtC and its preconditioner:
        (pre, b, ctc, ssq)."""
        jtf, diag = op.outer(state["x"])
        r = op.mask(-jtf)  # residuum = -J^T F (PCGInit1, :530-560)
        diag = op.mask(diag)
        if use_preconditioner:
            pre = op.mask(guarded_invert(diag, kind))
        else:
            pre = op.mask(torch.ones_like(diag))

        ctc = None
        ssq = state["ssq"]
        if lm:
            radius = state["radius"]
            # PCGSaveSSq at nIter == 0 stores the guarded-inverted diag
            ssq = torch.where(state["n_iter"] == 0, pre, ssq)
            ctc_raw = (1.0 / radius) * diag  # computeCtC (o.t:3019)
            if config.jacobi_scaling == "ONCE_PER_SOLVE":
                inv_s_sq = _safe_div(torch.ones_like(ssq), ssq)
            elif config.jacobi_scaling == "EVERY_ITERATION":
                inv_s_sq = _safe_div(torch.ones_like(pre), pre)
            else:
                inv_s_sq = torch.ones_like(diag)
            ctc = torch.clamp(
                ctc_raw,
                min=float(sp["min_lm_diagonal"]) * inv_s_sq / radius,
                max=float(sp["max_lm_diagonal"]) * inv_s_sq / radius)
            # true preconditioner: 1/(CtC + radius*CtC_raw) = 1/(CtC + diag)
            pre = op.mask(_safe_div(torch.ones_like(ctc), ctc + diag))
        return pre, r, ctc, ssq  # pd.b = residuum (:1087)

    def pcg(op, pre, b, ctc, sp):
        """delta from the pcg_backend or the PCG loop here."""
        backend = op.pcg_backend
        if backend is not None:
            # the hat space (opt_tpu core :482-513); pre is mask-zeroed, so
            # sq carries the exclusion
            sq = torch.sqrt(pre)
            scs = sq * sq * ctc if lm else None
            return sq * backend(sq, scs, sq * b, sp)
        return pcg_loop(op, pre, b, b, ctc, sp)

    def update(state, op, sp, delta, ssq):
        """The new x and its cost; LM's accept or reject."""
        x = state["x"]
        x_new = x + op.mask(delta)
        new_cost = op.cost(x_new)
        if not lm:
            return {
                **state,
                "x": x_new,
                "prev_cost": new_cost,
                "n_iter": state["n_iter"] + 1,
            }

        # ---- LM trust-region accept / reject (:2247-2292) ----
        radius = state["radius"]
        prev = state["prev_cost"]
        model_cost_change = prev - op.model_cost(delta)
        cost_change = prev - new_cost
        relative_decrease = _safe_div(cost_change, model_cost_change)
        accept = ((cost_change >= 0)
                  & (relative_decrease > float(sp["min_relative_decrease"])))
        ftol_reached = cost_change <= prev * float(sp["function_tolerance"])
        tmp_base = 2.0 * relative_decrease - 1.0
        tmp_factor = 1.0 - tmp_base * tmp_base * tmp_base
        radius_acc = torch.clamp(
            radius / torch.clamp(tmp_factor, min=1.0 / 3.0),
            max=float(sp["max_trust_region_radius"]))
        radius_rej = radius / state["decrease_f"]
        radius_too_small = radius_rej <= float(sp["min_trust_region_radius"])
        # On the function-tolerance exit the reference returns before
        # updating radius/decrease_factor/prevCost (:2254-2259), so the
        # printed final cost is the pre-step cost
        take_acc = accept & ~ftol_reached
        return {
            "x": torch.where(accept, x_new, x),
            "prev_cost": torch.where(take_acc, new_cost, prev),
            "radius": torch.where(take_acc, radius_acc,
                                  torch.where(accept, radius, radius_rej)),
            "decrease_f": torch.where(
                take_acc, 2.0,
                torch.where(accept, state["decrease_f"],
                            2.0 * state["decrease_f"])),
            "ssq": ssq,
            "n_iter": state["n_iter"] + 1,
            "done": state["done"] | torch.where(accept, ftol_reached,
                                                radius_too_small),
        }

    def step_fn(state, op, sp):
        """One nonlinear (outer) iteration; solverGPUGaussNewton.t:1913-2349."""
        with span("opt.step"):
            with span("opt.linearize"):
                pre, b, ctc, ssq = linearize(state, op, sp)
            with span("opt.pcg"):
                delta = pcg(op, pre, b, ctc, sp)
            with span("opt.update"):
                return update(state, op, sp, delta, ssq)

    def cost_fn(state, op):
        return op.cost(state["x"])

    def full_solve_fn(x, op, sp):
        """init + the whole outer loop.  The JAX loop stops once `done` is
        set; here every later step still runs and its state is dropped."""
        state = init_fn(x, op, sp)
        for _ in range(int(sp["nIterations"])):
            new = step_fn(state, op, sp)
            if lm:
                new = {k: torch.where(state["done"], state[k], v)
                       for k, v in new.items()}
            state = new
        return state

    return init_fn, step_fn, cost_fn, full_solve_fn
