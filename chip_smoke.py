#!/usr/bin/env python3
"""Smoke run of opt_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from opt_tpu_torch/csrc (one nvcc per source,
     all started together) and print the seconds;
  3. hold K1 warp_jtj_apply, K2 pcg_update and K3 warp_linearize against
     their plain torch versions on the card at 512x512, on seeded inputs
     with one excluded pixel and a constraint band, and time both with
     CUDA events;
  4. run the first path: image_warping 512x512, Gauss-Newton 8 outer x
     400 PCG iterations, through NewState(device="cuda") ... plan.solve
     with engine="auto"; check that it picked the CUDA engine, that every
     kernel launched the expected number of times inside that solve, and
     that the final cost matches the plain torch engine on the same card
     and the JAX package's CPU value;
  5. time warm solves of the CUDA engine (best of 3) beside the plain
     engine's one timed solve of phase 4, and profile one CUDA-engine
     solve: device time by kernel and the device's busy share;
  6. hold the slice-2 kernels and modes against their plain versions at
     2048x2048: K4 warp_hat_apply (GN, and LM with scs), K5
     warp_pipelined_sweep, K1 with LM's ctc, K3's model cost, K2's hat
     mode (GN and LM);
  7. run the slice-2 paths through engine="auto", each with its own
     launch counts zeroed just before it and read just after, its final
     cost held against the JAX package's CPU value:
       2048x2048 GN 8x100  -> "stream", pipelined (K4 + K5, K3),
       2048x2048 LM 8x100  -> "stream", classic (K4 + K2 hat, K3),
       512x512   LM 8x400  -> "cuda" (K1 + ctc, K2 with q, K3);
     and time each path's warm solve (best of 3);
  8. the card's own crossover, GN and LM 8x100 at 1024x1024 and
     2048x2048: warm solves of engine="stream" and engine="cuda" (best of
     3 each), and one profiled solve of each engine and kind at
     2048x2048;
  9. print {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Exits non-zero, printing no result, where torch sees no CUDA device.
"""

import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
W = H = 512
N_OUTER, N_LINEAR = 8, 400
# opt_tpu (JAX, CPU) final cost of the same solve: warp_inputs(512, 512),
# image_warping, gaussNewtonGPU 8x400, plan.solve(..., engine="xla").
# Regenerate with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu'); \
#     import opt_tpu, bench; from opt_tpu import energies; \
#     s = opt_tpu.NewState(); p = s.problem_plan(s.problem_define( \
#     energies.image_warping, 'gaussNewtonGPU'), [512, 512]); \
#     p.set_solver_parameter('nIterations', 8); \
#     p.set_solver_parameter('lIterations', 400); \
#     print(repr(p.solve(bench.warp_inputs(512, 512), engine='xla')))"
JAX_CPU_FINAL_COST = 8170.7724609375
# The slice-2 paths: (label, solver kind, size, outer, PCG iterations, the
# engine and stream variant engine="auto" must pick, the opt_tpu (JAX, CPU)
# final cost).  Each cost is the command above with the kind, size and
# iteration counts changed ('LMGPU' for LM; 2048 and 100 for the large
# grid); they took 24 s, 140 s and 153 s on a CPU.
PATHS = (
    ("2048 GN", "gaussNewtonGPU", 2048, 8, 100, "stream", "pipelined",
     129813.453125),
    ("2048 LM", "LMGPU", 2048, 8, 100, "stream", "classic", 129824.890625),
    ("512 LM", "LMGPU", 512, 8, 400, "cuda", None, 8171.9326171875),
)
BIG = 2048
# the whole-solve kernel's own parity bound (docs/GUIDE.md:204-207)
COST_RTOL = 2e-4
# kernel vs plain torch on the same inputs, as max|a - b| / max|b| over
# each output: f32 sums taken in another order (per-block trees vs torch's
# reductions) and FMA contraction differ by a few ulp of the largest term
KERNEL_RTOL = 1e-5
TIMING_REPS = 200
BIG_TIMING_REPS = 20


def warp_inputs(W, H, seed=0):
    """The main path's inputs: a copy of bench.warp_inputs (a test holds
    the two equal)."""
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
    # constraint band: ~5% of pixels pinned to mutually inconsistent targets
    # (keeps the optimum nonzero so divergence would be visible in the cost)
    cons[::20, :] = np.abs(rng.randn(H, W, 2).astype(np.float32))[::20, :]
    mask = np.zeros((H, W, 1), np.float32)
    return {
        "Offset": np.zeros((H, W, 2), np.float32),
        "Angle": np.zeros((H, W, 1), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(0.5),
        "w_regSqrt": np.sqrt(2.0),
    }


def kernel_inputs(W, H, seed=1):
    """Seeded operands for the kernel checks: a non-zero linearization
    point, one excluded pixel and a constraint band."""
    rng = np.random.RandomState(seed)
    inp = warp_inputs(W, H, seed)
    inp["Offset"] = (0.1 * rng.randn(H, W, 2)).astype(np.float32)
    inp["Angle"] = (0.3 * rng.randn(H, W, 1)).astype(np.float32)
    inp["Mask"][H // 2, W // 3] = 1.0
    vecs = {k: rng.randn(3 * H * W).astype(np.float32)
            for k in ("p", "ap", "delta", "r", "b")}
    vecs["pre"] = rng.rand(3 * H * W).astype(np.float32)
    return inp, vecs


def kernel_operands(torch, W, H, dev, seed=1):
    """kernel_inputs on the device: (x, ur, cons, mask, params, vectors).
    p is masked, as the solver's search directions are; sq = sqrt(pre) is
    zero at the excluded pixel and scs = sq^2 ctc, as the LM solver forms
    them for the hat space; ctc > 0 is LM's CtC diagonal."""
    from opt_tpu_torch.ops import warp_cuda

    inp, vecs = kernel_inputs(W, H, seed)
    t = {k: torch.as_tensor(v, device=dev) for k, v in vecs.items()}
    x = torch.cat([torch.as_tensor(inp[n], device=dev).reshape(-1)
                   for n in ("Offset", "Angle")])
    ur, cons, mask = (torch.as_tensor(inp[n], device=dev)
                      for n in ("UrShape", "Constraints", "Mask"))
    params = torch.tensor([inp["w_fitSqrt"], inp["w_regSqrt"]],
                          dtype=torch.float32, device=dev)
    keep = warp_cuda._flat_keep(mask.view(H, W) == 0)
    zero = torch.zeros((), device=dev)
    t["p"] = torch.where(keep, t["p"], zero)
    t["ctc"] = 0.5 + t["pre"]
    t["sq"] = torch.where(keep, torch.sqrt(t["pre"]), zero)
    t["scs"] = t["sq"] * t["sq"] * t["ctc"]
    return x, ur, cons, mask, params, t


def rel_err(got, want):
    """(max|got - want| / max|want|, max|got - want|) over paired outputs."""
    rel = absmax = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        d = float((g - w).abs().max())
        rel = max(rel, d / max(float(w.abs().max()), 1e-30))
        absmax = max(absmax, d)
    return rel, absmax


def cuda_ms(torch, fn, reps=TIMING_REPS):
    """Mean device milliseconds per call of fn, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check_cases(torch, cases, reps):
    """Each (kernel, plain) pair on the same inputs: agreement within
    KERNEL_RTOL, and both timed.  name -> {max_abs_err, ms, plain_ms}."""
    out = {}
    for name, (kern, plain) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        rel, absmax = rel_err(got, want)
        ok = rel <= KERNEL_RTOL
        ms, plain_ms = cuda_ms(torch, kern, reps), cuda_ms(torch, plain, reps)
        print(f"kernel {name}: max rel err {rel:.3e} (tol {KERNEL_RTOL:.0e})"
              f" max abs err {absmax:.3e}  {ms * 1e3:.1f} us vs plain "
              f"{plain_ms * 1e3:.1f} us  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        out[name] = {"max_abs_err": absmax, "ms": ms, "plain_ms": plain_ms}
    return out


def check_kernels(torch, dev):
    """Phase 3: each slice-1 kernel vs its plain version at 512x512."""
    from opt_tpu_torch.ops import pcg_update as k2
    from opt_tpu_torch.ops import warp_cuda

    x, ur, cons, mask, params, t = kernel_operands(torch, W, H, dev)
    p = t["p"]
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    return check_cases(torch, {
        "warp_jtj_apply": (
            lambda: warp_cuda.warp_jtj_apply(x, p, ur, cons, mask, params),
            lambda: warp_cuda.warp_jtj_apply_plain(x, p, ur, cons, mask,
                                                   params)),
        "warp_linearize": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask,
                                                   params)),
        "warp_linearize(cost_only)": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                             cost_only=True),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                                   cost_only=True)),
        "pcg_update": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  t["pre"]),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], t["pre"])),
        "pcg_update(lm)": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  t["pre"], t["b"]),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], t["pre"], t["b"])),
    }, TIMING_REPS)


def sweep_case(torch, stream_cuda, x, ur, cons, mask, params, t, scs, alpha,
               beta):
    """K5 and its plain version as (kernel, plain) callables, each running
    one sweep in place on its own copy of the same state (so their first
    calls agree; the timing's later calls carry that state on)."""
    def run(fn):
        z, s, p, d, r = (t[k].clone() for k in ("ap", "b", "p", "delta", "r"))
        w_out = torch.empty_like(r)

        def call():
            g, dd = fn(x, ur, cons, mask, params, t["sq"], scs, t["pre"],
                       w_out, z, s, p, d, r, alpha, beta)
            return g, dd, w_out, z, s, p, d, r
        return call
    return (run(stream_cuda.warp_pipelined_sweep),
            run(stream_cuda.warp_pipelined_sweep_plain))


def check_big_kernels(torch, dev):
    """Phase 6: the slice-2 kernels and modes vs their plain versions at
    2048x2048."""
    from opt_tpu_torch.ops import pcg_update as k2
    from opt_tpu_torch.ops import stream_cuda, warp_cuda

    x, ur, cons, mask, params, t = kernel_operands(torch, BIG, BIG, dev)
    p, sq, scs = t["p"], t["sq"], t["scs"]
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    hat = stream_cuda.warp_hat_apply
    hat_plain = stream_cuda.warp_hat_apply_plain
    cases = {
        "warp_hat_apply(gn)": (
            lambda: hat(x, ur, cons, mask, params, sq, None, t["r"], p, beta),
            lambda: hat_plain(x, ur, cons, mask, params, sq, None, t["r"], p,
                              beta)),
        "warp_hat_apply(lm)": (
            lambda: hat(x, ur, cons, mask, params, sq, scs, t["r"], p, beta),
            lambda: hat_plain(x, ur, cons, mask, params, sq, scs, t["r"], p,
                              beta)),
        "warp_pipelined_sweep": sweep_case(
            torch, stream_cuda, x, ur, cons, mask, params, t, None, alpha,
            beta),
        "warp_jtj_apply(ctc)": (
            lambda: warp_cuda.warp_jtj_apply(x, p, ur, cons, mask, params,
                                             t["ctc"]),
            lambda: warp_cuda.warp_jtj_apply_plain(x, p, ur, cons, mask,
                                                   params, t["ctc"])),
        "warp_linearize(model_cost)": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                             delta=t["delta"]),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                                   delta=t["delta"])),
        "pcg_update(hat)": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  None),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], None)),
        "pcg_update(hat, lm)": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  None, t["b"]),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], None, t["b"])),
    }
    return check_cases(torch, cases, BIG_TIMING_REPS)


def profile_solve(torch, plan, inputs, engine, label, card, wall_ms):
    """Where a warm solve spends the card's time: device time by kernel
    from torch.profiler, and the device's busy share of the unprofiled
    solve's wall time (wall_ms; the profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        plan.solve(inputs, engine=engine)
    # device-side rows only: the aten op rows repeat their kernels' time
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("profile: the profiler saw no device time (not measured)")
        return
    busy_ms = sum(r[2] for r in rows) / 1e3
    print(f"profile: {label} engine={engine}: device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle) ({card})")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {us / 1e3:9.2f} ms {count:6d} x {us / count:8.2f} us  "
              f"{key[:90]}")


def timed_solve(torch, plan, inputs, engine="auto"):
    """(final cost, wall ms) of one solve, ending in the host read of the
    cost."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cost = plan.solve(inputs, engine=engine)
    return cost, (time.perf_counter() - t0) * 1e3


def best_of_3(torch, plan, inputs, engine, label, card):
    times = [timed_solve(torch, plan, inputs, engine)[1] for _ in range(3)]
    print(f"solve {label} engine={engine}: best {min(times):.1f} ms of "
          f"{[round(v, 1) for v in times]} ({card})")
    return min(times)


def new_plan(opt_tpu_torch, energies, kind, size, n_outer, n_linear):
    state = opt_tpu_torch.NewState(device=DEVICE)
    plan = state.problem_plan(
        state.problem_define(energies.image_warping, kind), [size, size])
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


def check_unknowns(plan, size):
    x = plan.unknowns()
    for n, shape in (("Offset", (size, size, 2)), ("Angle", (size, size, 1))):
        if x[n].shape != shape or not np.isfinite(x[n]).all():
            raise AssertionError(f"unknown {n}: shape {x[n].shape} or "
                                 "non-finite values")


def check_cost(label, cost, want):
    rel = abs(cost - want) / abs(want)
    print(f"{label} final cost {cost!r} jax-cpu {want!r} (rel {rel:.3e}, "
          f"tol {COST_RTOL:.0e})")
    if not np.isfinite(cost) or rel > COST_RTOL:
        raise AssertionError(f"{label}: final cost disagrees")


def expected_launches(kind, engine, n_outer, n_linear, period=10):
    """Launch counts one solve makes, by kernel name."""
    resets = n_outer * (n_linear // period) if kind == "LMGPU" else 0
    # K3: the initial cost, then per outer linearize + cost (+ LM's model
    # cost)
    k3 = 1 + n_outer * (3 if kind == "LMGPU" else 2)
    n = n_outer * n_linear
    if engine == "cuda":
        return {"warp_jtj_apply": n + resets, "pcg_update": n - resets,
                "warp_linearize": k3}
    if kind == "LMGPU":  # the classic backend
        return {"warp_hat_apply": n + resets, "pcg_update": n,
                "warp_linearize": k3}
    return {"warp_hat_apply": n_outer, "warp_pipelined_sweep": n,
            "warp_linearize": k3}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.ops import build, pcg_update as k2
    from opt_tpu_torch.ops import stream_cuda, warp_cuda

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    build.library()
    print(f"build: {build.build_seconds:.2f} s "
          f"({len(build.sources())} sources, {' '.join(build.NVCC_FLAGS)})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    timings = check_kernels(torch, dev)

    kernels = (warp_cuda.warp_jtj_apply, k2.pcg_update,
               warp_cuda.warp_linearize, stream_cuda.warp_hat_apply,
               stream_cuda.warp_pipelined_sweep)
    total = {k.__name__: 0 for k in kernels}

    def drive(plan, inputs):
        """One solve with every launch count zeroed just before it and
        read just after."""
        for k in kernels:
            k.launches = 0
        cost, ms = timed_solve(torch, plan, inputs)
        launches = {k.__name__: k.launches for k in kernels}
        for name, n in launches.items():
            total[name] += n
        return cost, ms, launches

    # -- the first path: 512x512 GN 8x400 ----------------------------------
    plan = new_plan(opt_tpu_torch, energies, "gaussNewtonGPU", W, N_OUTER,
                    N_LINEAR)
    inputs = warp_inputs(W, H)
    cost, _, launches = drive(plan, inputs)
    engine = plan.engine
    print(f"main path: engine={engine} final cost={cost!r} "
          f"launches={launches}")
    if engine != "cuda":
        raise AssertionError(f"engine='auto' picked {engine!r}, not 'cuda'")
    n_apply = N_OUTER * N_LINEAR
    if (launches["warp_jtj_apply"] != n_apply
            or launches["pcg_update"] != n_apply
            or launches["warp_linearize"] < 2 * N_OUTER):
        raise AssertionError(f"kernel launch counts {launches}: want "
                             f"{n_apply} K1, {n_apply} K2, >= {2 * N_OUTER}"
                             " K3")
    check_unknowns(plan, W)

    # the plain engine's one timed solve is also the cost check's
    cost_torch, torch_ms = timed_solve(torch, plan, inputs, "torch")
    rel_torch = abs(cost - cost_torch) / abs(cost_torch)
    rel_jax = abs(cost - JAX_CPU_FINAL_COST) / JAX_CPU_FINAL_COST
    print(f"final cost: cuda {cost!r}  torch {cost_torch!r} (rel "
          f"{rel_torch:.3e})  jax-cpu {JAX_CPU_FINAL_COST!r} (rel "
          f"{rel_jax:.3e})  tol {COST_RTOL:.0e}")
    if not np.isfinite(cost) or rel_torch > COST_RTOL or rel_jax > COST_RTOL:
        raise AssertionError("final cost disagrees")

    # -- warm solve times ---------------------------------------------------
    cuda_best = best_of_3(torch, plan, inputs, "cuda",
                          f"512x512 GN {N_OUTER}x{N_LINEAR}", card)
    print(f"solve 512x512 GN {N_OUTER}x{N_LINEAR} engine=torch: one warm "
          f"solve {torch_ms:.1f} ms ({card})")
    profile_solve(torch, plan, inputs, "cuda",
                  f"512x512 GN {N_OUTER}x{N_LINEAR}", card, cuda_best)

    # -- slice 2: the kernels at 2048x2048, then its paths ------------------
    timings.update(check_big_kernels(torch, dev))
    big_inputs = warp_inputs(BIG, BIG)
    for (label, kind, size, n_outer, n_linear, want_engine, want_variant,
         want_cost) in PATHS:
        plan = new_plan(opt_tpu_torch, energies, kind, size, n_outer,
                        n_linear)
        path_inputs = big_inputs if size == BIG else warp_inputs(size, size)
        cost, ms, launches = drive(plan, path_inputs)
        print(f"path {label} {n_outer}x{n_linear}: engine={plan.engine} "
              f"variant={plan.variant} {ms:.1f} ms (cold) launches="
              f"{launches}")
        if (plan.engine, plan.variant) != (want_engine, want_variant):
            raise AssertionError(
                f"{label}: engine='auto' picked {plan.engine!r} "
                f"{plan.variant!r}, not {want_engine!r} {want_variant!r}")
        want = expected_launches(kind, want_engine, n_outer, n_linear)
        got = {k: launches[k] for k in want}
        if got != want or any(launches[k] for k in launches
                              if k not in want):
            raise AssertionError(f"{label}: launch counts {launches}, want "
                                 f"{want} and no others")
        check_unknowns(plan, size)
        check_cost(label, cost, want_cost)
        best_of_3(torch, plan, path_inputs, plan.engine,
                  f"{label} {n_outer}x{n_linear} (warm)", card)

    # -- the card's crossover: stream vs cuda, 8x100 ------------------------
    for kind, label in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
        for size in (BIG // 2, BIG):
            plan = new_plan(opt_tpu_torch, energies, kind, size, 8, 100)
            path_inputs = big_inputs if size == BIG else warp_inputs(size,
                                                                     size)
            name = f"{size}x{size} {label} 8x100"
            best = {eng: best_of_3(torch, plan, path_inputs, eng, name, card)
                    for eng in ("stream", "cuda")}
            print(f"crossover {name}: stream {best['stream']:.1f} ms, cuda "
                  f"{best['cuda']:.1f} ms, cuda/stream "
                  f"{best['cuda'] / best['stream']:.3f} ({card})")
        for eng in ("stream", "cuda"):
            profile_solve(torch, plan, big_inputs, eng, name, card, best[eng])

    rows = []
    for name, src, repl, case in (
        ("warp_jtj_apply", "opt_tpu_torch/csrc/warp_kernels.cu",
         "opt_tpu/ops/vmem_solver.py:206", "warp_jtj_apply"),
        ("pcg_update", "opt_tpu_torch/csrc/pcg_update.cu",
         "opt_tpu/ops/pcg_pallas.py:50", "pcg_update"),
        ("warp_linearize", "opt_tpu_torch/csrc/warp_kernels.cu",
         "opt_tpu/ops/vmem_solver.py:206", "warp_linearize"),
        ("warp_hat_apply", "opt_tpu_torch/csrc/stream_kernels.cu",
         "opt_tpu/ops/stream_solver.py:763", "warp_hat_apply(lm)"),
        ("warp_pipelined_sweep", "opt_tpu_torch/csrc/stream_kernels.cu",
         "opt_tpu/ops/stream_solver.py:1216", "warp_pipelined_sweep"),
    ):
        err = max(v["max_abs_err"] for k, v in timings.items()
                  if k.split("(")[0] == name)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": total[name],
                     "max_abs_err": err, "ms": timings[case]["ms"],
                     "plain_ms": timings[case]["plain_ms"]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
