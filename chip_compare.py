#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU, in turns: the whole-loop
kernels, the outer-step kernels and the apply kernels beside them, and
the main paths.

    python3 chip_compare.py OTHER_TREE

OTHER_TREE is another checkout of this repository (say a `git archive` of
the parent commit, unpacked under the ignored build/).  Each tree runs in a
process of its own, in the order other, this, this, other, with its own
kernel build (ptxas's registers and spills printed where the process built
it), and prints, tagged with the tree:
  - the profiler's device microseconds a launch (chip_smoke's
    device_us_per_launch, 10 launches after 10 in its warm-up step) of
    K13 resident_pcg (image_warping 512x512 x400 and 2048x2048 x100,
    poisson 512x512 x100) and K12 poisson_cg (four channels, one all
    zero, 512x512 x400 and 2048x2048 x100), on chip_smoke's operands;
  - the same of K3 warp_linearize in each mode (J^T F and diag, the cost
    alone, the model cost) on the 2048x2048 grid and on its 4 slabs, K8
    vol_linearize in each mode on the 128^3 volume and on its 4 D slabs,
    and the apply kernels on the cores they share: K1 warp_jtj_apply (GN
    and LM's ctc) at 2048x2048, K15 warp_slab_apply on the 4 slabs, K6
    vol_hat_apply (GN, p_prev) at 128^3 and K16 vol_slab_apply on its 4
    slabs;
  - the best of 3 warm solves (chip_smoke.best_of_3) of image_warping
    512x512 GN 8x400 through engine="auto" (bench.py's main path) and
    2048x2048 GN 8x100 on engine="cuda", and the profiler's device busy
    share of the first (chip_smoke.profile_call); then 2048x2048 GN 8x100
    and volumetric ARAP 128^3 GN 8x100 through engine="auto" ("stream"
    and "stream3d", pipelined).
Both trees must carry chip_smoke.py with those functions and the kernels'
wrappers.
Exits non-zero where torch sees no CUDA device.
"""

import os
import subprocess
import sys


def measure(root, tag):
    """One tree's numbers, in this process (root first on sys.path)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.ops import build, poisson_cuda, stream_cuda

    build.library()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{tag}: {root} on {card}")
    fns = {}
    for energy, size, n in (("warp", 512, 400), ("warp", 2048, 100),
                            ("poisson", 512, 100)):
        hat, sq, b_hat = cs.resident_operands(torch, energy, size, size, dev)
        fns[f"K13 {energy} {size} x{n}"] = (
            lambda h=hat, s=sq, b=b_hat, n=n: stream_cuda.resident_pcg(
                h, s, b, n))
    for size, n in ((512, 400), (2048, 100)):
        keep = torch.as_tensor((cs.poisson_inputs(size, size)["M"][..., 0]
                                == 0).astype(np.float32), device=dev)
        b = torch.as_tensor(np.random.RandomState(size).randn(
            4, size, size).astype(np.float32), device=dev)
        b[2] = 0.0
        fns[f"K12 C=4 {size} x{n}"] = (
            lambda b=b, keep=keep, n=n: poisson_cuda.poisson_cg(b, keep, n))
    cs.device_us_per_launch(torch, fns, tag, n=10)
    del fns
    torch.cuda.empty_cache()
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"{tag} ptxas: {line.strip()}")
    cs.device_us_per_launch(torch, outer_step_fns(torch, cs, dev), tag,
                            n=10)
    torch.cuda.empty_cache()

    plan = cs.new_plan(opt_tpu_torch, energies, "gaussNewtonGPU", 512, 8,
                       400)
    inputs = cs.warp_inputs(512, 512)
    print(f"{tag} 512x512 GN 8x400 auto: cost {plan.solve(inputs)!r} "
          f"engine {plan.engine}")
    best = cs.best_of_3(torch, plan, inputs, "auto",
                        f"{tag} 512x512 GN 8x400", card)
    cs.profile_call(torch, lambda: plan.solve(inputs),
                    f"{tag} 512x512 GN 8x400 auto", card, best)
    plan = cs.new_plan(opt_tpu_torch, energies, "gaussNewtonGPU", 2048, 8,
                       100)
    inputs = cs.warp_inputs(2048, 2048)
    print(f"{tag} 2048x2048 GN 8x100 cuda: cost "
          f"{plan.solve(inputs, engine='cuda')!r}")
    cs.best_of_3(torch, plan, inputs, "cuda", f"{tag} 2048x2048 GN 8x100",
                 card)
    print(f"{tag} 2048x2048 GN 8x100 auto: cost {plan.solve(inputs)!r} "
          f"engine {plan.engine} {plan.variant}")
    cs.best_of_3(torch, plan, inputs, "auto", f"{tag} 2048x2048 GN 8x100",
                 card)
    plan = cs.new_vol_plan(opt_tpu_torch, energies, "gaussNewtonGPU", None)
    inputs = cs.volume_inputs(cs.VOL)
    print(f"{tag} 128^3 GN 8x100 auto: cost {plan.solve(inputs)!r} engine "
          f"{plan.engine} {plan.variant}")
    cs.best_of_3(torch, plan, inputs, "auto", f"{tag} 128^3 GN 8x100", card)
    return 0


def outer_step_fns(torch, cs, dev):
    """name -> a call of one kernel: K3 and K8 in each mode, whole and on
    cs.SHARD_SLABS slabs, and K1, K15, K6 and K16 beside them, on
    chip_smoke's operands at the paths' sizes."""
    from opt_tpu_torch.ops import slab_cuda as sc
    from opt_tpu_torch.ops import stream3d_cuda, vol_cuda, warp_cuda

    big, vol, S = cs.BIG, cs.VOL, cs.SHARD_SLABS
    fns = {}
    x, ur, cons, mask, params, t = cs.kernel_operands(torch, big, big, dev)
    xs, urs, cs_, ms, _, ts, g = cs.slab_operands(torch, big, big, S, dev)
    for mode, kw, kws in (("full", {}, {}),
                          ("cost", {"cost_only": True}, {"cost_only": True}),
                          ("model", {"delta": t["delta"]},
                           {"delta": ts["delta"]})):
        fns[f"K3 {mode} {big}"] = (
            lambda kw=kw: warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                                   **kw))
        fns[f"K3 {mode} {big} on {S} slabs"] = (
            lambda kw=kws: sc.warp_slab_linearize(xs, urs, cs_, ms, params,
                                                  g, **kw))
    for name, ctc in (("K1", None), ("K1 ctc", t["ctc"])):
        fns[f"{name} {big}"] = (
            lambda ctc=ctc: warp_cuda.warp_jtj_apply(x, t["p"], ur, cons,
                                                     mask, params, ctc))
    fns[f"K15 {big} on {S} slabs"] = (
        lambda: sc.warp_slab_apply(xs, urs, cs_, ms, params, ts["sq"],
                                   ts["p"], g))
    xv, urv, consv, pv, tv = cs.volume_kernel_operands(torch, vol, vol, vol,
                                                       dev)
    xvs, urvs, consvs, _, tvs, gv = cs.vol_slab_operands(torch, vol, vol,
                                                         vol, S, dev)
    for mode, kw, kws in (("full", {}, {}),
                          ("cost", {"cost_only": True}, {"cost_only": True}),
                          ("model", {"delta": tv["delta"]},
                           {"delta": tvs["delta"]})):
        fns[f"K8 {mode} {vol}^3"] = (
            lambda kw=kw: vol_cuda.vol_linearize(xv, urv, consv, pv, **kw))
        fns[f"K8 {mode} {vol}^3 on {S} slabs"] = (
            lambda kw=kws: sc.vol_slab_linearize(xvs, urvs, consvs, pv, gv,
                                                 **kw))
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    fns[f"K6 p_prev {vol}^3"] = (
        lambda: stream3d_cuda.vol_hat_apply(xv, urv, consv, pv, tv["sq"],
                                            None, tv["r"], tv["p"], beta))
    fns[f"K16 {vol}^3 on {S} slabs"] = (
        lambda: sc.vol_slab_apply(xvs, urvs, consvs, pv, tvs["sq"],
                                  tvs["p"], gv))
    return fns


def main(argv):
    if len(argv) == 4 and argv[1] == "--measure":
        return measure(os.path.abspath(argv[2]), argv[3])
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: torch sees no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(argv[1])
    rc = 0
    for root, tag in ((other, "P1"), (here, "N1"), (here, "N2"),
                      (other, "P2")):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", root, tag]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
