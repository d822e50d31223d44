#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU, in turns: the whole-loop
kernels and the 512x512 main path.

    python3 chip_compare.py OTHER_TREE

OTHER_TREE is another checkout of this repository (say a `git archive` of
the parent commit, unpacked under the ignored build/).  Each tree runs in a
process of its own, in the order other, this, this, other, with its own
kernel build, and prints, tagged with the tree:
  - the profiler's device microseconds a launch (chip_smoke's
    device_us_per_launch, 10 launches after 10 in its warm-up step) of
    K13 resident_pcg (image_warping 512x512 x400 and 2048x2048 x100,
    poisson 512x512 x100) and K12 poisson_cg (four channels, one all
    zero, 512x512 x400 and 2048x2048 x100), on chip_smoke's operands;
  - the best of 3 warm solves (chip_smoke.best_of_3) of image_warping
    512x512 GN 8x400 through engine="auto" (bench.py's main path) and
    2048x2048 GN 8x100 on engine="cuda", and the profiler's device busy
    share of the first (chip_smoke.profile_call).
Both trees must carry chip_smoke.py with those functions and K12 and
K13's wrappers.
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
    return 0


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
