"""The benchmark of opt_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json on the card and prints one JSON line.
Everything here is found by the names in BENCHMARK.json:

    configs/<config>.json    sizes, iterations, source, what was assumed
    traffic/<mix>.json       solver kind, pool of inputs, checks, tracing
    energies/<energy>.py     the seeded input generator, the work tables
                             (POINT, and EDGE for a graph energy), the
                             tests' small size (SMALL) and the names of the
                             inner PCG's kernels (PCG_KERNELS)
    reference/<energy>.py    the plain float64 residuals, on a grid
                             (reference/grid.py) or a graph (graph.py);
                             reference/solver.py holds the GN and LM loops
    metrics/<metric>.py      one reader a metric
    limits/<cell>.json       the limits of the cell's output check

Nothing here imports jax, jaxlib or opt_tpu (the JAX package), and
reference/ imports nothing of opt_tpu_torch.
"""
