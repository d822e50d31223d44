"""volumetric_mesh_deformation (Opt's examples/volumetric_mesh_deformation):
the seeded inputs, the work a node needs (POINT, which benchlib/work.py
counts a solve's calls from), the size the tests run it at and the
kernels that run its inner PCG on the stream3d engine.

inputs() is the set-up of bench.aux_volumetric on an n^3 grid of nodes, the
Opt example's own: a regular grid, its H = 0 plane pinned where it is and
its H = n - 1 plane pulled by (2.5, -2.5, 0), every other node free
(Constraints -inf); the Offsets start at the grid plus 0.01 of seeded
noise; w_fit 1, w_reg 0.05.
"""

from __future__ import annotations

import numpy as np

# the size the tests run it at, and the engine that runs it there
SMALL = {"dims": [10, 10, 10], "outer": 3, "pcg": 20, "engine": "stream3d"}

# the stream3d engine (ops/stream3d_cuda.py): K6 the hat apply (every
# classic iteration), K7 the pipelined sweep (on request), K2 the hat-mode
# update
PCG_KERNELS = ("vol_hat_apply", "vol_pipelined_sweep", "pcg_update")

# float32 words a node: the unknowns (Offset 3, Angle 3); the constants
# (UrShape 3, Constraints 3); what J^T J p reads besides the vectors (the
# Angle, UrShape and Constraints' channel 0, the fit's validity).
# Operations a node, a sincosf taken as 40: J^T F and diag(J^T J) 820, the
# cost 370, the model cost 640, J^T J p 860 (one rotation and its
# derivatives, six residuals, the fit), and 12 a word for a PCG
# iteration's vector updates and dots.
POINT = {"unknowns": 6, "consts": 6, "apply_reads": 7,
         "ops": {"linearize": 820, "cost": 370, "model_cost": 640,
                 "apply": 860, "vector": 12}}


def inputs(dims, seed):
    """The numpy inputs of one solve on a (W, H, D) grid of nodes (a cube),
    from seed (0 to 2**32 - 1)."""
    n = dims[0]
    if any(d != n for d in dims):
        raise ValueError(f"the volume is a cube: dims {dims}")
    rng = np.random.RandomState(seed)
    ii, jj, kk = np.meshgrid(
        np.arange(n, dtype=np.float32),
        np.arange(n, dtype=np.float32),
        np.arange(n, dtype=np.float32),
        indexing="ij",
    )
    grid = np.stack([ii, jj, kk], axis=-1)
    cons = np.full_like(grid, -np.inf)
    cons[:, 0] = grid[:, 0]
    cons[:, n - 1] = grid[:, n - 1] + np.array([2.5, -2.5, 0.0],
                                               np.float32)
    return {
        "Offset": grid + 0.01 * rng.randn(*grid.shape).astype(np.float32),
        "UrShape": grid.copy(),
        "Angle": np.zeros_like(grid),
        "Constraints": cons.astype(np.float32),
        "w_fitSqrt": np.sqrt(1.0),
        "w_regSqrt": np.sqrt(0.05),
    }

