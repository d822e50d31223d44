"""image_warping (Opt's examples/image_warping): the seeded inputs, the
work a pixel needs (POINT, which benchlib/work.py counts a solve's calls
from), the size the tests run it at and the kernels that run its inner
PCG on the stream engine.

inputs() is bench.warp_inputs, the synthetic field that the port's and the
JAX package's main path have always run: a random UrShape, a band of
constraints on every 20th row with mutually inconsistent targets (so the
optimum's cost stays well above zero), no excluded pixel, w_fit 0.5 and
w_reg 2.
"""

from __future__ import annotations

import numpy as np

# the size the tests run it at, and the engine that runs the cells' kernels
# there in their plain versions on CPU tensors
SMALL = {"dims": [24, 20], "outer": 2, "pcg": 10, "engine": "cuda"}

# the stream engine (ops/stream_cuda.py): K5 the pipelined sweep (GN), K4
# the hat apply (w_0 for GN; every classic iteration and LM's residual
# resets), K2 the hat-mode update (classic)
PCG_KERNELS = ("warp_pipelined_sweep", "warp_hat_apply", "pcg_update")

# float32 words a pixel: the unknowns (Offset 2, Angle 1); the constants
# (UrShape 2, Constraints 2, Mask 1); what J^T J p reads besides the vectors
# (the Angle, UrShape, both Constraints channels for the fit's validity,
# the Mask).  Operations a pixel, a sincosf taken as 40: J^T F and
# diag(J^T J) 200, the cost 100, the model cost 150, J^T J p with LM's ctc
# and <p, Ap> 160 (one rotation a pixel, four residuals), and 12 a word for
# a PCG iteration's vector updates and dots.
POINT = {"unknowns": 3, "consts": 5, "apply_reads": 6,
         "ops": {"linearize": 200, "cost": 100, "model_cost": 150,
                 "apply": 160, "vector": 12}}


def inputs(dims, seed):
    """The numpy inputs of one solve on a (W, H) grid, from seed (0 to
    2**32 - 1)."""
    W, H = dims
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
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

