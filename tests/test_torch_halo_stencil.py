"""The port's stencil_apply (ops/halo_stencil.py, K14) on CPU tensors,
through its plain version, against the JAX package's stencil_apply in
interpret mode, at tests/test_halo_stencil.py's three shapes and offsets
and at a radius-2 offset set, rtol and atol 1e-5 as that test holds the
JAX kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opt_tpu.ops.halo_stencil import stencil_apply as jax_stencil_apply
from opt_tpu_torch.ops import halo_stencil
from opt_tpu_torch.runtime.trace import LAUNCHES
from tests.test_halo_stencil import OFFSETS, WEIGHTS

torch.set_num_threads(1)

RADIUS2 = ((2, 0), (-2, 1), (0, 2), (1, -2), (0, 0), (-1, -1))
WEIGHTS2 = (0.25, -1.5, 3.0, 0.75, -2.0, 1.25)


@pytest.mark.parametrize("taps", ["radius1", "radius2"])
@pytest.mark.parametrize("shape", [(64, 128), (100, 200), (33, 450)])
def test_stencil_matches_jax(shape, taps):
    offsets, weights = ((OFFSETS, WEIGHTS) if taps == "radius1"
                        else (RADIUS2, WEIGHTS2))
    img = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    want = jax_stencil_apply(jnp.asarray(img), offsets, weights, tile=32,
                             interpret=True)
    launches = LAUNCHES["K14.stencil_apply"]
    got = halo_stencil.stencil_apply(torch.as_tensor(img), offsets, weights,
                                     tile=32)
    assert LAUNCHES["K14.stencil_apply"] == launches  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stencil_refuses_too_many_taps():
    offsets = [(k % 7 - 3, k // 7 - 3) for k in range(halo_stencil.MAX_TAPS
                                                       + 1)]
    with pytest.raises(ValueError, match="taps"):
        halo_stencil.stencil_apply(torch.zeros(8, 8), offsets,
                                   [1.0] * len(offsets))
    with pytest.raises(ValueError, match="weight"):
        halo_stencil.stencil_apply(torch.zeros(8, 8), OFFSETS, WEIGHTS[:-1])
