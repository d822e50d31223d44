"""K2's plain version against opt_tpu.ops.pcg_pallas.fused_pcg_update run
in interpret mode (as the JAX package's own tests run it on the CPU), GN
and LM, rtol 1e-6.  The vectors are elementwise f32 arithmetic in the same
order.  The two sums are f32 reductions in another order, so each is held
to 1e-6 of the sum of its terms' magnitudes: <z, r> has no cancellation
(z r = pre r^2 >= 0), while the LM q = 0.5 <delta, r + b> of random
vectors cancels to a small fraction of its terms."""

import numpy as np
import pytest
import torch

from opt_tpu.ops.pcg_pallas import fused_pcg_update
from opt_tpu_torch.ops.pcg_update import pcg_update, pcg_update_plain
from opt_tpu_torch.runtime.trace import LAUNCHES
from tests.test_torch_evaluate import assert_close

torch.set_num_threads(1)

RTOL = 1e-6


def operands(n, seed):
    rng = np.random.RandomState(seed)
    v = {k: rng.randn(n).astype(np.float32)
         for k in ("p", "ap", "delta", "r", "b")}
    v["pre"] = rng.rand(n).astype(np.float32)
    return np.float32(0.37), v


@pytest.mark.parametrize("uses_lambda", [False, True], ids=["gn", "lm"])
@pytest.mark.parametrize("n", [576, 1000])
def test_plain_matches_pallas_interpret(uses_lambda, n):
    alpha, v = operands(n, seed=n)
    want = fused_pcg_update(alpha, v["p"], v["ap"], v["delta"], v["r"],
                            v["pre"], v["b"], uses_lambda=uses_lambda,
                            interpret=True)
    t = {k: torch.as_tensor(a) for k, a in v.items()}
    got = pcg_update_plain(torch.tensor(alpha), t["p"], t["ap"], t["delta"],
                           t["r"], t["pre"], t["b"] if uses_lambda else None)
    for g, w, name in zip(got[:3], want[:3], ("delta", "r", "z")):
        assert_close(g.numpy(), w, RTOL, name)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=RTOL)
    if uses_lambda:
        terms = 0.5 * np.abs(np.asarray(want[0]) * (np.asarray(want[1])
                                                    + v["b"])).sum()
        assert float(got[4]) == pytest.approx(float(want[4]),
                                              abs=RTOL * terms)
    else:
        assert got[4] is None


def test_wrapper_on_cpu_is_the_plain_version():
    alpha, v = operands(300, seed=1)
    t = {k: torch.as_tensor(a) for k, a in v.items()}
    before = LAUNCHES["K2.pcg_update"]
    got = pcg_update(torch.tensor(alpha), t["p"], t["ap"], t["delta"],
                     t["r"], t["pre"], t["b"])
    want = pcg_update_plain(torch.tensor(alpha), t["p"], t["ap"],
                            t["delta"], t["r"], t["pre"], t["b"])
    assert LAUNCHES["K2.pcg_update"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_raises_for_tensors_off_cpu_and_cuda():
    m = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        pcg_update(torch.empty((), device="meta"), m, m, m, m, m)
