"""K9 graph_gather and K10 graph_scatter on the CPU (their plain versions,
which the wrappers run on CPU tensors) against jnp.take and
jax.ops.segment_sum, at every channel count the kernels instantiate (1-8)
and one the generic kernel takes (11), in float32 and float64, on an
index with the shapes that stress a segmented sum: an empty index, a
vertex of degree 0, a vertex with a long run, and three slots gathered in
one call.  The gather is held exact (it moves values) and the scatter at
rtol 1e-6 (segment_sum adds in another order).  Also: the edge-order sum
that K10 computes, against which the card tests hold it bit for bit, and
gather()'s path with and without a transform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opt_tpu_torch.ops import graph_cuda

torch.set_num_threads(1)

CHANNELS = (1, 2, 3, 4, 6, 8, 11)
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
N_VERTS, N_EDGES = 40, 600
LONG = 7      # slot 0's vertex with a long run
ISOLATED = 5  # a vertex no edge of slot 0 touches
RTOL = 1e-6


def _index():
    """(3, E) int32: three slots over N_VERTS vertices; in slot 0 vertex
    LONG holds a third of the edges and ISOLATED none."""
    rng = np.random.RandomState(21)
    idx = rng.randint(0, N_VERTS, (3, N_EDGES))
    idx[0, rng.rand(N_EDGES) < 1 / 3] = LONG
    idx[0, idx[0] == ISOLATED] = ISOLATED + 1
    return idx.astype(np.int32)


def _values(c, dtype, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(N_VERTS, c) * 10.0 ** rng.uniform(-3, 3, (N_VERTS, 1))
    x = rng.randn(N_EDGES, c) * 10.0 ** rng.uniform(-3, 3, (N_EDGES, 1))
    return v.astype(dtype), x.astype(dtype)


@pytest.fixture(scope="module")
def reference():
    """(tag, c) -> (v, x, jnp.take(v, idx), [segment_sum(x, idx[s])]),
    each JAX reference built once for the module, float64 under
    jax.enable_x64."""
    idx = _index()
    out = {}
    for tag, (np_dt, _) in DTYPES.items():
        with jax.enable_x64(tag == "f64"):
            for c in CHANNELS:
                v, x = _values(c, np_dt, seed=c)
                take = np.asarray(jnp.take(jnp.asarray(v), idx, axis=0))
                sums = [np.asarray(jax.ops.segment_sum(
                    jnp.asarray(x), jnp.asarray(idx[s]),
                    num_segments=N_VERTS)) for s in range(3)]
                assert take.dtype == np_dt and sums[0].dtype == np_dt
                out[tag, c] = (v, x, take, sums)
    return idx, out


def _close(got, want):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_gather_matches_take(reference, tag, c):
    idx, ref = reference
    v, _, take, _ = ref[tag, c]
    got = graph_cuda.graph_gather(torch.as_tensor(v), torch.as_tensor(idx))
    assert got.shape == (3, N_EDGES, c)
    np.testing.assert_array_equal(got.numpy(), take)
    # one slot, and an empty index
    one = graph_cuda.graph_gather(torch.as_tensor(v), torch.as_tensor(idx[1]))
    np.testing.assert_array_equal(one.numpy(), take[1])
    empty = graph_cuda.graph_gather(torch.as_tensor(v),
                                    torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, c) and empty.dtype == DTYPES[tag][1]


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_scatter_matches_segment_sum(reference, tag, c):
    idx, ref = reference
    _, x, _, sums = ref[tag, c]
    for s in range(3):
        order, rowptr = (torch.as_tensor(a)
                         for a in graph_cuda.incidence(idx[s], N_VERTS))
        got = graph_cuda.graph_scatter(torch.as_tensor(x),
                                       torch.as_tensor(idx[s]), order, rowptr)
        _close(got, sums[s])
        # K10's own order: each run summed from zero in edge order
        mine = chip_smoke.scatter_in_edge_order(torch, torch.as_tensor(x),
                                                order, rowptr)
        assert torch.equal(got, mine)
    degree = np.bincount(idx[0], minlength=N_VERTS)
    assert degree[ISOLATED] == 0 and degree[LONG] > N_EDGES // 4


def test_scatter_of_no_edges_is_zero():
    order, rowptr = (torch.as_tensor(a) for a in graph_cuda.incidence(
        np.zeros(0, np.int32), N_VERTS))
    out = graph_cuda.graph_scatter(torch.zeros(0, 3), torch.zeros(
        0, dtype=torch.int32), order, rowptr)
    assert torch.equal(out, torch.zeros(N_VERTS, 3))
    assert torch.equal(chip_smoke.scatter_in_edge_order(
        torch, torch.zeros(0, 3), order, rowptr), out)


def test_gather_rows_and_derivatives():
    """gather() alone and under torch.func and autograd: the same rows,
    K10's transpose as the vjp and K9 as the jvp."""
    idx = _index()[0]
    order, rowptr = (torch.as_tensor(a)
                     for a in graph_cuda.incidence(idx, N_VERTS))
    idx = torch.as_tensor(idx)
    v, x = (torch.as_tensor(a) for a in _values(6, np.float64, seed=3))
    rows = graph_cuda.gather(v, idx, order, rowptr)
    assert rows.grad_fn is None and torch.equal(rows, v[idx.long()])

    def f(u):
        return graph_cuda.gather(u, idx, order, rowptr)

    out, vjp_fn = torch.func.vjp(f, v)
    assert torch.equal(out, rows)
    assert torch.equal(vjp_fn(x)[0],
                       chip_smoke.scatter_in_edge_order(torch, x, order,
                                                        rowptr))
    _, tangent = torch.func.jvp(f, (v,), (2 * v,))
    assert torch.equal(tangent, 2 * rows)
    leaf = v.clone().requires_grad_()
    f(leaf).backward(x)
    assert torch.equal(leaf.grad, vjp_fn(x)[0])
    with torch.autograd.forward_ad.dual_level():
        dual = torch.autograd.forward_ad.make_dual(v, 3 * v)
        tan = torch.autograd.forward_ad.unpack_dual(f(dual)).tangent
    assert torch.equal(tan, 3 * rows)

