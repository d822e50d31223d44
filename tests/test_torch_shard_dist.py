"""The group form of a slab mesh (parallel/mesh.py): two processes of a
torch.distributed gloo group, one slab each, against the slab form of the
same mesh in one process.  The ranks run this file as a script (its
__main__ branch imports only torch, numpy and opt_tpu_torch: no JAX is
started in them), rendezvous on a file store under tmp_path (no port, so
files that pytest-xdist runs side by side cannot collide), and write the
final cost and unknowns of each engine; rank 0's and rank 1's must agree,
and both must equal the slab form's within rtol 1e-5.

One outer step of three PCG iterations on image_warping 32x16 (the
"stream" engine on K15's and K3's plain versions, and the "halo" engine)
and on volumetric ARAP 16x8x8 ("stream3d"), GN and LM; each rank has 60 s.
"""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
CASES = (("stream", "gaussNewtonGPU"), ("stream", "LMGPU"),
         ("halo", "gaussNewtonGPU"), ("stream3d", "gaussNewtonGPU"),
         ("stream3d", "LMGPU"))


def warp_inputs(W, H, seed=0):
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
    cons[0, :W // 4] = ur[0, :W // 4] + 0.5
    cons[-1, -W // 4:] = ur[-1, -W // 4:] - 0.3
    mask = np.zeros((H, W, 1), np.float32)
    mask[7, 5] = mask[8, 20] = 1.0  # on both sides of the slab edge
    return {"Offset": 0.1 * rng.randn(H, W, 2).astype(np.float32),
            "Angle": 0.1 * rng.randn(H, W, 1).astype(np.float32),
            "UrShape": ur, "Constraints": cons, "Mask": mask,
            "w_fitSqrt": np.sqrt(0.5), "w_regSqrt": np.sqrt(2.0)}


def vol_inputs(W, H, D, seed=2):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                                indexing="ij"), -1).astype(np.float32)
    cons = np.full_like(grid, -np.inf)
    cons[:, 0] = grid[:, 0]
    cons[:, -1] = grid[:, -1] + np.float32(1.5)
    return {"Offset": grid + 0.01 * rng.randn(*grid.shape).astype(np.float32),
            "UrShape": grid.copy(), "Angle": np.zeros_like(grid),
            "Constraints": cons, "w_fitSqrt": 1.0,
            "w_regSqrt": np.sqrt(0.5)}


def solve(engine, kind, mesh):
    """(final cost, name -> unknowns) of one solve over the mesh."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    vol = engine == "stream3d"
    energy = (energies.volumetric_mesh_deformation if vol
              else energies.image_warping)
    dims, inputs = (([16, 8, 8], vol_inputs(16, 8, 8)) if vol
                    else ([32, 16], warp_inputs(32, 16)))
    state = opt_tpu_torch.NewState(device="cpu")
    plan = state.problem_plan(state.problem_define(energy, kind), dims)
    plan.set_solver_parameter("nIterations", 1)
    plan.set_solver_parameter("lIterations", 3)
    cost = plan.solve(inputs, engine=engine, mesh=mesh)
    assert plan.engine == engine
    return cost, plan.unknowns()


def run_rank(rank, store, out):
    import torch.distributed as dist

    from opt_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=RANKS)
    try:
        mesh = make_mesh(group=dist.group.WORLD, device="cpu")
        assert (mesh.n, mesh.S, mesh.first) == (RANKS, 1, rank)
        results = {}
        for engine, kind in CASES:
            cost, x = solve(engine, kind, mesh)
            results[f"{engine}.{kind}.cost"] = np.float64(cost)
            for n, v in x.items():
                results[f"{engine}.{kind}.{n}"] = v
        np.savez(out, **results)
    finally:
        dist.destroy_process_group()


def test_group_form_matches_slab_form(tmp_path):
    from opt_tpu_torch.parallel.mesh import make_mesh

    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank),
         str(tmp_path / "store"), str(tmp_path / f"rank{rank}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(RANKS)]
    for proc in procs:
        try:
            log = proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, log
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(RANKS)]
    torch.set_num_threads(1)
    slab = make_mesh(RANKS, device="cpu")
    for engine, kind in CASES:
        cost, x = solve(engine, kind, slab)
        for ranks in got:
            key = f"{engine}.{kind}"
            np.testing.assert_allclose(ranks[f"{key}.cost"], cost,
                                       rtol=1e-5, err_msg=key)
            for n, v in x.items():
                np.testing.assert_allclose(ranks[f"{key}.{n}"], v,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{key} {n}")


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
