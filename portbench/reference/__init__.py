"""The plain reference: each energy's residuals in closed form (one module
an energy), J in local blocks by backward passes over a grid (grid.py) or
a graph (graph.py), and the GN and LM loops with Jacobi-preconditioned
PCG (solver.py).  Plain torch in the precision asked for (float64 for the
check); it imports nothing of opt_tpu_torch, jax or opt_tpu, and takes
only the numpy inputs."""
