"""arap_mesh_deformation (Opt's examples/arap_mesh_deformation): the seeded
inputs, the work a vertex and an edge need (POINT and EDGE, which
benchlib/work.py counts a solve's calls from), the size the tests run it
at and the kernels that run its inner PCG on the graph engine.

inputs() is one frame of a mesh edited frame after frame: the triangulated
side x side grid (both orientations of each edge, about 6 a vertex), the
mesh of a depth map, at unit spacing with a fixed smooth height field,
the same topology and rest shape in every entry.  The seed sets the frame:
rows 0-1 are pinned at rest; the last two rows and one interior handle
disc (radius side / 32, centred) are each moved by a seeded vector with
components in [-5, 5]; every other vertex is free (Constraints -1e7).  The
Offsets start at the rest shape plus 0.01 of seeded noise, the Angles at
0; w_fit 2, w_reg 1 (bench.aux_arap's).
"""

from __future__ import annotations

import math

import numpy as np

# the size the tests run it at, and the engine: a 128 x 128 mesh, 97,282
# directed edges, where the check's control (the reference in bfloat16)
# already fails the cell's limits, as it does at the full size
SMALL = {"dims": [16384, 97282], "outer": 2, "pcg": 10, "engine": "graph"}

# the graph engine (ops/graph_cuda.py): K11's edge and vertex passes, the
# apply of every PCG iteration and LM's residual resets, and K2's hat-mode
# update
PCG_KERNELS = ("graph_hat_edge", "graph_hat_vertex", "pcg_update")
APPLY_KERNELS = ("graph_hat_edge", "graph_hat_vertex")

# float32 words a vertex: the unknowns (Offset 3, Angle 3); the constants
# (UrShape 3, Constraints 3); what J^T J p reads besides the vectors (the
# Angle, UrShape and Constraints' channel 0, the fit's validity).
# Operations a vertex, a sincosf taken as 40: its rotation R(Angle) (three
# sincosf and the products, 150) and R's three derivatives (60 more) once,
# for every edge that leaves it; the fit's three residuals; 12 a word for a
# PCG iteration's vector updates and dots.
POINT = {"unknowns": 6, "consts": 6, "apply_reads": 7,
         "ops": {"linearize": 230, "cost": 165, "model_cost": 225,
                 "apply": 220, "vector": 12}}
# an edge holds no unknown; its constants are the two index words (v0, v1),
# which J^T J p reads too.  Operations an edge: the residual w_reg ((Offset_0
# - Offset_1) - R (UrShape_0 - UrShape_1)) from its vertices' rotation, 33;
# J's angle columns dR_k (UrShape_0 - UrShape_1), 48; J^T F and diag 49
# more; J p and J^T (J p) 62; the model cost's residual and J delta, 120.
# What the graph engine materializes (K11's 27 partials an edge) is a
# kernel's choice and not counted.
EDGE = {"unknowns": 0, "consts": 2, "apply_reads": 2,
        "ops": {"linearize": 130, "cost": 33, "model_cost": 120,
                "apply": 110, "vector": 0}}

W_FIT, W_REG = 2.0, 1.0
FREE = -1e7  # Constraints of a free vertex: the fit's test is >= -999999.9
MOVE = 5.0  # a handle moves by up to this much along each axis


def side_of(dims):
    """The side of the square mesh with dims [vertices, edges]."""
    side = math.isqrt(int(dims[0]))
    if side * side != dims[0] or side < 8:
        raise ValueError(f"dims {dims}: the mesh is a square of 8 x 8 "
                         "vertices or more")
    if 2 * (3 * side - 1) * (side - 1) != dims[1]:
        raise ValueError(f"dims {dims}: a {side} x {side} mesh has "
                         f"{2 * (3 * side - 1) * (side - 1)} edges")
    return side


def tri_grid_graph(w, h):
    """The triangulated w x h grid's edges, both orientations: the
    horizontal, vertical and diagonal pairs, then each reversed (a copy of
    bench.tri_grid_graph)."""
    vid = np.arange(w * h).reshape(h, w)
    pairs = [
        (vid[:, :-1].ravel(), vid[:, 1:].ravel()),
        (vid[:-1, :].ravel(), vid[1:, :].ravel()),
        (vid[:-1, :-1].ravel(), vid[1:, 1:].ravel()),
    ]
    v0 = np.concatenate([a for a, b in pairs] + [b for a, b in pairs])
    v1 = np.concatenate([b for a, b in pairs] + [a for a, b in pairs])
    return v0.astype(np.int32), v1.astype(np.int32)


def rest_shape(side):
    """(side^2, 3) float32: the grid at unit spacing, x along a row, y down
    the rows, z a smooth height field of amplitude side / 16."""
    i, j = np.meshgrid(np.arange(side, dtype=np.float64),
                       np.arange(side, dtype=np.float64), indexing="ij")
    z = (side / 16) * np.sin(2 * np.pi * j / side) * np.cos(
        2 * np.pi * i / side)
    return np.stack([j, i, z], axis=-1).reshape(-1, 3).astype(np.float32)


def handles(side):
    """(pinned, top, disc): bool (side^2,) masks of rows 0-1, the last two
    rows and the centred disc of radius side / 32 (at least 2)."""
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    c, r = side // 2, max(side / 32, 2.0)
    disc = (i - c) ** 2 + (j - c) ** 2 <= r * r
    return ((i < 2).ravel(), (i >= side - 2).ravel(), disc.ravel())


def inputs(dims, seed):
    """The numpy inputs of one solve on the square mesh of dims [vertices,
    edges], from seed (0 to 2**32 - 1)."""
    side = side_of(dims)
    rng = np.random.RandomState(seed)
    top_move = rng.uniform(-MOVE, MOVE, 3).astype(np.float32)
    disc_move = rng.uniform(-MOVE, MOVE, 3).astype(np.float32)
    noise = rng.randn(side * side, 3).astype(np.float32)
    ur = rest_shape(side)
    pinned, top, disc = handles(side)
    cons = np.full_like(ur, FREE)
    cons[pinned] = ur[pinned]
    cons[top] = ur[top] + top_move
    cons[disc] = ur[disc] + disc_move
    v0, v1 = tri_grid_graph(side, side)
    return {
        "Offset": ur + np.float32(0.01) * noise,
        "Angle": np.zeros_like(ur),
        "UrShape": ur,
        "Constraints": cons,
        "w_fitSqrt": W_FIT,
        "w_regSqrt": W_REG,
        "G": {"v0": v0, "v1": v1},
    }
