"""The ten reference example energies, re-expressed in the Python DSL.

Each function is a clean re-write of the corresponding reference energy file
(reference: examples/<name>/<name>.t) and is cited in its docstring.  They
double as the framework's "model zoo": examples/ builds runnable apps on
top of these, and tests check golden-cost parity against the values in
BASELINE.md.
"""

from __future__ import annotations


def poisson_image_editing(O, channels=4):
    """reference: examples/poisson_image_editing/poisson_image_editing.t:1-13
    (X and T float4; ops/poisson_cuda.is_poisson builds it on 1-4)."""
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    X = O.Unknown("X", channels, (W, H), 0)
    T = O.Array("T", channels, (W, H), 1)
    M = O.Array("M", O.opt_float, (W, H), 2)
    O.UsePreconditioner(False)
    O.Exclude(O.Not(O.eq(M(0, 0), 0)))
    for x, y in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e = (X(0, 0) - X(x, y)) - (T(0, 0) - T(x, y))
        O.Energy(O.Select(O.InBounds(x, y), e, 0))


def image_warping(O):
    """reference: examples/image_warping/image_warping.t (live parts:
    :12-35 declarations, :44-52 regularization, :101-104 fitting)."""
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    Offset = O.Unknown("Offset", O.opt_float2, (W, H), 0)
    Angle = O.Unknown("Angle", O.opt_float, (W, H), 1)
    UrShape = O.Array("UrShape", O.opt_float2, (W, H), 2)
    Constraints = O.Array("Constraints", O.opt_float2, (W, H), 3)
    Mask = O.Array("Mask", O.opt_float, (W, H), 4)
    w_fitSqrt = O.Param("w_fitSqrt", 5)
    w_regSqrt = O.Param("w_regSqrt", 6)
    O.UsePreconditioner(True)
    O.Exclude(O.Not(O.eq(Mask(0, 0), 0)))
    for x, y in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e_reg = w_regSqrt * (
            (Offset(0, 0) - Offset(x, y))
            - O.Rotate2D(Angle(0, 0), UrShape(0, 0) - UrShape(x, y))
        )
        valid = O.InBounds(x, y) * O.eq(Mask(x, y), 0) * O.eq(Mask(0, 0), 0)
        O.Energy(O.Select(valid, e_reg, 0))
    e_fit = Offset(0, 0) - Constraints(0, 0)
    valid = O.All(O.greatereq(Constraints(0, 0), 0))
    O.Energy(w_fitSqrt * O.Select(valid, e_fit, 0.0))


def optical_flow(O):
    """reference: examples/optical_flow/optical_flow.t:1-19."""
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    w_fit = O.Param("w_fit", 0)
    w_reg = O.Param("w_reg", 1)
    X = O.Unknown("X", O.opt_float2, (W, H), 2)
    I = O.Array("I", O.opt_float, (W, H), 3)
    I_hat_im = O.Array("I_hat", O.opt_float, (W, H), 4)
    I_hat_dx = O.Array("I_hat_dx", O.opt_float, (W, H), 5)
    I_hat_dy = O.Array("I_hat_dy", O.opt_float, (W, H), 6)
    I_hat = O.SampledImage(I_hat_im, I_hat_dx, I_hat_dy)
    i, j = O.Index(0), O.Index(1)
    O.UsePreconditioner(False)
    e_fit = w_fit * (I(0, 0) - I_hat(i + X(0, 0, 0), j + X(0, 0, 1)))
    O.Energy(e_fit)
    for nx, ny in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e_reg = w_reg * (X(0, 0) - X(nx, ny))
        O.Energy(O.Select(O.InBounds(nx, ny), e_reg, 0))


def intrinsic_image_decomposition(O):
    """reference: examples/intrinsic_image_decomposition/
    intrinsic_image_decomposition.t:1-31 (Lp-norm IRLS via L_p; r_const is
    a constant view of the unknown r, bound to the same buffer)."""
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    w_fitSqrt = O.Param("w_fitSqrt", 0)
    w_regSqrtAlbedo = O.Param("w_regSqrtAlbedo", 1)
    w_regSqrtShading = O.Param("w_regSqrtShading", 2)
    pNorm = O.Param("pNorm", 3)
    r = O.Unknown("r", O.opt_float3, (W, H), 4)
    r_const = O.Array("r_const", O.opt_float3, (W, H), 4)
    i = O.Array("i", O.opt_float3, (W, H), 5)
    s = O.Unknown("s", O.opt_float, (W, H), 6)

    for x, y in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        diff = r(0, 0) - r(x, y)
        diff_const = r_const(0, 0) - r_const(x, y)
        laplacian = O.L_p(diff, diff_const, pNorm, (W, H))
        guarded = O.Select(
            O.InBounds(0, 0), O.Select(O.InBounds(x, y), laplacian, 0), 0
        )
        O.Energy(w_regSqrtAlbedo * guarded)

    for x, y in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        diff = s(0, 0) - s(x, y)
        guarded = O.Select(
            O.InBounds(0, 0), O.Select(O.InBounds(x, y), diff, 0), 0
        )
        O.Energy(w_regSqrtShading * guarded)

    O.Energy(w_fitSqrt * (r(0, 0) + s(0, 0) - i(0, 0)))


def shape_from_shading(O):
    """reference: examples/shape_from_shading/shape_from_shading.t:1-89.

    Spherical-harmonics shading over a refined depth map; exercises
    ComputedArray-with-gradients, Index() pixel coords, InBoundsExpanded,
    Exclude, and integer edge masks."""
    DEPTH_DISCONTINUITY_THRE = 0.01
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    w_p = O.sqrt(O.Param("w_p", 0))
    w_s = O.sqrt(O.Param("w_s", 1))
    w_g = O.sqrt(O.Param("w_g", 2))
    f_x = O.Param("f_x", 3)
    f_y = O.Param("f_y", 4)
    u_x = O.Param("u_x", 5)
    u_y = O.Param("u_y", 6)
    L = [O.Param(f"L_{k}", 6 + k) for k in range(1, 10)]
    X = O.Unknown("X", O.opt_float, (W, H), 16)
    D_i = O.Array("D_i", O.opt_float, (W, H), 17)
    Im = O.Array("Im", O.opt_float, (W, H), 18)
    edgeMaskR = O.Array("edgeMaskR", O.uint8, (W, H), 19)
    edgeMaskC = O.Array("edgeMaskC", O.uint8, (W, H), 20)

    posX, posY = O.Index(0), O.Index(1)

    def p(ox, oy):  # eq. 8: back-projected 3D point
        d = X(ox, oy)
        i = ox + posX
        j = oy + posY
        return O.Vector(((i - u_x) / f_x) * d, ((j - u_y) / f_y) * d, d)

    def normal_at(ox, oy):  # eq. 10
        i = ox + posX
        j = oy + posY
        n_x = X(ox, oy - 1) * (X(ox, oy) - X(ox - 1, oy)) / f_y
        n_y = X(ox - 1, oy) * (X(ox, oy) - X(ox, oy - 1)) / f_x
        n_z = (
            (n_x * (u_x - i) / f_x)
            + (n_y * (u_y - j) / f_y)
            - (X(ox - 1, oy) * X(ox, oy - 1) / (f_x * f_y))
        )
        sq = n_x * n_x + n_y * n_y + n_z * n_z
        inv_mag = O.Select(O.greater(sq, 0.0), 1.0 / O.sqrt(sq), 1.0)
        return inv_mag * O.Vector(n_x, n_y, n_z)

    def B(ox, oy):  # second-order SH shading
        n = normal_at(ox, oy)
        n_x, n_y, n_z = n[0], n[1], n[2]
        return (
            L[0]
            + L[1] * n_y
            + L[2] * n_z
            + L[3] * n_x
            + L[4] * n_x * n_y
            + L[5] * n_y * n_z
            + L[6] * (-n_x * n_x - n_y * n_y + 2 * n_z * n_z)
            + L[7] * n_z * n_x
            + L[8] * (n_x * n_x - n_y * n_y)
        )

    def I(ox, oy):
        return Im(ox, oy) * 0.5 + 0.25 * (Im(ox - 1, oy) + Im(ox, oy - 1))

    def depth_valid(x, y):
        return O.greater(D_i(x, y), 0)

    def B_I_expr(x, y):
        bi = B(x, y) - I(x, y)
        valid = (
            depth_valid(x - 1, y) * depth_valid(x, y) * depth_valid(x, y - 1)
        )
        return O.Select(O.InBoundsExpanded(0, 0, 1) * valid, bi, 0)

    B_I = O.ComputedArray("B_I", (W, H), B_I_expr(0, 0))

    O.Exclude(O.Not(depth_valid(0, 0)))

    E_p = X(0, 0) - D_i(0, 0)
    O.Energy(O.Select(depth_valid(0, 0), w_p * E_p, 0))

    E_g_h = (B_I(0, 0) - B_I(1, 0)) * edgeMaskR(0, 0)
    E_g_v = (B_I(0, 0) - B_I(0, 1)) * edgeMaskC(0, 0)
    O.Energy(O.Select(O.InBoundsExpanded(0, 0, 1), w_g * E_g_h, 0))
    O.Energy(O.Select(O.InBoundsExpanded(0, 0, 1), w_g * E_g_v, 0))

    def continuous(x, y):
        return O.less(O.abs(X(0, 0) - X(x, y)), DEPTH_DISCONTINUITY_THRE)

    valid = (
        depth_valid(0, 0)
        * depth_valid(0, -1)
        * depth_valid(0, 1)
        * depth_valid(-1, 0)
        * depth_valid(1, 0)
        * continuous(0, -1)
        * continuous(0, 1)
        * continuous(-1, 0)
        * continuous(1, 0)
        * O.InBoundsExpanded(0, 0, 1)
    )
    validArray = O.ComputedArray("valid", (W, H), valid)
    valid = O.eq(validArray(0, 0), 1)
    E_s = 4.0 * p(0, 0) - (p(-1, 0) + p(0, -1) + p(1, 0) + p(0, 1))
    O.Energy(O.Select(valid, w_s * E_s, 0))


def volumetric_mesh_deformation(O):
    """reference: examples/volumetric_mesh_deformation/
    volumetric_mesh_deformation.t:1-20 (3D grid, 6-neighbor ARAP)."""
    W, H, D = O.Dim("W", 0), O.Dim("H", 1), O.Dim("D", 2)
    Offset = O.Unknown("Offset", O.opt_float3, (W, H, D), 0)
    Angle = O.Unknown("Angle", O.opt_float3, (W, H, D), 1)
    UrShape = O.Array("UrShape", O.opt_float3, (W, H, D), 2)
    Constraints = O.Array("Constraints", O.opt_float3, (W, H, D), 3)
    w_fitSqrt = O.Param("w_fitSqrt", 4)
    w_regSqrt = O.Param("w_regSqrt", 5)
    O.UsePreconditioner(True)

    e_fit = Offset(0, 0, 0) - Constraints(0, 0, 0)
    valid = O.greatereq(Constraints(0, 0, 0)(0), -999999.9)
    O.Energy(O.Select(valid, w_fitSqrt * e_fit, 0))

    for i, j, k in O.Stencil(
        [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    ):
        arap = (Offset(0, 0, 0) - Offset(i, j, k)) - O.Rotate3D(
            Angle(0, 0, 0), UrShape(0, 0, 0) - UrShape(i, j, k)
        )
        guarded = O.Select(
            O.InBounds(0, 0, 0), O.Select(O.InBounds(i, j, k), arap, 0.0), 0.0
        )
        O.Energy(w_regSqrt * guarded)


def arap_mesh_deformation(O):
    """reference: examples/arap_mesh_deformation/arap_mesh_deformation.t
    (live parts: declarations :11-22, fitting :46-48, regularization :51-52)."""
    N = O.Dim("N", 0)
    NUMEDGES = O.Dim("NUMEDGES", 1)
    w_fitSqrt = O.Param("w_fitSqrt", 0)
    w_regSqrt = O.Param("w_regSqrt", 1)
    Offset = O.Unknown("Offset", O.opt_float3, (N,), 2)
    Angle = O.Unknown("Angle", O.opt_float3, (N,), 3)
    UrShape = O.Array("UrShape", O.opt_float3, (N,), 4)
    Constraints = O.Array("Constraints", O.opt_float3, (N,), 5)
    G = O.Graph("G", (NUMEDGES,), "v0", (N,), 7, "v1", (N,), 8)
    O.UsePreconditioner(True)

    e_fit = Offset(0) - Constraints(0)
    valid = O.greatereq(Constraints(0, 0), -999999.9)
    O.Energy(O.Select(valid, w_fitSqrt * e_fit, 0))

    arap = (Offset(G.v0) - Offset(G.v1)) - O.Rotate3D(
        Angle(G.v0), UrShape(G.v0) - UrShape(G.v1)
    )
    O.Energy(w_regSqrt * arap)


def cotangent_mesh_smoothing(O):
    """reference: examples/cotangent_mesh_smoothing/
    cotangent_mesh_smoothing.t:1-38 (4-vertex hyper-edges, guarded sqrt)."""
    N = O.Dim("N", 0)
    NUMEDGES = O.Dim("NUMEDGES", 1)
    w_fitSqrt = O.Param("w_fit", 0)
    w_regSqrt = O.Param("w_reg", 1)
    X = O.Unknown("X", O.opt_float3, (N,), 2)
    A = O.Array("A", O.opt_float3, (N,), 3)
    G = O.Graph(
        "G", (NUMEDGES,), "v0", (N,), 5, "v1", (N,), 6, "v2", (N,), 7,
        "v3", (N,), 8,
    )
    O.UsePreconditioner(True)

    def cot(v0, v1):
        adotb = O.Dot3(v0, v1)
        disc = O.Dot3(v0, v0) * O.Dot3(v1, v1) - adotb * adotb
        disc = O.Select(O.greater(disc, 0.0), disc, 0.0001)
        return O.Dot3(v0, v1) / O.Sqrt(disc)

    O.Energy(w_fitSqrt * (X(0) - A(0)))

    a = O.normalize(X(G.v0) - X(G.v2))
    b = O.normalize(X(G.v1) - X(G.v2))
    c = O.normalize(X(G.v0) - X(G.v3))
    d = O.normalize(X(G.v1) - X(G.v3))
    w = 0.5 * (cot(a, b) + cot(c, d))
    w = O.Sqrt(O.Select(O.greater(w, 0.0), w, 0.0001))
    O.Energy(w_regSqrt * w * (X(G.v1) - X(G.v0)))


def embedded_mesh_deformation(O):
    """reference: examples/embedded_mesh_deformation/
    embedded_mesh_deformation.t:1-34 (float9 rotation-matrix unknowns with
    orthonormality penalties)."""
    N = O.Dim("N", 0)
    NUMEDGES = O.Dim("NUMEDGES", 1)
    w_fitSqrt = O.Param("w_fitSqrt", 0)
    w_regSqrt = O.Param("w_regSqrt", 1)
    w_rotSqrt = O.Param("w_rotSqrt", 2)
    Offset = O.Unknown("Offset", O.opt_float3, (N,), 3)
    RotMatrix = O.Unknown("RotMatrix", O.opt_float9, (N,), 4)
    UrShape = O.Array("UrShape", O.opt_float3, (N,), 5)
    Constraints = O.Array("Constraints", O.opt_float3, (N,), 6)
    G = O.Graph("G", (NUMEDGES,), "v0", (N,), 8, "v1", (N,), 9)
    O.UsePreconditioner(True)

    e_fit = Offset(0) - Constraints(0)
    valid = O.greatereq(Constraints(0)(0), -999999.9)
    O.Energy(O.Select(valid, w_fitSqrt * e_fit, 0))

    R = RotMatrix(0)
    c0 = O.Vector(R(0), R(3), R(6))
    c1 = O.Vector(R(1), R(4), R(7))
    c2 = O.Vector(R(2), R(5), R(8))
    O.Energy(w_rotSqrt * O.Dot3(c0, c1))
    O.Energy(w_rotSqrt * O.Dot3(c0, c2))
    O.Energy(w_rotSqrt * O.Dot3(c1, c2))
    O.Energy(w_rotSqrt * (O.Dot3(c0, c0) - 1))
    O.Energy(w_rotSqrt * (O.Dot3(c1, c1) - 1))
    O.Energy(w_rotSqrt * (O.Dot3(c2, c2) - 1))

    reg = (Offset(G.v1) - Offset(G.v0)) - O.Matrix3x3Mul(
        RotMatrix(G.v0), UrShape(G.v1) - UrShape(G.v0)
    )
    O.Energy(w_regSqrt * reg)


def robust_nonrigid_alignment(O):
    """reference: examples/robust_nonrigid_alignment/
    robust_nonrigid_alignment.t:1-30 (robust-weight unknowns, normal-dot
    fitting)."""
    N = O.Dim("N", 0)
    NUMEDGES = O.Dim("NUMEDGES", 1)
    w_fitSqrt = O.Param("w_fitSqrt", 0)
    w_regSqrt = O.Param("w_regSqrt", 1)
    w_confSqrt = 0.1
    Offset = O.Unknown("Offset", O.opt_float3, (N,), 2)
    Angle = O.Unknown("Angle", O.opt_float3, (N,), 3)
    RobustWeights = O.Unknown("RobustWeights", O.opt_float, (N,), 4)
    UrShape = O.Array("UrShape", O.opt_float3, (N,), 5)
    Constraints = O.Array("Constraints", O.opt_float3, (N,), 6)
    ConstraintNormals = O.Array("ConstraintNormals", O.opt_float3, (N,), 7)
    G = O.Graph("G", (NUMEDGES,), "v0", (N,), 9, "v1", (N,), 10)
    O.UsePreconditioner(True)

    rw = RobustWeights(0)
    e_fit = rw * ConstraintNormals(0).dot(Offset(0) - Constraints(0))
    valid = O.greatereq(Constraints(0), -999999.9)
    O.Energy(w_fitSqrt * O.Select(valid, e_fit, 0.0))

    e_conf = 1 - (rw * rw)
    e_conf = O.Select(valid, e_conf, 0.0)
    O.Energy(w_confSqrt * e_conf)

    arap = (Offset(G.v0) - Offset(G.v1)) - O.Rotate3D(
        Angle(G.v0), UrShape(G.v0) - UrShape(G.v1)
    )
    O.Energy(w_regSqrt * arap)


ALL_ENERGIES = {
    "poisson_image_editing": poisson_image_editing,
    "image_warping": image_warping,
    "optical_flow": optical_flow,
    "intrinsic_image_decomposition": intrinsic_image_decomposition,
    "shape_from_shading": shape_from_shading,
    "volumetric_mesh_deformation": volumetric_mesh_deformation,
    "arap_mesh_deformation": arap_mesh_deformation,
    "cotangent_mesh_smoothing": cotangent_mesh_smoothing,
    "embedded_mesh_deformation": embedded_mesh_deformation,
    "robust_nonrigid_alignment": robust_nonrigid_alignment,
}
