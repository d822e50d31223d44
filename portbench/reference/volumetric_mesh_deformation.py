"""volumetric_mesh_deformation's residuals in closed form (Opt's
examples/volumetric_mesh_deformation/volumetric_mesh_deformation.t:1-20),
on (D, H, W, C) arrays for dims (W, H, D):

  reg, for each of the six neighbours n of a node c on the grid:
      w_reg * ((Offset_c - Offset_n) - R(Angle_c) (UrShape_c - UrShape_n))
  fit, where Constraints' channel 0 is >= -999999.9:
      w_fit * (Offset_c - Constraints_c)

with R(alpha, beta, gamma) = Rz(gamma) Ry(beta) Rx(alpha), Opt's Rotate3D.
No node is excluded.
"""

from __future__ import annotations

import torch

from .grid import Family, GridEnergy, inside

UNKNOWNS = (("Offset", 3), ("Angle", 3))
# (i, j, k) offsets along dims (W, H, D)
STENCIL = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
           (0, 0, -1))


def rotate3d(a, v):
    ca, cb, cg = torch.cos(a[..., 0]), torch.cos(a[..., 1]), torch.cos(
        a[..., 2])
    sa, sb, sg = torch.sin(a[..., 0]), torch.sin(a[..., 1]), torch.sin(
        a[..., 2])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack((
        cg * cb * x + (-sg * ca + cg * sb * sa) * y
        + (sg * sa + cg * sb * ca) * z,
        sg * cb * x + (cg * ca + sg * sb * sa) * y
        + (-cg * sa + sg * sb * ca) * z,
        -sb * x + cb * sa * y + cb * ca * z), dim=-1)


def build(inputs, dtype, device):
    """The GridEnergy of one set of numpy inputs."""
    def t(name):
        return torch.as_tensor(inputs[name]).to(device=device, dtype=dtype)

    ur, cons = t("UrShape"), t("Constraints")
    w_fit, w_reg = float(inputs["w_fitSqrt"]), float(inputs["w_regSqrt"])
    x0 = torch.cat([t("Offset"), t("Angle")], dim=-1)
    grid = x0.shape[:-1]

    def reg(uc, un, cc, cn):
        return w_reg * ((uc[..., :3] - un[..., :3])
                        - rotate3d(uc[..., 3:], cc - cn))

    families = [Family(reg, inside(grid, (k, j, i), device), ur, (k, j, i))
                for i, j, k in STENCIL]
    fit_valid = cons[..., 0] >= -999999.9
    cons = torch.where(fit_valid[..., None], cons, torch.zeros_like(cons))
    families.append(Family(lambda uc, un, cc, cn: w_fit * (uc[..., :3] - cc),
                           fit_valid, cons))
    return GridEnergy(x0, UNKNOWNS, families)
