"""arap_mesh_deformation's residuals in closed form (Opt's
examples/arap_mesh_deformation/arap_mesh_deformation.t: fitting :46-48,
regularization :51-52), on (N, C) arrays of the mesh's vertices and the
graph G's edges (v0, v1):

  fit, at each vertex whose Constraints' channel 0 is >= -999999.9:
      w_fit * (Offset_v - Constraints_v)
  reg, at each edge:
      w_reg * ((Offset_v0 - Offset_v1) - R(Angle_v0) (UrShape_v0 - UrShape_v1))

with R(alpha, beta, gamma) = Rz(gamma) Ry(beta) Rx(alpha), Opt's Rotate3D.
No vertex is excluded.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import Family, GraphEnergy
from .volumetric_mesh_deformation import rotate3d

UNKNOWNS = (("Offset", 3), ("Angle", 3))


def build(inputs, dtype, device):
    """The GraphEnergy of one set of numpy inputs."""
    def t(name):
        return torch.as_tensor(inputs[name]).to(device=device, dtype=dtype)

    def index(slot):
        return torch.tensor(np.asarray(inputs["G"][slot]), dtype=torch.int64,
                            device=device)

    ur, cons = t("UrShape"), t("Constraints")
    w_fit, w_reg = float(inputs["w_fitSqrt"]), float(inputs["w_regSqrt"])
    x0 = torch.cat([t("Offset"), t("Angle")], dim=-1)

    def reg(us, cs):
        (u0, u1), (c0, c1) = us, cs
        return w_reg * ((u0[:, :3] - u1[:, :3])
                        - rotate3d(u0[:, 3:], c0 - c1))

    fit_valid = cons[:, 0] >= -999999.9
    cons = torch.where(fit_valid[:, None], cons, torch.zeros_like(cons))
    families = [
        Family(lambda us, cs: w_fit * (us[0][:, :3] - cs[0]), None, [cons],
               fit_valid),
        Family(reg, [index("v0"), index("v1")], [ur, ur]),
    ]
    return GraphEnergy(x0, UNKNOWNS, families)
