"""image_warping's residuals in closed form (Opt's
examples/image_warping/image_warping.t: regularization :44-52, fitting
:101-104), on (H, W, C) arrays for dims (W, H):

  reg, for each of the four neighbours n of a point c where both lie on the
  grid and neither is masked:
      w_reg * ((Offset_c - Offset_n) - R(Angle_c) (UrShape_c - UrShape_n))
  fit, where both Constraints channels are >= 0:
      w_fit * (Offset_c - Constraints_c)

with R(a) the 2-D rotation by a.  A point whose Mask is not 0 is excluded:
its unknowns never move and the cost leaves out its residuals.
"""

from __future__ import annotations

import torch

from .grid import Family, GridEnergy, inside, shift

UNKNOWNS = (("Offset", 2), ("Angle", 1))
# (x, y) offsets along dims (W, H), as the energy's stencil lists them
STENCIL = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _rotate(a, v):
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack((c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]), dim=-1)


def build(inputs, dtype, device):
    """The GridEnergy of one set of numpy inputs."""
    def t(name):
        return torch.as_tensor(inputs[name]).to(device=device, dtype=dtype)

    ur, cons, mask = t("UrShape"), t("Constraints"), t("Mask")[..., 0]
    w_fit, w_reg = float(inputs["w_fitSqrt"]), float(inputs["w_regSqrt"])
    keep = mask == 0
    x0 = torch.cat([t("Offset"), t("Angle")], dim=-1)

    def reg(uc, un, cc, cn):
        return w_reg * ((uc[..., :2] - un[..., :2])
                        - _rotate(uc[..., 2], cc - cn))

    families = []
    for dx, dy in STENCIL:
        offset = (dy, dx)  # array axes (H, W)
        valid = (inside(keep.shape, offset, device) & keep
                 & shift(keep[..., None], offset)[..., 0])
        families.append(Family(reg, valid, ur, offset))
    fit_valid = torch.all(cons >= 0, dim=-1)
    cons = torch.where(fit_valid[..., None], cons, torch.zeros_like(cons))
    families.append(Family(lambda uc, un, cc, cn: w_fit * (uc[..., :2] - cc),
                           fit_valid, cons))
    return GridEnergy(x0, UNKNOWNS, families, counted=keep, free=keep)
