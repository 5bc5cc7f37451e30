"""Alpha compositing of raw field outputs along rays (counterpart of
core/composite.py).

The last sample's colour is the background-plate pixel ``bc_rgb``, so the
field models only the foreground over a static plate; ``rgb_fg`` and
``last_weight`` feed the layered head-over-torso composite.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.sampling import normal


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor          # (R, 3) composited colour (plate included)
    disp: torch.Tensor         # (R,) inverse depth
    acc: torch.Tensor          # (R,) accumulated alpha
    weights: torch.Tensor      # (R, S) per-sample compositing weights
    depth: torch.Tensor        # (R,) expected depth
    rgb_fg: torch.Tensor       # (R, 3) composite excluding the plate sample
    last_weight: torch.Tensor  # (R,) weight of the plate (last) sample
    depth_std: torch.Tensor    # (R,) foreground-weighted depth std
    depth_band: torch.Tensor   # (R, 2) central 96% foreground-mass interval


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    bc_rgb: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    generator: Optional[torch.Generator] = None,
    density_activation: str = "relu",
) -> RenderOutputs:
    """raw (R, S, 4) [rgb logits, sigma] -> composited ray values."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    rgb = torch.cat([rgb[..., :-1, :], bc_rgb[..., None, :]], dim=-2)

    sigma = raw[..., 3]
    if raw_noise_std > 0.0 and generator is not None:
        sigma = sigma + normal(generator, sigma.shape, sigma.dtype,
                               sigma.device) * raw_noise_std

    if density_activation not in ("relu", "softplus"):
        raise ValueError(
            f"density_activation must be 'relu' or 'softplus', got "
            f"{density_activation!r}"
        )
    act = torch.relu if density_activation == "relu" else F.softplus
    alpha = 1.0 - torch.exp(-(act(sigma) + 1e-6) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1),
        dim=-1,
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    rgb_fg = torch.sum(weights[..., :-1, None] * rgb[..., :-1, :], dim=-2)

    depth = torch.sum(weights * z_vals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
    w_fg = weights[..., :-1]
    z_fg = z_vals[..., :-1]
    fg_mass = torch.clamp(torch.sum(w_fg, dim=-1), min=1e-10)
    depth_mean = torch.sum(w_fg * z_fg, dim=-1) / fg_mass
    depth_std = torch.sqrt(torch.clamp(
        torch.sum(w_fg * (z_fg - depth_mean[..., None]) ** 2, dim=-1)
        / fg_mass, min=0.0))
    cw = torch.cumsum(w_fg, dim=-1)
    total = torch.clamp(cw[..., -1:], min=1e-10)
    big = torch.full_like(z_fg, 1e10)
    lo = torch.amin(torch.where(cw >= 0.02 * total, z_fg, big), dim=-1)
    hi = torch.amin(torch.where(cw >= 0.98 * total, z_fg, big), dim=-1)
    depth_band = torch.stack(
        [torch.minimum(lo, z_fg[..., -1]), torch.minimum(hi, z_fg[..., -1])],
        dim=-1)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])

    return RenderOutputs(
        rgb=rgb_map,
        disp=disp,
        acc=acc,
        weights=weights,
        depth=depth,
        rgb_fg=rgb_fg,
        last_weight=weights[..., -1],
        depth_std=depth_std,
        depth_band=depth_band,
    )


def fg_band(z_vals: torch.Tensor, weights: torch.Tensor,
            q_lo: float = 0.02, q_hi: float = 0.98):
    """Per-ray foreground depth band and mass (counterpart of
    eval/temporal.py:fg_band): ``(lo, hi, fg_mass)``, where [lo, hi] holds
    the central ``q_hi - q_lo`` of the ray's weight mass; the last (plate)
    sample is excluded.

    The cumulative weights are summed in float64 and rounded once: a
    one-ulp change of a float32 running sum can flip ``cw >= q * total``
    and move lo or hi by a whole sample gap, so the temporal delta kernel
    sums them the same way and places the same band."""
    w = weights[..., :-1]
    z = z_vals[..., :-1]
    cw = torch.cumsum(w.double(), dim=-1).to(w.dtype)
    total = torch.clamp(cw[..., -1:], min=1e-10)
    big = torch.full_like(z, 1e10)
    lo = torch.amin(torch.where(cw >= q_lo * total, z, big), dim=-1)
    hi = torch.amin(torch.where(cw >= q_hi * total, z, big), dim=-1)
    return (torch.minimum(lo, z[..., -1]), torch.minimum(hi, z[..., -1]),
            cw[..., -1])


def layered_composite(rgb_head: torch.Tensor, last_weight_torso: torch.Tensor,
                      rgb_fg_torso: torch.Tensor) -> torch.Tensor:
    """Head over torso: the torso field's weight on the plate sample gates
    the head render behind the torso's foreground, ``rgb_head ·
    last_weight_torso + rgb_fg_torso``."""
    return rgb_head * last_weight_torso[..., None] + rgb_fg_torso
