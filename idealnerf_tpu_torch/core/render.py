"""The plain hierarchical volume renderer (counterpart of core/render.py).

Field functions have signature ``field_fn(pts, viewdirs) -> raw`` with
``pts`` (R, S, 3), ``viewdirs`` (R, 3), ``raw`` (R, S, 4); conditioning is
closed over (models/face_nerf.py folds it into biases). The frame render
of the port goes through kernels/fused_render.py instead; this function
is the unfused reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from idealnerf_tpu_torch.core.composite import raw2outputs
from idealnerf_tpu_torch.core.sampling import sample_pdf, stratified_sample

FieldFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer knobs, names matching the reference flags."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: bool = True
    lindisp: bool = False
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    density_activation: str = "relu"  # "relu" (reference) | "softplus"

    def eval_mode(self) -> "RenderConfig":
        """perturb=0, no noise — the reference's render_kwargs_test."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0)


def render_draws(generator: Optional[torch.Generator], n_rays: int,
                 cfg: RenderConfig, device=None) -> list:
    """The random numbers ``render_rays`` draws from ``generator`` for
    ``n_rays`` float32 rays, in its order and shapes: the stratified
    jitter, the coarse density noise, the importance uniforms and the fine
    density noise, each where ``cfg`` asks for it. Row i of each belongs to
    ray i, so ``render_rays(..., generator=Replay([t[rows] for t in
    draws]))`` renders those rows as the whole call would; the generator
    ends where the whole call leaves it."""
    if generator is None or not cfg.perturb:
        return []
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    out = [torch.rand((n_rays, cfg.n_samples), **kw)]
    if cfg.raw_noise_std > 0.0:
        out.append(torch.randn((n_rays, cfg.n_samples), **kw))
    if cfg.n_importance > 0:
        out.append(torch.rand((n_rays, cfg.n_importance), **kw))
        if cfg.raw_noise_std > 0.0:
            out.append(torch.randn((n_rays, cfg.n_samples
                                    + cfg.n_importance), **kw))
    return out


def render_rays(
    coarse_fn: FieldFn,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    bc_rgb: torch.Tensor,
    near,
    far,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    fine_fn: Optional[FieldFn] = None,
) -> Dict[str, torch.Tensor]:
    """Hierarchical render of (R, 3) rays against coarse (+fine) fields."""
    n_rays = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    gen = generator if cfg.perturb else None

    z_vals = stratified_sample(
        near, far, cfg.n_samples, n_rays, generator=gen,
        lindisp=cfg.lindisp, dtype=rays_o.dtype, device=rays_o.device,
    )
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    coarse = raw2outputs(
        coarse_fn(pts, viewdirs), z_vals, rays_d, bc_rgb,
        raw_noise_std=cfg.raw_noise_std, white_bkgd=cfg.white_bkgd,
        generator=gen, density_activation=cfg.density_activation,
    )

    out = {
        "rgb_map": coarse.rgb,
        "disp_map": coarse.disp,
        "depth_map": coarse.depth,
        "depth_std": coarse.depth_std,
        "depth_band": coarse.depth_band,
        "acc_map": coarse.acc,
        "rgb_fg": coarse.rgb_fg,
        "last_weight": coarse.last_weight,
        "weights": coarse.weights,
    }
    if cfg.n_importance <= 0:
        return out

    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(
        z_mid, coarse.weights[..., 1:-1], cfg.n_importance, generator=gen
    ).detach()
    z_all, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]

    fine = raw2outputs(
        (fine_fn or coarse_fn)(pts, viewdirs), z_all, rays_d, bc_rgb,
        raw_noise_std=cfg.raw_noise_std, white_bkgd=cfg.white_bkgd,
        generator=gen, density_activation=cfg.density_activation,
    )

    out.update(
        rgb_map=fine.rgb,
        disp_map=fine.disp,
        depth_map=fine.depth,
        depth_std=fine.depth_std,
        depth_band=fine.depth_band,
        acc_map=fine.acc,
        rgb_fg=fine.rgb_fg,
        last_weight=fine.last_weight,
        weights=fine.weights,
        rgb0=coarse.rgb,
        disp0=coarse.disp,
        acc0=coarse.acc,
        rgb_fg0=coarse.rgb_fg,
        last_weight0=coarse.last_weight,
        z_std=torch.std(z_samples, dim=-1, unbiased=False),
    )
    return out
