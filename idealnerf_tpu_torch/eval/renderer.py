"""Full-frame rendering (counterpart of eval/renderer.py, the fused "ray"
paths of ``make_frame_renderer`` and ``make_composite_frame_renderer``)
and the subject foreground prior.

A field's frame is one whole-frame call pair of the fused kernels — the
coarse pass with the importance depth placement, then the fine pass —
with no host-side tiling; the composite renders the head and the torso
field so and layers them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from idealnerf_tpu_torch.core.composite import layered_composite
from idealnerf_tpu_torch.core.rays import get_rays
from idealnerf_tpu_torch.core.render import RenderConfig
from idealnerf_tpu_torch.kernels.fused_render import render_rays_fused
from idealnerf_tpu_torch.models.face_nerf import fold_conditioning


def _render_field(params, nerf_cfg, H: int, W: int, focal, pose, bc,
                  near, far, cfg: RenderConfig, cx, cy, aud=None, expr=None,
                  latent=None) -> Dict[str, torch.Tensor]:
    """One field's whole-frame render from ``pose``: fold the conditioning
    into each net's biases, cast the rays on the pose's device, run the
    fused passes. ``bc`` is the (H*W, 3) f32 plate."""
    fine = params["fine"] if "fine" in params else None
    folded_c = fold_conditioning(params["coarse"], nerf_cfg, aud, expr,
                                 latent)
    folded_f = (fold_conditioning(fine, nerf_cfg, aud, expr, latent)
                if fine is not None else None)
    rays_o, rays_d = get_rays(H, W, focal, pose, cx, cy)
    return render_rays_fused(
        params["coarse"], folded_c, nerf_cfg,
        rays_o.reshape(-1, 3).contiguous(),
        rays_d.reshape(-1, 3).contiguous(), bc, near, far, cfg.n_samples,
        cfg.n_importance, fine_params=fine, fine_folded=folded_f,
        lindisp=cfg.lindisp)


def _plate(bc_img: torch.Tensor) -> torch.Tensor:
    return bc_img.reshape(-1, 3).float().contiguous()


def make_frame_renderer(
    nerf_cfg,
    H: int, W: int, focal, near, far, cfg: RenderConfig,
    cx=None, cy=None,
) -> Callable:
    """-> ``render(params, pose, bc_img, aud, expr, latent) -> (H, W, 3)``.

    ``params`` holds "coarse" and optionally "fine" FaceNeRF modules; the
    per-frame conditioning is folded into their biases, and the rays are
    built on the device of ``pose``. Deterministic eval semantics."""
    cfg = cfg.eval_mode()

    @torch.no_grad()
    def render(params, pose, bc_img, aud=None, expr=None, latent=None):
        out = _render_field(params, nerf_cfg, H, W, focal, pose,
                            _plate(bc_img), near, far, cfg, cx, cy, aud,
                            expr, latent)
        return out["rgb_map"].reshape(H, W, 3)

    return render


def make_composite_frame_renderer(
    head_cfg, torso_cfg,
    H: int, W: int, focal, near, far, cfg: RenderConfig,
    cx=None, cy=None,
) -> Callable:
    """-> ``render(head_params, torso_params, pose, pose0, bc_img, aud,
    signal, expr, latent) -> (H, W, 3)``: the head field from ``pose``
    (conditioned on aud, expr, latent) and the torso field from the fixed
    first-frame pose ``pose0`` (conditioned on the torso ``signal``), each
    a coarse + fine pass pair over the whole frame, layered as
    ``rgb_head · last_weight_torso + rgb_fg_torso``. Deterministic eval
    semantics."""
    cfg = cfg.eval_mode()

    @torch.no_grad()
    def render(head_params, torso_params, pose, pose0, bc_img, aud=None,
               signal=None, expr=None, latent=None):
        bc = _plate(bc_img)
        head = _render_field(head_params, head_cfg, H, W, focal, pose, bc,
                             near, far, cfg, cx, cy, aud, expr, latent)
        torso = _render_field(torso_params, torso_cfg, H, W, focal, pose0,
                              bc, near, far, cfg, cx, cy, signal)
        return layered_composite(head["rgb_map"].reshape(H, W, 3),
                                 torso["last_weight"].reshape(H, W),
                                 torso["rgb_fg"].reshape(H, W, 3))

    return render


def _head_support(dataset, margin: int, head_parse: bool) -> np.ndarray:
    """The union of the frames' face rects grown by ``margin``; under
    ``head_parse`` each rect is replaced by the parse silhouette clipped
    to it, where that silhouette covers at least 10 % of the rect."""
    H, W = dataset.hw
    mask = np.zeros((H, W), bool)
    parse = (np.asarray(dataset.torso_masks).astype(bool)
             if head_parse else None)
    for i in range(dataset.size):
        x, y, w, h = [int(v) for v in dataset.face_rects[i]]
        y0, y1 = max(y - margin, 0), min(y + h + margin, H)
        x0, x1 = max(x - margin, 0), min(x + w + margin, W)
        rect = np.zeros((H, W), bool)
        rect[y0:y1, x0:x1] = True
        if parse is not None:
            sil = parse[i] & rect
            if sil.sum() >= 0.10 * rect.sum():
                mask |= sil
                continue
        mask |= rect
    return mask


def foreground_prior_fields(dataset, margin: int = 12,
                            head_parse: bool = False):
    """Per-field subject priors for the temporal composite -> (mask_head,
    mask_torso), (H, W) bools: the head's support is the union of the
    face rects (``head_parse`` as in ``foreground_prior``), the torso's
    the union of the torso masks, each dilated by ``margin`` pixels.
    Outside its own support a trained field is empty (the head composites
    the plate, the torso transmits), so each field renders only its own
    prior's rays."""
    from scipy.ndimage import binary_dilation

    mask_h = binary_dilation(_head_support(dataset, margin, head_parse),
                             iterations=margin)
    mask_t = binary_dilation(dataset.torso_masks.any(0).astype(bool),
                             iterations=margin)
    return mask_h, mask_t


def foreground_prior(dataset, margin: int = 12, head_parse: bool = False):
    """Subject foreground prior for masked rendering: the union of all
    frames' face rects and torso masks, dilated by ``margin`` pixels ->
    (mask (H, W) bool, k) with k the mask's pixel count padded to a
    multiple of 256 (at most H*W).

    ``head_parse``: replace each frame's face-rect box by the parse
    silhouette clipped to it, where that silhouette covers at least 10 %
    of the box."""
    from scipy.ndimage import binary_dilation

    H, W = dataset.hw
    mask = _head_support(dataset, margin, head_parse)
    mask |= dataset.torso_masks.any(0).astype(bool)
    mask = binary_dilation(mask, iterations=margin)
    k = int(mask.sum())
    k = min(H * W, ((k + 255) // 256) * 256)
    return mask, k
