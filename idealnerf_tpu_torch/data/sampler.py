"""Region-stratified ray sampling on the device (counterpart of
data/sampler.py).

Fixed budgets per region (mouth / torso / face / background), each drawn
uniformly without replacement as the exact top-k of masked uniforms.
Regions: mouth = landmark 48+ bbox ±20px; face = face_rect minus mouth;
background = outside face_rect; torso = the torso mask. Budgets:
mouth_rays, torso_rays, face = sample_rate · (N_rand − mouth − torso),
background = the remainder; concatenation order [face, background, mouth,
torso]. Rect membership tests x against columns (the reference swaps the
axes; the JAX package does not copy that, nor does the port).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RayBudget(NamedTuple):
    face: int
    background: int
    mouth: int
    torso: int

    @property
    def total(self) -> int:
        return self.face + self.background + self.mouth + self.torso

    @classmethod
    def from_config(cls, n_rand: int, mouth_rays: int, torso_rays: int,
                    sample_rate: float) -> "RayBudget":
        sample_num = n_rand - mouth_rays - torso_rays
        face = int(sample_num * sample_rate)
        return cls(face=face, background=sample_num - face,
                   mouth=mouth_rays, torso=torso_rays)


def _topk_coords(generator: torch.Generator, mask_flat: torch.Tensor, k: int,
                 W: int) -> torch.Tensor:
    """k coords drawn uniformly without replacement from mask_flat (H*W,);
    when the mask has fewer than k pixels the rest come uniformly from
    outside it."""
    u = torch.rand(mask_flat.shape, generator=generator,
                   device=mask_flat.device)
    score = torch.where(mask_flat, u + 2.0, u)
    idx = torch.topk(score, k).indices
    return torch.stack([idx // W, idx % W], dim=-1)


def sample_ray_coords(
    generator: torch.Generator,
    H: int,
    W: int,
    face_rect: torch.Tensor,   # (4,) [x, y, w, h]
    mouth_box: torch.Tensor,   # (4,) [min_x, max_x, min_y, max_y]
    torso_mask: torch.Tensor,  # (H, W) {0, 1}
    budget: RayBudget,
) -> torch.Tensor:
    """(budget.total, 2) int64 pixel coords [row, col] on the device of
    ``torso_mask``, order [face, background, mouth, torso]. ``generator``
    lives on that device."""
    dev = torso_mask.device
    rows = torch.arange(H, device=dev)[:, None].expand(H, W)
    cols = torch.arange(W, device=dev)[None, :].expand(H, W)
    mouth = ((cols >= mouth_box[0]) & (cols <= mouth_box[1])
             & (rows >= mouth_box[2]) & (rows <= mouth_box[3]))
    in_rect = ((cols >= face_rect[0]) & (cols <= face_rect[0] + face_rect[2])
               & (rows >= face_rect[1]) & (rows <= face_rect[1] + face_rect[3]))
    parts = []
    for mask, n in ((in_rect & ~mouth, budget.face),
                    (~in_rect, budget.background),
                    (mouth, budget.mouth),
                    (torso_mask.bool(), budget.torso)):
        if n > 0:
            parts.append(_topk_coords(generator, mask.reshape(-1), n, W))
    return torch.cat(parts, dim=0)


def rays_at_coords(coords: torch.Tensor, focal, c2w: torch.Tensor, cx, cy):
    """Ray origins and directions at the sampled pixels only.
    coords (N, 2) [row, col] -> (rays_o, rays_d), each (N, 3). The rotation
    is an explicit f32 multiply-add (no TF32 on any device), as the JAX
    package runs it at HIGHEST precision."""
    c2w = c2w.to(torch.float32)
    row = coords[:, 0].to(torch.float32)
    col = coords[:, 1].to(torch.float32)
    dirs = torch.stack([(col - cx) / focal, -(row - cy) / focal,
                        -torch.ones_like(col)], dim=-1)
    rot = c2w[:3, :3]
    rays_d = (dirs[:, 0:1] * rot[:, 0] + dirs[:, 1:2] * rot[:, 1]
              + dirs[:, 2:3] * rot[:, 2])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d
