"""Camera ray generation and pose math (counterpart of core/rays.py).

Pinhole camera with principal point (cx, cy): direction
``[(i-cx)/f, -(j-cy)/f, -1]`` rotated by the camera-to-world rotation.
"""

from __future__ import annotations

import torch


def get_rays(H: int, W: int, focal, c2w: torch.Tensor, cx=None, cy=None):
    """Per-pixel (rays_o, rays_d), each (H, W, 3), for a (3, 4) pose.

    The rotation is an explicit float32 multiply-add over the three
    columns: it is camera geometry, and a reduced-precision product here
    would bend the rays.
    """
    if cx is None:
        cx = W * 0.5
    if cy is None:
        cy = H * 0.5
    c2w = c2w.to(torch.float32)
    dev = c2w.device
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - cx) / focal, -(j - cy) / focal, -torch.ones_like(i)], dim=-1
    )
    rot = c2w[:3, :3]
    rays_d = (dirs[..., 0:1] * rot[:, 0] + dirs[..., 1:2] * rot[:, 1]
              + dirs[..., 2:3] * rot[:, 2])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal, near, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """(rays_o, rays_d) of shape (..., 3) -> the same rays in normalised
    device coordinates: each origin moved onto the plane z = -near, then
    x and y scaled by the half-extent of the image and z mapped as 1 +
    2 near / z (the forward-facing NDC of helper.py:246-265). No render
    path calls it: face data renders in world space."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ax, ay = -1.0 / (W / (2.0 * focal)), -1.0 / (H / (2.0 * focal))
    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    o = torch.stack([ax * ox / oz, ay * oy / oz, 1.0 + 2.0 * near / oz], -1)
    d = torch.stack([ax * (rays_d[..., 0] / rays_d[..., 2] - ox / oz),
                     ay * (rays_d[..., 1] / rays_d[..., 2] - oy / oz),
                     -2.0 * near / oz], -1)
    return o, d


def pose_to_euler_trans(poses: torch.Tensor) -> torch.Tensor:
    """(B, 3|4, 4) poses -> (B, 6) [euler (3), translation (3)]: the
    tracker's euler extraction, atan2(R22, R12), asin(-R02), atan2(R00,
    -R01); the torso field's pose conditioning (train/torso.py)."""
    R = poses[:, :3, :3]
    e2 = torch.atan2(R[:, 0, 0], -R[:, 0, 1])
    e1 = torch.asin(-R[:, 0, 2])
    e0 = torch.atan2(R[:, 2, 2], R[:, 1, 2])
    return torch.cat([torch.stack([e0, e1, e2], dim=1), poses[:, :3, 3]],
                     dim=1)
