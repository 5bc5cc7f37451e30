"""GRF-style point-to-image projection and feature gathering (counterpart
of models/projection.py).

Sample points project into a source view through the inverted
camera-to-world pose and the intrinsics; each gathers the feature map's
channels there plus its (row, col) as 2 more channels. Indices are
clamped into the image, as in the JAX package.
"""

from __future__ import annotations

import torch


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3|4, 4) camera-to-world -> (..., 3, 4) world-to-camera."""
    rot = pose[..., :3, :3]
    trans = pose[..., :3, 3:4]
    rot_t = rot.transpose(-1, -2)
    return torch.cat([rot_t, -rot_t @ trans], dim=-1)


def project_points(pts: torch.Tensor, pose: torch.Tensor,
                   intrinsic: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(N, 2) int32 [row, col] pixel indices of world points ``pts`` (N, 3)
    in the view ``pose`` with ``intrinsic`` [[f, 0, cx], [0, f, cy],
    [0, 0, 1]], clamped into the image: camera-frame points, perspective
    division by z, the intrinsic map, then the reference's flip to (y, x)
    and mirror."""
    ext = invert_pose(pose)
    hom = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
    cam = hom @ ext.T
    focal = intrinsic[0, 0]
    cam = focal / cam[:, 2:3] * cam
    pix = (cam @ intrinsic.T) / focal
    fin = torch.flip(pix, dims=(-1,))[:, 1:]            # (y, x)
    fin = (pix.new_tensor([0.0, W]) - fin) * pix.new_tensor([-1.0, 1.0])
    fin = torch.round(fin)
    fin = torch.minimum(torch.clamp(fin, min=0),
                        pix.new_tensor([H - 1, W - 1]))
    return fin.to(torch.int32)


def gather_image_features(pts: torch.Tensor, pose: torch.Tensor,
                          intrinsic: torch.Tensor, feature_map: torch.Tensor,
                          channels_first: bool = False) -> torch.Tensor:
    """(N, C + 2): the source view's features at each point's pixel, then
    that pixel's (row, col). ``feature_map`` is (H, W, C), or (C, H, W)
    with ``channels_first``."""
    if channels_first:
        feature_map = feature_map.permute(1, 2, 0)
    H, W = feature_map.shape[0], feature_map.shape[1]
    idx = project_points(pts, pose, intrinsic, H, W).long()
    feats = feature_map[idx[:, 0], idx[:, 1]]
    return torch.cat([feats, idx.to(feats.dtype)], dim=-1)
