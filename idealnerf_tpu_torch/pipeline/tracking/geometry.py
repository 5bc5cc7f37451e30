"""Tracking math (counterpart of pipeline/tracking/geometry.py; reference:
data_util/face_tracking/util.py, geo_transform.py): euler rotations,
rigid transforms, the tracker's perspective projection (note the sign:
proj_x = -f·X/Z + cx, util.py:60-69), landmark/Laplacian losses, triangle
normals."""

from __future__ import annotations

import numpy as np
import torch


def euler2rot(euler: torch.Tensor) -> torch.Tensor:
    """(B, 3) [theta, phi, psi] -> (B, 3, 3) = Rx(theta) Ry(phi) Rz(psi)
    with the reference's axis conventions (util.py:18-40)."""
    theta, phi, psi = euler[:, 0], euler[:, 1], euler[:, 2]
    one = torch.ones_like(theta)
    zero = torch.zeros_like(theta)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    cs, ss = torch.cos(psi), torch.sin(psi)
    rot_x = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, ct, -st], -1),
        torch.stack([zero, st, ct], -1),
    ], -2)
    rot_y = torch.stack([
        torch.stack([cp, zero, sp], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([-sp, zero, cp], -1),
    ], -2)
    rot_z = torch.stack([
        torch.stack([cs, ss, zero], -1),
        torch.stack([-ss, cs, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return rot_x @ rot_y @ rot_z


def euler2rot_np(euler: np.ndarray) -> np.ndarray:
    """``euler2rot`` in float32 on the host, numpy in and out."""
    return euler2rot(torch.as_tensor(np.asarray(euler, np.float32))).numpy()


def rot_trans_pts(geometry: torch.Tensor, rot: torch.Tensor,
                  trans: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (B, 3, 3), (B, 3) -> rotated+translated points
    (util.py:43-45)."""
    return torch.einsum("bij,bvj->bvi", rot, geometry) + trans[:, None, :]


def proj_pts(rott_geo: torch.Tensor, focal, cxy) -> torch.Tensor:
    """Perspective projection with the tracker's sign convention
    (util.py:60-69): x mirrored (-f·X/Z + cx), y direct (f·Y/Z + cy)."""
    X, Y, Z = rott_geo[..., 0], rott_geo[..., 1], rott_geo[..., 2]
    px = -focal * X / Z + cxy[0]
    py = focal * Y / Z + cxy[1]
    return torch.stack([px, py, Z], dim=-1)


def forward_transform(geometry, euler, trans, focal, cxy):
    rot = euler2rot(euler)
    return proj_pts(rot_trans_pts(geometry, rot, trans), focal, cxy)


def landmark_loss(proj_lan: torch.Tensor, gt_lan: torch.Tensor
                  ) -> torch.Tensor:
    """MSE over projected vs detected landmarks (util.py:84-85)."""
    return torch.mean((proj_lan - gt_lan) ** 2)


def lap_loss(series: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Temporal Laplacian smoothness: conv [-0.5, 1, -0.5] along the
    leading (time) axis (util.py:48-57). series (T, ...) -> scalar; zero
    below 3 frames, which have no interior point."""
    if series.shape[0] < 3:
        return series.new_zeros(())
    flat = series.reshape(series.shape[0], -1)
    lap = flat[1:-1] - 0.5 * flat[:-2] - 0.5 * flat[2:]
    return torch.mean(lap ** 2) * weight


def compute_tri_normal(geometry: torch.Tensor, tris) -> torch.Tensor:
    """(B, V, 3), (F, 3) -> (B, F, 3) unit triangle normals
    (util.py:6-15)."""
    tris = torch.as_tensor(tris, dtype=torch.long, device=geometry.device)
    v1 = geometry[:, tris[:, 0]]
    v2 = geometry[:, tris[:, 1]]
    v3 = geometry[:, tris[:, 2]]
    n = torch.linalg.cross(v2 - v1, v3 - v1, dim=-1)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
