"""Procedural synthetic dataset: an analytically ray-traced "talking
sphere" with audio-driven mouth darkening over a gradient background plate.

The reference ships no test data and no test suite (SURVEY.md §4); this
gives every trainer/eval path a geometry-consistent multi-view dataset that
a NeRF can actually fit, generated on CPU in milliseconds. Camera poses
orbit the head slightly; the "mouth" patch on the sphere darkens with a
scalar derived from the frame's DeepSpeech-shaped audio window, and an
"expression" coefficient modulates the sphere's hue — so audio/expr
conditioning is learnable, not just shape-checked.

Numpy only, a copy of idealnerf_tpu/data/synthetic.py: the same arguments
give byte-identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from idealnerf_tpu_torch.data.dataset import FrameDataset


def _camera_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w looking at the origin from spherical angle (theta, phi)."""
    eye = radius * np.array(
        [np.sin(theta) * np.cos(phi), np.sin(phi), np.cos(theta) * np.cos(phi)],
        np.float32,
    )
    forward = -eye / np.linalg.norm(eye)          # camera -z looks at origin
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    # columns: x=right, y=true_up, z=-forward  (OpenGL-style, -z forward)
    R = np.stack([right, true_up, -forward], axis=1)
    return np.concatenate([R, eye[:, None]], axis=1).astype(np.float32)


def make_synthetic_dataset(
    n_frames: int = 20,
    H: int = 64,
    W: int = 64,
    dim_expr: int = 8,
    seed: int = 0,
    sphere_radius: float = 0.35,
    cam_radius: float = 1.5,
    with_torso: bool = False,
    motion_scale: float = 1.0,
) -> FrameDataset:
    """``with_torso=False`` -> head-only frames (the reference's
    head_imgs); ``with_torso=True`` -> composite frames (com_imgs) with an
    image-space-static, audio-modulated torso band over the bottom — the
    geometry torso rays see when cast from the fixed first-frame pose
    (run_nerf.py:499). Same seed gives identical poses/audio/exprs in both
    variants, so a head model trained on one drives the other."""
    rng = np.random.RandomState(seed)
    focal = 1.2 * max(H, W)
    cx, cy = W / 2.0, H / 2.0

    auds = rng.randn(n_frames, 16, 29).astype(np.float32) * 0.5
    # the learnable audio signal: mean of the center frame, squashed
    aud_scalar = np.tanh(auds[:, 8, :].mean(-1) * 4.0)
    exprs = rng.randn(n_frames, dim_expr).astype(np.float32)
    expr_scalar = np.tanh(exprs[:, 0])

    # background plate: smooth gradient
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    bc = np.stack(
        [0.6 + 0.3 * xx / W, 0.3 + 0.3 * yy / H, 0.7 - 0.3 * xx / W], axis=-1
    )
    bc_img = (np.clip(bc, 0, 1) * 255).astype(np.uint8)

    images, poses, rects, mouth_boxes, torso_masks = [], [], [], [], []
    landmarks = []
    for f in range(n_frames):
        # motion_scale varies the head-pose swing amplitude — a second
        # independent subject (different geometry/motion, round-4
        # verdict #4) stresses the temporal depth cache harder/softer
        theta = motion_scale * 0.25 * np.sin(2 * np.pi * f / max(n_frames, 1))
        phi = motion_scale * 0.12 * np.cos(2 * np.pi * f / max(n_frames, 1))
        c2w = _camera_pose(theta, phi, cam_radius)
        poses.append(c2w)

        # ray-trace the sphere (camera convention == core.rays.get_rays)
        i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32), indexing="xy")
        dirs = np.stack([(i - cx) / focal, -(j - cy) / focal, -np.ones_like(i)], -1)
        rd = dirs @ c2w[:3, :3].T
        ro = c2w[:3, 3]
        b = 2.0 * (rd @ ro)
        c = float(ro @ ro) - sphere_radius**2
        disc = b * b - 4.0 * (rd * rd).sum(-1) * c
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * (rd * rd).sum(-1) + 1e-9), 0.0)
        p = ro + rd * t[..., None]                 # surface points
        normal = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-9)

        shade = 0.5 + 0.5 * np.clip(normal[..., 2], 0, 1)
        hue = 0.5 + 0.3 * expr_scalar[f]
        col = np.stack([hue * shade, 0.8 * shade, (1.0 - 0.4 * hue) * shade], -1)

        # mouth: patch on the lower front of the sphere, darkened by audio
        mouth_region = (normal[..., 1] < -0.25) & (normal[..., 2] > 0.55)
        openness = 0.5 + 0.45 * aud_scalar[f]
        col[mouth_region] *= (1.0 - 0.8 * openness)

        img = np.where(hit[..., None], col, bc)
        if with_torso:
            # image-space-static trapezoid band, shade driven by audio
            band = yy >= 0.82 * H
            taper = np.abs(xx - W / 2) < (0.18 + 0.35 * (yy / H - 0.82)) * W
            torso_px = band & taper
            t_col = np.array([0.25, 0.2, 0.35]) * (1.0 + 0.25 * aud_scalar[f])
            img[torso_px] = np.clip(t_col, 0, 1)
        images.append((np.clip(img, 0, 1) * 255).astype(np.uint8))

        # face rect = sphere bbox in pixels (+margin)
        ys, xs = np.nonzero(hit)
        if len(xs) == 0:
            rects.append(np.array([0, 0, W - 1, H - 1], np.int32))
            mouth_boxes.append(np.array([0, W - 1, 0, H - 1], np.float32))
        else:
            x0, x1 = max(int(xs.min()) - 2, 0), min(int(xs.max()) + 2, W - 1)
            y0, y1 = max(int(ys.min()) - 2, 0), min(int(ys.max()) + 2, H - 1)
            rects.append(np.array([x0, y0, x1 - x0, y1 - y0], np.int32))
            mys, mxs = np.nonzero(mouth_region & hit)
            if len(mxs) == 0:
                mouth_boxes.append(np.array([x0, x1, y0, y1], np.float32))
            else:
                mouth_boxes.append(
                    np.array([mxs.min(), mxs.max(), mys.min(), mys.max()], np.float32)
                )
        torso = np.zeros((H, W), np.uint8)
        torso[int(0.85 * H):, :] = 1               # bottom band stands in for torso
        torso_masks.append(torso)

        # 68 synthetic landmarks, (x, y) as in .lms files: 48 evenly
        # spaced over the sphere's visible pixels + 20 "mouth" points, so
        # lms[48:] is consistent with the mouth box derivation
        if len(xs) >= 48:
            idx = np.linspace(0, len(xs) - 1, 48).astype(int)
            face_pts = np.stack([xs[idx], ys[idx]], -1)
        else:
            face_pts = np.tile([[cx, cy]], (48, 1))
        mys, mxs = np.nonzero(mouth_region & hit)
        if len(mxs) >= 20:
            midx = np.linspace(0, len(mxs) - 1, 20).astype(int)
            mouth_pts = np.stack([mxs[midx], mys[midx]], -1)
        else:
            mouth_pts = np.tile([[cx, cy]], (20, 1))
        landmarks.append(
            np.concatenate([face_pts, mouth_pts], 0).astype(np.float32)
        )

    return FrameDataset(
        images=np.stack(images),
        poses=np.stack(poses),
        auds=auds,
        aud_ids=np.arange(n_frames, dtype=np.int32),
        exprs=exprs,
        face_rects=np.stack(rects),
        mouth_boxes=np.stack(mouth_boxes),
        landmarks=np.stack(landmarks),
        torso_masks=np.stack(torso_masks),
        bc_img=bc_img,
        focal=focal,
        cx=cx,
        cy=cy,
        near=cam_radius - 2.5 * sphere_radius,
        far=cam_radius + 2.5 * sphere_radius,
    )
