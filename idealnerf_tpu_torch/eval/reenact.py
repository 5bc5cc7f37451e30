"""Cross-subject reenactment, one full-fidelity frame at a time
(counterpart of eval/reenact.py, its per-frame branches).

The identity (poses, background plate, latent) comes from subject A's
dataset, the driving expressions from subject B's transforms json and the
driving audio from a window track; audio features for the whole track are
computed in one batched pass. Each frame is the head field alone
(``make_frame_renderer``) or the head + torso composite
(``make_composite_frame_renderer``), written as PNGs by eval/video.py.

Not ported yet: the temporal modes (``temporal``, ROADMAP.md A7b), the
fast modes (``fast_keep``, ``use_prior``, ``bounds``, A9) and multi-device
rendering (``mesh``, A13).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import numpy as np
import torch

from idealnerf_tpu_torch.eval.renderer import (
    make_composite_frame_renderer, make_frame_renderer,
)
from idealnerf_tpu_torch.eval.video import FrameWriter
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.torso import torso_nerf_config, torso_signal

logger = logging.getLogger("idealnerf.eval")

# modes of the JAX reenact that the port does not have yet
_NOT_PORTED = {
    "temporal": "A7b (temporal composite video)",
    "fast_keep": "A9 (per-frame fast modes)",
    "use_prior": "A9 (per-frame fast modes)",
    "bounds": "A9 (per-frame fast modes)",
    "mesh": "A13 (multi-device)",
}


def load_driving_exprs(transforms_json_path: str) -> np.ndarray:
    """(N, dim_expr) expressions of another subject's transforms json."""
    with open(transforms_json_path) as fh:
        meta = json.load(fh)
    return np.stack([np.array(f["exp"], np.float32) for f in meta["frames"]])


@torch.no_grad()
def smoothed_audio_features(params, auds: torch.Tensor, cfg,
                            smooth: bool = True) -> torch.Tensor:
    """(M, dim_aud) AudioNet features of the (M, 16, 29) driving windows,
    each smoothed by AudioAttNet over the smo_size track frames around it
    (zeros past either end), all frames in one batch."""
    feats = params["aud_net"](auds)
    if not smooth:
        return feats
    m = feats.shape[0]
    idx = (torch.arange(m, device=feats.device)[:, None] - cfg.smo_size // 2
           + torch.arange(cfg.smo_size, device=feats.device)[None])
    valid = (idx >= 0) & (idx < m)
    windows = feats[idx.clamp(0, m - 1)] * valid[..., None]
    return params["aud_att"](windows)


def reenact(cfg, head_params, identity, driving_auds: np.ndarray,
            driving_exprs: Optional[np.ndarray] = None,
            latent_codes: Optional[torch.Tensor] = None,
            torso_params=None, out_path: Optional[str] = None,
            max_frames: Optional[int] = None, smooth_audio: bool = True,
            frame_times: Optional[list] = None, temporal=None,
            fast_keep=None, use_prior: bool = False, bounds=None,
            mesh=None) -> np.ndarray:
    """Render the reenactment on the device of ``head_params`` -> the
    frames (N, H, W, 3) in [0, 1]; with ``out_path`` also PNGs
    ``{out_path}_{i:05d}.png``. Identity poses cycle through subject A's
    frames; the expression index follows the driving sequence, clamped at
    its end. With ``torso_params`` each frame is the composite, the torso
    rays cast from the identity's first pose. ``frame_times`` gets each
    frame's wall seconds, the host fetch included."""
    given = dict(temporal=temporal, fast_keep=fast_keep, use_prior=use_prior,
                 bounds=bounds, mesh=mesh)
    for name, item in _NOT_PORTED.items():
        if given[name] not in (None, False):
            raise NotImplementedError(
                f"reenact {name} is not ported yet (ROADMAP.md {item})")
    device = next(head_params.parameters()).device
    H, W = identity.hw
    n_frames = driving_auds.shape[0] if max_frames is None else min(
        max_frames, driving_auds.shape[0])
    head_cfg = variant_nerf_config(cfg)
    render_cfg = cfg.render_config()
    view = (identity.focal, identity.near, identity.far, render_cfg)
    if torso_params is None:
        render = make_frame_renderer(head_cfg, H, W, *view, cx=identity.cx,
                                     cy=identity.cy)
    else:
        render = make_composite_frame_renderer(
            head_cfg, torso_nerf_config(cfg), H, W, *view, cx=identity.cx,
            cy=identity.cy)

    aud_feats = smoothed_audio_features(
        head_params, torch.from_numpy(np.asarray(driving_auds, np.float32))
        .to(device), cfg, smooth=smooth_audio)
    bc = torch.from_numpy(identity.bc_img).to(device).float() / 255.0
    poses = torch.from_numpy(identity.poses).to(device)
    latent = latent_codes[0].to(device) if latent_codes is not None else None
    writer = FrameWriter(out_path) if out_path else None
    frames = []
    for i in range(n_frames):
        t0 = time.perf_counter()
        pose = poses[i % identity.size]
        expr = None
        if driving_exprs is not None and cfg.dim_expr > 0:
            expr = torch.from_numpy(np.asarray(
                driving_exprs[min(i, driving_exprs.shape[0] - 1)],
                np.float32)).to(device)
        aud = aud_feats[i]
        aud_arg, expr_arg = variant_conditioning(head_params, cfg, aud, expr)
        if torso_params is None:
            frame = render(head_params, pose, bc, aud=aud_arg, expr=expr_arg,
                           latent=latent)
        else:
            frame = render(head_params, torso_params, pose, poses[0], bc,
                           aud=aud_arg,
                           signal=torso_signal(aud, pose, cfg.dim_aud_body),
                           expr=expr_arg, latent=latent)
        frame = frame.clamp(0.0, 1.0).cpu().numpy()
        if frame_times is not None:
            frame_times.append(time.perf_counter() - t0)
        frames.append(frame)
        if writer is not None:
            writer.add(frame)
        if i % 25 == 0:
            logger.info("reenact frame %d/%d", i, n_frames)
    return np.stack(frames)
