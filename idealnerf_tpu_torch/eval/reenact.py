"""Cross-subject reenactment (counterpart of eval/reenact.py, its
per-frame and temporal branches).

The identity (poses, background plate, latent) comes from subject A's
dataset, the driving expressions from subject B's transforms json and the
driving audio from a window track; audio features for the whole track are
computed in one batched pass. Each frame is the head field alone or the
head + torso composite, written to an MJPG .avi by eval/video.py: one
full-fidelity frame at a time (``make_frame_renderer``,
``make_composite_frame_renderer``), the per-frame fast modes with
``fast_keep`` (``make_pruned_frame_renderer``,
``make_composite_fast_renderer``), or with ``temporal = R`` the temporal
depth-cache renderers (a keyframe every R frames, delta frames in
between); ``bounds`` tightens the sampling interval. With a ``mesh``
(``parallel.mesh.Mesh``) the full-fidelity frames are ray-sharded over
its ranks, and batched over its 'data' axis where that is > 1.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Optional

import numpy as np
import torch

from idealnerf_tpu_torch.eval.renderer import (
    foreground_prior, foreground_prior_fields, make_composite_fast_renderer,
    make_composite_frame_renderer, make_frame_renderer,
    make_pruned_frame_renderer,
)
from idealnerf_tpu_torch.eval.temporal import (
    check_roll_k, make_temporal_composite_renderer,
    make_temporal_frame_renderer,
)
from idealnerf_tpu_torch.eval.video import VideoWriter
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.torso import torso_nerf_config, torso_signal

logger = logging.getLogger("idealnerf.eval")

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


def check_mesh_modes(mesh, fast_keep=None, temporal=None) -> None:
    """The JAX reenact's refusals of a mesh: its sharded renders are the
    full-fidelity ones (the fast modes select rays on the host, the
    temporal modes keep their own keyframe/delta schedule)."""
    if mesh is not None and fast_keep is not None:
        raise ValueError("mesh sharding requires full fidelity "
                         "(fast_keep=None)")
    if temporal is not None and (mesh is not None or fast_keep is not None):
        raise ValueError("temporal mode is incompatible with mesh "
                         "sharding and fast_keep (it has its own "
                         "keyframe/delta schedule)")


def reenact(cfg, head_params, identity, driving_auds: np.ndarray,
            driving_exprs: Optional[np.ndarray] = None,
            latent_codes: Optional[torch.Tensor] = None,
            torso_params=None, out_path: Optional[str] = None,
            max_frames: Optional[int] = None, smooth_audio: bool = True,
            frame_times: Optional[list] = None,
            temporal: Optional[int] = None, s_delta: int = 32,
            delta_keep: float = 1.0,
            delta_keep_torso: Optional[float] = None,
            s_delta_torso: Optional[int] = None, uni_frac: float = 0.25,
            kf_blend: float = 0.0, freeze_z_torso: bool = False,
            dilate_every: int = 1, roll_k: int = 0, roll_k_torso: int = 0,
            cycle: bool = False, head_parse: bool = False,
            fast_keep=None, use_prior: bool = False, bounds=None,
            mesh=None) -> np.ndarray:
    """Render the reenactment on the device of ``head_params`` -> the
    frames (N, H, W, 3) in [0, 1]; with ``out_path`` also the .avi there
    (every 10th frame also as ``<stem>_<i:05d>.jpg``). Identity poses
    cycle through subject A's frames; the expression index follows the
    driving sequence, clamped at its end. With ``torso_params`` each frame
    is the composite, the torso rays cast from the identity's first pose.

    ``fast_keep``: the pruned fast renderers (the fine pass on that
    fraction of rays by coarse foreground opacity; the composite also
    skips head work the torso hides). ``use_prior`` restricts the fast
    and temporal renderers to the identity's foreground prior (per field
    for the composite). ``bounds``: the sampling interval, a tuple
    ``(near, far)`` for head-only renders, a dict ``{"head": (n, f),
    "torso": (n, f)}`` for the composite fast and temporal renderers.

    ``temporal = R``: the temporal renderers, a keyframe every R frames
    (only frame 0 under ``roll_k``), with the delta-frame knobs of
    eval/temporal.py. ``cycle`` is the JAX reenact's option to scan each
    keyframe cycle's delta frames in one dispatch; it is checked as
    there, but on the card the per-frame loop renders the same frames
    (``render.cycle`` is that loop), so every frame runs through it.
    ``frame_times`` gets each frame's own wall seconds, the host fetch
    included.

    ``mesh``: the full-fidelity frames (head-only and composite) render
    with each frame's rays split over the mesh's 'ray' ranks
    (``parallel.sharded``), and where its 'data' axis is > 1 that many
    frames a batch, the last batch padded by repetition and trimmed
    (``frame_times`` then gets each batch's wall seconds spread over its
    frames). Every rank returns the frames; only rank 0 writes
    ``out_path``. Refused with ``fast_keep`` or ``temporal``
    (``check_mesh_modes``)."""
    check_mesh_modes(mesh, fast_keep, temporal)
    if temporal is not None:
        if temporal < 1:
            raise ValueError("temporal must be >= 1 (keyframe interval)")
        roll_k = check_roll_k("roll_k", roll_k)
        roll_k_torso = check_roll_k("roll_k_torso", roll_k_torso)
        if roll_k_torso and cycle:
            raise ValueError("roll_k_torso (torso refresh roll) has no "
                             "delta-frame cycle; drop cycle=True")
        if roll_k and cycle:
            raise ValueError("roll_k (rolling keyframe refresh) has no "
                             "delta-frame cycle; drop cycle=True")
        if roll_k and roll_k_torso:
            raise ValueError("roll_k and roll_k_torso are exclusive")
    if use_prior and fast_keep is None and temporal is None:
        raise ValueError("use_prior requires fast_keep or temporal (the "
                         "prior mask only applies to the fast renderers)")
    if (bounds is not None and torso_params is not None
            and not isinstance(bounds, dict)):
        raise ValueError(
            "composite bounds tightening needs per-field bands: pass "
            "bounds=dict(head=(n,f), torso=(n,f)) (subject_depth_range "
            "+ torso_depth_range) with fast_keep")
    if isinstance(bounds, dict) and fast_keep is None and temporal is None:
        raise ValueError("per-field bounds apply to the composite FAST/"
                         "temporal paths (fast_keep or temporal "
                         "required); the full-fidelity composite stays "
                         "at reference bounds")
    if isinstance(bounds, dict) and torso_params is None:
        raise ValueError("per-field bounds dict is for the composite; "
                         "head-only renders take bounds=(near, far)")
    device = next(head_params.parameters()).device
    H, W = identity.hw
    n_frames = driving_auds.shape[0] if max_frames is None else min(
        max_frames, driving_auds.shape[0])
    head_cfg = variant_nerf_config(cfg)
    render_cfg = cfg.render_config()
    near, far = identity.near, identity.far
    if bounds is not None and not isinstance(bounds, dict):
        near, far = bounds
    view = (H, W, identity.focal, near, far, render_cfg)
    where = dict(cx=identity.cx, cy=identity.cy)
    knobs = dict(s_delta=s_delta, uni_frac=uni_frac, kf_blend=kf_blend,
                 dilate_every=dilate_every, roll_k=roll_k)
    mask = k_coarse = None
    if use_prior:
        mask, k_coarse = foreground_prior(identity, head_parse=head_parse)
        logger.info("subject prior: %.1f%% coverage, k_coarse %d",
                    100.0 * float(mask.mean()), k_coarse)
    pf = {}
    if torso_params is not None and use_prior:
        mh, mt = foreground_prior_fields(identity, head_parse=head_parse)
        pf = dict(prior_mask_head=mh, prior_mask_torso=mt)
        logger.info("per-field priors: head %.1f%%, torso %.1f%%",
                    100.0 * float(mh.mean()), 100.0 * float(mt.mean()))
    if isinstance(bounds, dict):
        pf.update(bounds_head=bounds.get("head"),
                  bounds_torso=bounds.get("torso"))
    render_video = None
    if mesh is not None:
        from idealnerf_tpu_torch.parallel import sharded

        if not mesh.is_main:
            out_path = None
        tile = min(8192, H * W)
        tile -= tile % mesh.n_ray
        on = dict(**where, tile=tile)
        if torso_params is None:
            if mesh.n_data > 1:
                render_video = sharded.make_sharded_video_renderer(
                    head_cfg, mesh, *view, **on)
            else:
                render = sharded.make_sharded_frame_renderer(
                    head_cfg, mesh, *view, **on)
        elif mesh.n_data > 1:
            render_video = sharded.make_sharded_composite_video_renderer(
                head_cfg, torso_nerf_config(cfg), mesh, *view, **on)
        else:
            render = sharded.make_sharded_composite_renderer(
                head_cfg, torso_nerf_config(cfg), mesh, *view, **on)
    elif torso_params is None:
        if temporal is not None:
            render = make_temporal_frame_renderer(
                head_cfg, *view, **where, prior_mask=mask,
                delta_keep=delta_keep, **knobs)
        elif fast_keep is not None:
            render = make_pruned_frame_renderer(
                head_cfg, *view, **where, keep_fraction=fast_keep,
                prior_mask=mask, k_coarse=k_coarse)
        else:
            render = make_frame_renderer(head_cfg, *view, **where)
    elif temporal is not None:
        render = make_temporal_composite_renderer(
            head_cfg, torso_nerf_config(cfg), *view, **where,
            delta_keep_head=delta_keep,
            delta_keep_torso=(delta_keep if delta_keep_torso is None
                              else delta_keep_torso),
            s_delta_torso=s_delta_torso, freeze_z_torso=freeze_z_torso,
            roll_k_torso=roll_k_torso, **pf, **knobs)
    elif fast_keep is not None:
        render = make_composite_fast_renderer(
            head_cfg, torso_nerf_config(cfg), *view, **where,
            prior_mask=mask, k_coarse=k_coarse, keep_head=fast_keep,
            keep_torso=fast_keep, **pf)
    else:
        render = make_composite_frame_renderer(
            head_cfg, torso_nerf_config(cfg), *view, **where)

    aud_feats = smoothed_audio_features(
        head_params, torch.from_numpy(np.asarray(driving_auds, np.float32))
        .to(device), cfg, smooth=smooth_audio)
    bc = torch.from_numpy(identity.bc_img).to(device).float() / 255.0
    poses = torch.from_numpy(identity.poses).to(device)
    latent = latent_codes[0].to(device) if latent_codes is not None else None

    def cond_at(i):
        expr = None
        if driving_exprs is not None and cfg.dim_expr > 0:
            expr = torch.from_numpy(np.asarray(
                driving_exprs[min(i, driving_exprs.shape[0] - 1)],
                np.float32)).to(device)
        return variant_conditioning(head_params, cfg, aud_feats[i], expr)

    frames = []
    cache = None
    with (VideoWriter(out_path) if out_path
          else contextlib.nullcontext()) as writer:
        if render_video is not None:
            B = mesh.n_data
            for start in range(0, n_frames, B):
                t0 = time.perf_counter()
                idxs = [min(start + j, n_frames - 1) for j in range(B)]
                ps = poses[[i % identity.size for i in idxs]]
                conds = [cond_at(i) for i in idxs]
                cond = [None if c[0] is None else torch.stack(c)
                        for c in zip(*conds)]
                lat = None if latent is None else latent.expand(B, -1)
                if torso_params is None:
                    batch = render_video(head_params, ps, bc, cond[0],
                                         cond[1], lat)
                else:
                    sigs = torch.stack([
                        torso_signal(aud_feats[i], ps[j], cfg.dim_aud_body)
                        for j, i in enumerate(idxs)])
                    batch = render_video(head_params, torso_params, ps,
                                         poses[0], bc, cond[0], sigs,
                                         cond[1], lat)
                batch = batch.clamp(0.0, 1.0).cpu().numpy()
                n_out = min(B, n_frames - start)
                if frame_times is not None:
                    per = (time.perf_counter() - t0) / n_out
                    frame_times.extend([per] * n_out)
                for j in range(n_out):
                    frames.append(batch[j])
                    if writer is not None:
                        writer.add(batch[j])
            return np.stack(frames)
        for i in range(n_frames):
            t0 = time.perf_counter()
            pose = poses[i % identity.size]
            aud = aud_feats[i]
            aud_arg, expr_arg = cond_at(i)
            if torso_params is None:
                args = (head_params, pose, bc)
                kw = dict(aud=aud_arg, expr=expr_arg, latent=latent)
            else:
                args = (head_params, torso_params, pose, poses[0], bc)
                kw = dict(aud=aud_arg,
                          signal=torso_signal(aud, pose, cfg.dim_aud_body),
                          expr=expr_arg, latent=latent)
            if temporal is None:
                frame = render(*args, **kw)
            else:
                # a keyframe every `temporal` frames; a rolling cache
                # lives on
                if i % temporal == 0 and not roll_k:
                    cache = None
                frame, cache = render(*args, **kw, cache=cache)
            frame = frame.clamp(0.0, 1.0).cpu().numpy()
            if frame_times is not None:
                frame_times.append(time.perf_counter() - t0)
            frames.append(frame)
            if writer is not None:
                writer.add(frame)
            if i % 25 == 0:
                logger.info("reenact frame %d/%d", i, n_frames)
    return np.stack(frames)
