"""Real-time streaming serving over the temporal depth-cache renderers,
head only or head + torso (counterpart of eval/stream.py).

DeepSpeech audio windows (and optionally expressions and poses) are
pushed as they arrive and frames come back in arrival order. Frame ``i``
is a keyframe when ``i % refresh == 0`` and a delta frame otherwise (with
``roll_k``, only frame 0 is a keyframe). The reference's centred
AudioAttNet smoothing needs ``smo_size - smo_size // 2 - 1`` future audio
features, so a smoothed stream emits frame ``i`` after push ``i + 3`` (at
smo_size 8); ``smooth_audio=False`` serves with no lookahead.

Serving zeroes AudioNet *features* outside the track before AudioAttNet,
as the JAX stream and its offline twin do; the trainer's
``compute_aud_feature`` zeroes the raw windows instead, and AudioNet(0)
is not 0, so the stream computes its own features.

    stream = TemporalStream(cfg, params, identity, latent_codes=latents)
    stream.warmup()
    for aud_win, expr in live_inputs:          # 25 Hz
        frame = stream.push(aud_win, expr=expr)
        if frame is not None:
            emit(frame)
    for frame in stream.flush():               # drain the lookahead
        emit(frame)

With ``torso_params`` each frame is the temporal composite: the torso
field renders from the identity's first pose, conditioned on the torso
signal of the frame's smoothed audio feature and pose.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from idealnerf_tpu_torch.eval.renderer import (
    foreground_prior, foreground_prior_fields,
)
from idealnerf_tpu_torch.eval.temporal import (
    check_roll_k, make_temporal_composite_renderer,
    make_temporal_frame_renderer,
)
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.torso import torso_nerf_config, torso_signal


class TemporalStream:
    """Stateful frame server: ``push(aud_window) -> frame | None``.

    ``head_params`` is the parameter ModuleDict (coarse, fine, aud_net,
    aud_att); frames render on its device. ``torso_params`` (coarse, fine
    torso nets) makes every frame the head + torso composite; the
    ``*_torso`` arguments then set the torso field's delta samples, keep
    fraction (default ``delta_keep``), frozen depth grid and refresh-only
    roll, ``use_prior`` gives each field its own prior and ``bounds`` may
    be a dict ``{"head": (near, far), "torso": (near, far)}``.
    ``operating_point``: a dict in the JAX package's ``gated_video_config``
    shape whose keys override the keyword arguments (the torso's keys have
    no effect on a head-only stream). Identity poses and expressions cycle
    through the subject's frames unless ``push`` supplies them.

    ``frame_times`` holds each emitted frame's wall seconds and
    ``frame_kinds`` whether it was a "keyframe" or a "delta" frame."""

    def __init__(
        self,
        cfg,
        head_params,
        identity,
        torso_params=None,
        latent_codes: Optional[torch.Tensor] = None,
        operating_point: Optional[Dict[str, Any]] = None,
        refresh: int = 25,
        s_delta: int = 16,
        s_delta_torso: Optional[int] = None,
        delta_keep: float = 1.0,
        delta_keep_torso: Optional[float] = None,
        freeze_z_torso: bool = False,
        uni_frac: float = 0.25,
        kf_blend: float = 0.0,
        dilate_every: int = 1,
        roll_k: int = 0,
        roll_k_torso: int = 0,
        use_prior: bool = False,
        head_parse: bool = False,
        bounds=None,
        smooth_audio: bool = True,
    ):
        op = operating_point or {}
        if op and not op.get("quality_ok", True):
            raise ValueError(
                "operating_point's quality gate is closed — measure the "
                "subject's delta-frame quality first")
        self.refresh = int(op.get("refresh", refresh))
        if self.refresh < 1:
            raise ValueError("refresh must be >= 1")
        s_delta = int(op.get("s_delta", s_delta))
        s_delta_torso = op.get("s_delta_torso", s_delta_torso)
        delta_keep = float(op.get("delta_keep", delta_keep))
        delta_keep_torso = op.get("delta_keep_torso", delta_keep_torso)
        freeze_z_torso = bool(op.get("freeze_z_torso", freeze_z_torso))
        uni_frac = float(op.get("uni_frac", uni_frac))
        kf_blend = float(op.get("kf_blend", kf_blend))
        dilate_every = int(op.get("dilate_every", dilate_every))
        self.roll_k = check_roll_k("roll_k", op.get("roll_k", roll_k))
        # torso refresh-only roll: the head keeps the keyframe cadence
        self.roll_k_torso = check_roll_k(
            "roll_k_torso", op.get("roll_k_torso", roll_k_torso))
        head_parse = bool(op.get("head_parse", head_parse))
        composite = torso_params is not None
        if isinstance(bounds, dict) and not composite:
            raise ValueError("per-field bounds dict is for the composite "
                             "stream")
        if composite and bounds is not None and not isinstance(bounds, dict):
            raise ValueError("the composite stream takes per-field bounds: "
                             "{'head': (near, far), 'torso': (near, far)}")

        self.cfg = cfg
        self.identity = identity
        self.head_params = head_params
        self.torso_params = torso_params
        self.device = next(head_params.parameters()).device
        self.latent = (latent_codes[0].to(self.device)
                       if latent_codes is not None else None)
        self.smooth = bool(smooth_audio)
        # centred window [i - smo//2, i - smo//2 + smo): future frames
        # needed before frame i's feature window is complete
        self.lookahead = (cfg.smo_size - cfg.smo_size // 2 - 1
                          if self.smooth else 0)
        self.frame_times: List[float] = []
        self.frame_kinds: List[str] = []

        H, W = identity.hw
        self._bc = (torch.from_numpy(np.asarray(identity.bc_img))
                    .to(self.device).float() / 255.0)
        self._pose0 = self._tensor(identity.poses[0])
        view = (H, W, identity.focal, identity.near, identity.far,
                cfg.render_config())
        common = dict(cx=identity.cx, cy=identity.cy, s_delta=s_delta,
                      uni_frac=uni_frac, kf_blend=kf_blend,
                      dilate_every=dilate_every, roll_k=self.roll_k)
        if not composite:
            prior_mask = (foreground_prior(identity, head_parse=head_parse)[0]
                          if use_prior else None)
            self._render = make_temporal_frame_renderer(
                variant_nerf_config(cfg), *view, prior_mask=prior_mask,
                bounds=bounds, delta_keep=delta_keep, **common)
        else:
            pf = {}
            if use_prior:
                pf = dict(zip(("prior_mask_head", "prior_mask_torso"),
                              foreground_prior_fields(
                                  identity, head_parse=head_parse)))
            if bounds is not None:
                pf.update(bounds_head=bounds.get("head"),
                          bounds_torso=bounds.get("torso"))
            self._render = make_temporal_composite_renderer(
                variant_nerf_config(cfg), torso_nerf_config(cfg), *view,
                s_delta_torso=s_delta_torso, delta_keep_head=delta_keep,
                delta_keep_torso=(delta_keep if delta_keep_torso is None
                                  else float(delta_keep_torso)),
                freeze_z_torso=freeze_z_torso,
                roll_k_torso=self.roll_k_torso, **pf, **common)

        # rolling raw-feature history: features of pushed frames
        # [n_pushed - len(hist), n_pushed); smo//2 past ones suffice
        self._hist = deque(maxlen=cfg.smo_size)
        self._hist_start = 0          # pushed-frame index of _hist[0]
        self._pending = deque()       # (expr, pose) per pushed frame
        self._n_pushed = 0
        self._out_i = 0               # next frame index to emit
        self._cache = None
        self._closed = False

    @property
    def algorithmic_latency_frames(self) -> int:
        """Lookahead frames before the first emission (0 unsmoothed)."""
        return self.lookahead

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @torch.no_grad()
    def _feat(self, aud_window) -> torch.Tensor:
        return self.head_params["aud_net"](self._tensor(aud_window)[None])[0]

    @torch.no_grad()
    def _att(self, win: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # zero features outside the track, as the offline smoothing does
        return self.head_params["aud_att"](
            torch.where(valid[:, None], win, torch.zeros_like(win)))

    def warmup(self) -> float:
        """Run every path the serving loop will take — keyframe, first
        delta frame (keyframe-wide cache), steady delta frame — and the
        audio networks on dummy inputs, without touching stream state,
        so the first live pushes pay no one-off set-up (kernel build and
        load, allocator growth). Returns the wall seconds spent."""
        t0 = time.perf_counter()
        feat = self._feat(np.zeros((self.cfg.win_size, 29), np.float32))
        smo = self.cfg.smo_size
        feat = self._att(feat[None].expand(smo, -1),
                         torch.ones(smo, dtype=torch.bool, device=self.device))
        expr = (torch.zeros(self.cfg.dim_expr, device=self.device)
                if self.cfg.dim_expr > 0 else None)
        aud_arg, expr_arg = variant_conditioning(self.head_params, self.cfg,
                                                 feat, expr)
        pose = self._tensor(self.identity.poses[0])
        cache = None
        for _ in range(3):  # keyframe -> first delta -> steady delta
            frame, cache = self._frame(feat, aud_arg, expr_arg, pose, cache)
        frame.cpu()
        return time.perf_counter() - t0

    def push(self, aud_window, expr=None, pose=None):
        """Feed one frame's (16, 29) DeepSpeech window; returns the next
        ready frame (H, W, 3) float32 in [0, 1] as a numpy array, or None
        while the smoothing lookahead fills."""
        return self._push(aud_window, expr, pose, device=False)

    def push_device(self, aud_window, expr=None, pose=None):
        """push() that returns the frame as a tensor on the render device
        without the host copy (no synchronise)."""
        return self._push(aud_window, expr, pose, device=True)

    def flush(self) -> List[np.ndarray]:
        """End of stream: render the frames still inside the lookahead
        (their future features are zero, as at the track's end) and
        close the stream."""
        self._closed = True
        out = []
        while self._out_i < self._n_pushed:
            out.append(self._emit())
        return out

    # -- internals ----------------------------------------------------

    def _push(self, aud_window, expr, pose, device: bool):
        if self._closed:
            raise RuntimeError("stream is flushed/closed")
        self._hist.append(self._feat(aud_window))
        self._pending.append((expr, pose))
        self._n_pushed += 1
        self._hist_start = self._n_pushed - len(self._hist)
        if self._out_i + self.lookahead < self._n_pushed:
            return self._emit(device=device)
        return None

    def _smoothed_feat(self, i: int) -> torch.Tensor:
        """AudioAttNet-smoothed feature of frame i (centred window, zeros
        outside [0, n_pushed); beyond the end only once the stream is
        closed, the only time _emit needs them)."""
        if not self.smooth:
            return self._hist[i - self._hist_start]
        smo = self.cfg.smo_size
        half = smo // 2
        rows, valid = [], []
        zero = torch.zeros_like(self._hist[0])
        for j in range(i - half, i - half + smo):
            ok = 0 <= j < self._n_pushed
            rows.append(self._hist[j - self._hist_start] if ok else zero)
            valid.append(ok)
        return self._att(torch.stack(rows),
                         torch.tensor(valid, device=self.device))

    def _frame(self, feat, aud_arg, expr_arg, pose, cache):
        """One frame of the stream's renderer from the frame's smoothed
        audio feature, its variant conditioning and its pose."""
        if self.torso_params is None:
            return self._render(self.head_params, pose, self._bc,
                                aud=aud_arg, expr=expr_arg,
                                latent=self.latent, cache=cache)
        return self._render(
            self.head_params, self.torso_params, pose, self._pose0, self._bc,
            aud=aud_arg, signal=torso_signal(feat, pose, self.cfg.dim_aud_body),
            expr=expr_arg, latent=self.latent, cache=cache)

    @torch.no_grad()
    def _emit(self, device: bool = False):
        t0 = time.perf_counter()
        i = self._out_i
        expr, pose = self._pending.popleft()
        if pose is None:
            pose = self.identity.poses[i % self.identity.size]
        pose = self._tensor(pose)
        if expr is None and self.cfg.dim_expr > 0:
            expr = self.identity.exprs[i % self.identity.size]
        expr = (self._tensor(expr)
                if expr is not None and self.cfg.dim_expr > 0 else None)

        feat = self._smoothed_feat(i)
        aud_arg, expr_arg = variant_conditioning(
            self.head_params, self.cfg, feat, expr)
        # rolling mode: only frame 0 is a keyframe, the cache then lives
        # on (each ray refreshes through its slice every roll_k frames)
        keyframe = i == 0 if self.roll_k else i % self.refresh == 0
        frame, self._cache = self._frame(
            feat, aud_arg, expr_arg, pose, None if keyframe else self._cache)
        frame = torch.clamp(frame, 0.0, 1.0)
        if not device:
            frame = frame.cpu().numpy()   # waits for the device
        self._out_i += 1
        self.frame_times.append(time.perf_counter() - t0)
        self.frame_kinds.append("keyframe" if keyframe else "delta")
        return frame
