"""Head-model helpers (counterpart of train/head.py; the trainer itself
comes with the training slice)."""

from __future__ import annotations

import torch


def compute_aud_feature(
    params,
    auds: torch.Tensor,       # (M, 16, 29) raw DeepSpeech windows
    aud_ids: torch.Tensor,    # (N,) per-frame window index
    index: int,               # frame index
    cfg,
    smooth: bool,
) -> torch.Tensor:
    """Per-frame audio conditioning vector.

    dim_aud>29 selects AudioNet (with AudioAttNet smoothing over smo_size
    neighbouring frames once ``smooth``), else DeepSpeechAudNet. The
    smoothing window indexes frames, zero-padded at the sequence edges.
    """
    if cfg.dim_aud <= 29:
        return params["ds_aud"](auds[aud_ids[index]][None])[0]
    if not smooth:
        return params["aud_net"](auds[aud_ids[index]][None])[0]
    n = aud_ids.shape[0]
    half = cfg.smo_size // 2
    idx = index - half + torch.arange(cfg.smo_size, device=auds.device)
    valid = (idx >= 0) & (idx < n)
    windows = auds[aud_ids[torch.clamp(idx, 0, n - 1)]]
    windows = torch.where(valid[:, None, None], windows,
                          torch.zeros_like(windows))
    feats = params["aud_net"](windows)
    return params["aud_att"](feats)
