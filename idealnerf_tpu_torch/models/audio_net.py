"""Audio conditioning encoders (counterpart of models/audio_net.py).

- AudioNet: per-frame encoder over the centred win_size slice of a
  (16, 29) DeepSpeech window — 4 strided Conv1d 29→32→32→64→64, then a
  2-layer FC to dim_aud.
- AudioAttNet: temporal-attention smoothing over a seq_len=8 window of
  AudioNet features.
- DeepSpeechAudNet: raw 29-dim conditioning via Linear(16→1), the
  dim_aud<=29 path.

All LeakyReLU slopes are 0.02. Conv1d weights are (out, in, k), the
layout the JAX package already uses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.nn import init_weights_, leaky_relu


class AudioNet(nn.Module):
    def __init__(self, dim_aud: int = 64, win_size: int = 16,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.win_size = win_size
        chans = [29, 32, 32, 64, 64]
        self.conv = nn.ModuleList(
            nn.Conv1d(chans[i], chans[i + 1], 3, stride=2, padding=1,
                      device=device) for i in range(4))
        self.fc = nn.ModuleList([nn.Linear(64, 64, device=device),
                                 nn.Linear(64, dim_aud, device=device)])
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 16, 29) DeepSpeech windows -> (N, dim_aud)."""
        half_w = self.win_size // 2
        x = x[:, 8 - half_w: 8 + half_w, :].permute(0, 2, 1)  # (N, 29, win)
        for conv in self.conv:
            x = leaky_relu(conv(x))
        x = x[:, :, 0]                        # (N, 64) after win 16→8→4→2→1
        x = leaky_relu(self.fc[0](x))
        return self.fc[1](x)


class AudioAttNet(nn.Module):
    def __init__(self, dim_aud: int = 32, seq_len: int = 8,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dim_aud = dim_aud
        self.seq_len = seq_len
        chans = [dim_aud, 16, 8, 4, 2, 1]
        self.conv = nn.ModuleList(
            nn.Conv1d(chans[i], chans[i + 1], 3, stride=1, padding=1,
                      device=device) for i in range(5))
        self.att = nn.Linear(seq_len, seq_len, device=device)
        init_weights_(self, generator)

    def attention(self, xb: torch.Tensor) -> torch.Tensor:
        """Windows (B, seq_len, dim) -> their attention weights (B,
        seq_len), a softmax over the window; only the first dim_aud
        channels feed it."""
        y = xb[..., : self.dim_aud].transpose(1, 2)  # (B, dim_aud, seq_len)
        for conv in self.conv:
            y = leaky_relu(conv(y))
        return torch.softmax(self.att(y.reshape(-1, self.seq_len)), dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (seq_len, dim) -> (dim,) attention-weighted sum over the
        window, or a batch of windows (B, seq_len, dim) -> (B, dim)."""
        xb = x if x.ndim == 3 else x[None]
        out = torch.sum(self.attention(xb)[..., None] * xb, dim=1)
        return out if x.ndim == 3 else out[0]


class DeepSpeechAudNet(nn.Module):
    def __init__(self, win_size: int = 16,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.fc = nn.Linear(win_size, 1, device=device)
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 16, 29) -> (N, 29): Linear(16→1) over the window."""
        return leaky_relu(self.fc(x.permute(0, 2, 1)))[..., 0]
