"""Sinusoidal positional encoding (counterpart of core/embedding.py).

Layout ``[x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]`` with
log-sampled frequencies 2**linspace(0, F-1, F), frequency-major. The
phases reach 512·x ≈ 300 rad at multires=10, so callers encode in
float32 and round afterwards, never before.
"""

from __future__ import annotations

import torch


def pe_dim(input_dims: int, num_freqs: int, include_input: bool = True) -> int:
    """Output channel count of ``positional_encoding``."""
    if num_freqs <= 0:
        return input_dims
    return input_dims * (2 * num_freqs + (1 if include_input else 0))


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode ``x[..., d]`` into ``[..., pe_dim(d, num_freqs)]``."""
    if num_freqs <= 0:
        return x
    if log_sampling:
        freqs = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs,
                                      dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                               dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                    # (..., F, d)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., F, 2, d)
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
