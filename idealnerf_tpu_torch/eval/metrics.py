"""Image quality metrics (counterpart of eval/metrics.py): PSNR and a
host-side float64 SSIM."""

from __future__ import annotations

import numpy as np
import torch


def psnr(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img - ref) ** 2)
    return -10.0 * torch.log(mse) / np.log(10.0)


def ssim(
    img,
    ref,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean SSIM over an (H, W, C) pair (Gaussian-windowed, standard
    constants), in float64 numpy on the host: the local-variance terms
    blur(x*x) - mu**2 cancel catastrophically below full precision."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().cpu().numpy()
    img = np.asarray(img, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    hw = filter_size // 2
    offs = np.arange(-hw, hw + 1, dtype=np.float64)
    g = np.exp(-(offs**2) / (2.0 * filter_sigma**2))
    g = g / np.sum(g)

    def blur(x):  # separable gaussian over H and W, per channel
        xp = np.pad(x, [(hw, hw), (0, 0), (0, 0)], mode="symmetric")
        x = np.apply_along_axis(
            lambda v: np.convolve(v, g, mode="valid"), 0, xp)
        xp = np.pad(x, [(0, 0), (hw, hw), (0, 0)], mode="symmetric")
        return np.apply_along_axis(
            lambda v: np.convolve(v, g, mode="valid"), 1, xp)

    mu_x, mu_y = blur(img), blur(ref)
    sxx = blur(img * img) - mu_x**2
    syy = blur(ref * ref) - mu_y**2
    sxy = blur(img * ref) - mu_x * mu_y
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2)
    return float(np.mean(num / den))
