"""Image quality metrics (counterpart of eval/metrics.py): PSNR, a
host-side float64 SSIM and LPIPS over the port's VGG16."""

from __future__ import annotations

from typing import Optional

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


def lpips(img, ref, vgg16=None) -> Optional[float]:
    """LPIPS-style perceptual distance of two (H, W, 3) images in [0, 1]:
    the mean square difference of the unit-normalised (over channels)
    relu1_2, 2_2, 3_3, 4_3 and 5_3 maps of ``vgg16`` (a
    ``losses.vgg.VGG16``, on its device) after ImageNet normalisation,
    averaged over the five layers (the unscaled formulation). None
    without weights, as the JAX package's without torchvision's."""
    if vgg16 is None:
        return None
    from idealnerf_tpu_torch.losses.vgg import LPIPS_TAPS

    dev = next(vgg16.parameters()).device
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev).view(1, 3, 1, 1)

    def prep(x):
        t = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return (t.permute(2, 0, 1)[None] - mean) / std

    with torch.no_grad():
        dist = 0.0
        for fa, fb in zip(vgg16.taps(prep(img), LPIPS_TAPS),
                          vgg16.taps(prep(ref), LPIPS_TAPS)):
            fa = fa / (fa.norm(dim=1, keepdim=True) + 1e-10)
            fb = fb / (fb.norm(dim=1, keepdim=True) + 1e-10)
            dist += float(((fa - fb) ** 2).mean())
    return dist / len(LPIPS_TAPS)
