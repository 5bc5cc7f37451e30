"""Pixel metrics (counterpart of utils/metrics.py; reference
helper.py:148-157). ``to8b`` is ``eval.video``'s."""

import math

import torch

from idealnerf_tpu_torch.eval.video import to8b

__all__ = ["img2mse", "mse2psnr", "to8b"]


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)
