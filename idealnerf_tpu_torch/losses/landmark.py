"""Landmark losses (counterpart of losses/landmark.py; reference
loss/landmark_loss.py, utils/landmark_utils.py, helper.py:160-170).

The detector is a callable: ``make_fan_landmark_loss`` gives the
second stage's, the port's FAN (``pipeline.fan``) on the render and on
the target crop with an L1 over their final-stack heatmaps.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def landmark_features(lms: torch.Tensor) -> torch.Tensor:
    """(L, 2) landmarks -> (L (L - 1) / 2,) upper-triangle pairwise
    distances over their maximum (utils/landmark_utils.py:12-23)."""
    diff = lms[:, None, :] - lms[None, :, :]
    dist = torch.sqrt(torch.sum(diff ** 2, dim=-1) + 1e-12)
    n = lms.shape[0]
    iu = torch.triu_indices(n, n, offset=1, device=lms.device)
    feats = dist[iu[0], iu[1]]
    return feats / torch.max(feats)


def landmark_feature_loss(pred_lms: torch.Tensor,
                          target_feats: torch.Tensor) -> torch.Tensor:
    """MSE between the render's landmark features and the target's (the
    ``.lf`` files, helper.py:160-170)."""
    return torch.mean((landmark_features(pred_lms) - target_feats) ** 2)


def heatmap_landmark_loss(pred_heatmaps: torch.Tensor,
                          target_heatmaps: torch.Tensor) -> torch.Tensor:
    """L1 over heatmaps (landmark_loss.py:149-161)."""
    return torch.mean(torch.abs(pred_heatmaps - target_heatmaps))


class LandmarkLoss:
    """``detector(image (H, W, 3) float [0, 1]) -> heatmaps``, run on both
    images; without one, calling raises."""

    def __init__(self, detector: Optional[Callable] = None):
        self.detector = detector

    def __call__(self, fake: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        if self.detector is None:
            raise RuntimeError(
                "LandmarkLoss needs a heatmap detector callable (FAN weights "
                "are not bundled; give a FAN through make_fan_landmark_loss)")
        return heatmap_landmark_loss(self.detector(fake),
                                     self.detector(target))


def make_fan_landmark_loss(fan) -> LandmarkLoss:
    """LandmarkLoss over a ``pipeline.fan.FAN`` (released, proxy-trained or
    ``init_fan`` weights): the reference's ``LandmarkLoss(device)``."""
    from idealnerf_tpu_torch.pipeline.fan import make_heatmap_detector

    return LandmarkLoss(make_heatmap_detector(fan))
