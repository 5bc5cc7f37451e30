"""Perceptual losses (counterpart of losses/perceptual.py; reference
loss/vgg_loss.py's gram helper and content loss, loss/vgg_face_loss.py's
multi-layer L1).

``FeatureLoss`` is a multi-layer feature loss over a feature function
(image -> list of feature maps). ``make_vgg16_features`` builds one from
the port's ``VGG16`` and a VGG16 state dict the caller gives (torchvision
is not a dependency of the port); without one it returns None, which is
what the JAX package's returns where torchvision's pretrained weights are
not cached.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) gram over C·H·W (vgg_loss.py:48-53)."""
    b, c, h, w = features.shape
    f = features.reshape(b, c, h * w)
    return torch.einsum("bcn,bdn->bcd", f, f) / (c * h * w)


class FeatureLoss:
    """The sum over layers of ``dist(feat(fake)_l, feat(target)_l)``:
    'l2' (a mean square) is VGGLOSS (vgg_loss.py:56-77), 'l1' (a mean
    absolute difference) VGGFaceLoss (vgg_face_loss.py:84-100)."""

    def __init__(self, feature_fn: Callable[..., Sequence],
                 dist: str = "l2"):
        if dist not in ("l1", "l2"):
            raise ValueError(f"dist must be 'l1' or 'l2', got {dist!r}")
        self.feature_fn = feature_fn
        self.dist = dist

    def __call__(self, fake, target):
        total = 0.0
        for a, b in zip(self.feature_fn(fake), self.feature_fn(target)):
            d = torch.as_tensor(a) - torch.as_tensor(b)
            total = total + (torch.mean(d ** 2) if self.dist == "l2"
                             else torch.mean(torch.abs(d)))
        return total


def make_vgg16_features(state_dict=None,
                        layers: Sequence[int] = (3, 8, 15, 22)
                        ) -> Optional[Callable]:
    """A VGG16 feature extractor (relu1_2, 2_2, 3_3, 4_3 by default) over
    ``state_dict``'s weights, or None without them. It takes an (H, W, 3)
    or (B, 3, H, W) image as torchvision's net does (no input map) and
    returns the taps as NCHW numpy arrays, on the host without gradient, as
    the JAX package's does."""
    if state_dict is None:
        return None
    from idealnerf_tpu_torch.losses.vgg import VGG16

    net = VGG16()
    net.load_state_dict(state_dict)

    def features(img) -> List[np.ndarray]:
        x = torch.as_tensor(np.asarray(img, np.float32))
        if x.ndim == 3:
            x = x.permute(2, 0, 1)[None]
        with torch.no_grad():
            return [t.numpy() for t in net.taps(x, tuple(layers))]

    return features
