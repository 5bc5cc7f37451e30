"""VGG16 and VGGFace feature networks and their losses (counterpart of
losses/vgg.py; reference loss/vgg_loss.py:10-77, relu1_2 ... relu4_3, and
loss/vgg_face_loss.py:8-81, relu1_1 ... relu5_1 with ceil-mode pools).

``VGG16`` is torchvision's ``vgg16().features`` layout, indices 0-30, so
its ``load_state_dict`` takes that module's dict or the whole model's
``features.``-prefixed one (other keys are ignored). The losses tap it up
to relu4_3 (layer 22); LPIPS (``eval.metrics.lpips``) also taps relu5_3
(29). ``VGGFace`` holds ``conv1_1`` ... ``conv5_1`` and ignores a dict's
other keys (the fc layers), as the reference's ``strict=False`` load.
Images go in NHWC as in the JAX package and the taps come back NHWC; the
convolutions run in f32 without TF32 on the card
(``face_unet.ieee_convs``). Random weights are He-initialised from a seed;
released weights go in through ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from idealnerf_tpu_torch.models.face_unet import ieee_convs
from idealnerf_tpu_torch.models.nn import tensor_state_dict

# torchvision vgg16.features: conv index, in, out; pools after 3, 8, 15,
# 22 and 29's relus
VGG16_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
               (10, 128, 256), (12, 256, 256), (14, 256, 256),
               (17, 256, 512), (19, 512, 512), (21, 512, 512),
               (24, 512, 512), (26, 512, 512), (28, 512, 512))
VGG16_POOLS = (4, 9, 16, 23, 30)
VGG16_TAPS = (3, 8, 15, 22)  # relu1_2, relu2_2, relu3_3, relu4_3
LPIPS_TAPS = VGG16_TAPS + (29,)  # and relu5_3

VGGFACE_CONVS = (("conv1_1", 3, 64), ("conv1_2", 64, 64),
                 ("conv2_1", 64, 128), ("conv2_2", 128, 128),
                 ("conv3_1", 128, 256), ("conv3_2", 256, 256),
                 ("conv3_3", 256, 256),
                 ("conv4_1", 256, 512), ("conv4_2", 512, 512),
                 ("conv4_3", 512, 512), ("conv5_1", 512, 512))
VGGFACE_POOL_AFTER = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")
VGGFACE_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")


def _he_init_(module: nn.Module,
              generator: Optional[torch.Generator]) -> None:
    """N(0, 2 / (9 cin)) weights drawn on the host, zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(2.0 / (9 * m.in_channels)))
                m.bias.zero_()


def _load_own(module: nn.Module, state_dict, strict: bool, assign: bool):
    own = set(nn.Module.state_dict(module))
    return nn.Module.load_state_dict(
        module, tensor_state_dict(state_dict, keep=own), strict, assign)


class VGG16(nn.Sequential):
    def __init__(self, generator: Optional[torch.Generator] = None,
                 device=None):
        convs = {i: (cin, cout) for i, cin, cout in VGG16_CONVS}
        layers = []
        for i in range(VGG16_POOLS[-1] + 1):
            if i in convs:
                layers.append(nn.Conv2d(*convs[i], 3, padding=1,
                                        device=device))
            elif i in VGG16_POOLS:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        super().__init__(*layers)
        _he_init_(self, generator)

    def taps(self, x: torch.Tensor,
             taps: Sequence[int] = VGG16_TAPS) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> the outputs of layers ``taps``, NCHW; the
        layers past the last tap do not run."""
        out = []
        with ieee_convs():
            for i, layer in enumerate(self):
                x = layer(x)
                if i in taps:
                    out.append(x)
                if i >= max(taps):
                    break
        return out

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``vgg16().features.state_dict()`` or the whole model's dict."""
        sd = {k[len("features."):] if k.startswith("features.") else k: v
              for k, v in state_dict.items()}
        return _load_own(self, sd, strict, assign)


class VGGFace(nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        for name, cin, cout in VGGFACE_CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1,
                                            device=device))
        _he_init_(self, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1],
        NCHW; each pool pads its right and bottom with -inf first (ceil
        mode: one more row or column at an odd size)."""
        taps = []
        with ieee_convs():
            for name, _, _ in VGGFACE_CONVS:
                x = F.relu(self._modules[name](x))
                if name in VGGFACE_TAPS:
                    taps.append(x)
                if name in VGGFACE_POOL_AFTER:
                    x = F.max_pool2d(F.pad(x, (0, 1, 0, 1),
                                           value=float("-inf")), 2, 2)
        return taps

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """A vgg_face.pth-style dict; keys other than the convs' ignored."""
        return _load_own(self, state_dict, strict, assign)


def init_vgg16(seed: int = 0, device=None) -> VGG16:
    return VGG16(torch.Generator().manual_seed(seed)).to(device)


def init_vggface(seed: int = 0, device=None) -> VGGFace:
    return VGGFace(torch.Generator().manual_seed(seed)).to(device)


def _nhwc(taps: List[torch.Tensor]) -> List[torch.Tensor]:
    return [t.permute(0, 2, 3, 1) for t in taps]


def vgg16_features(net: VGG16, x: torch.Tensor) -> List[torch.Tensor]:
    """(B, H, W, 3) in [-1, 1] -> [relu1_2, relu2_2, relu3_3, relu4_3]
    (vgg_loss.py:30-46, with its 0.5 (x + 1) input map)."""
    return _nhwc(net.taps((0.5 * (x + 1.0)).permute(0, 3, 1, 2)))


def vggface_features(net: VGGFace, x: torch.Tensor) -> List[torch.Tensor]:
    """(B, H, W, 3) -> [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1]."""
    return _nhwc(net(x.permute(0, 3, 1, 2)))


def make_vgg16_loss(net: VGG16):
    """VGGLOSS (vgg_loss.py:56-77): the sum over the four taps of their
    MSE; (B, H, W, 3) images in [-1, 1], the target's features without
    gradient."""

    def loss(fake, target):
        ff = vgg16_features(net, fake)
        with torch.no_grad():
            ft = vgg16_features(net, target)
        return sum(torch.mean((a - b) ** 2) for a, b in zip(ff, ft))

    return loss


def make_vggface_loss(net: VGGFace):
    """VGGFaceLoss (vgg_face_loss.py:91-100): the sum over the five taps of
    their mean L1."""

    def loss(fake, target):
        ff = vggface_features(net, fake)
        with torch.no_grad():
            ft = vggface_features(net, target)
        return sum(torch.mean(torch.abs(a - b)) for a, b in zip(ff, ft))

    return loss


def load_vggface(path: str, device=None) -> VGGFace:
    """A VGGFace holding the state dict saved at ``path``
    (loss/vgg_face.pth)."""
    net = VGGFace()
    net.load_state_dict(torch.load(path, map_location="cpu",
                                   weights_only=True))
    return net.to(device)
