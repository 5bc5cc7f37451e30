"""FAN 2DFAN-4 landmark network (counterpart of pipeline/fan.py): the
stacked-hourglass FAN of Bulat & Tzimiropoulos (ICCV'17), 4 stacks, 68
heatmaps at 64x64 from a 256x256 crop, run by the offline landmark
detection and by the second stage's landmark loss, differentiable end to
end.

The modules' state-dict keys are the published 2DFAN-4 names and those
of the JAX package's flat parameter dict (``conv1.weight``,
``m0.b1_4.bn1.running_mean``, ...), so ``FAN.load_state_dict`` takes a
released dict, a JAX ``fan_proxy.npz`` (``np.load``) or ``init_fan``'s
output as they are (BatchNorm's ``num_batches_tracked`` is dropped). The
stack count comes from the dict (``FAN.from_state_dict``) or the caller.

The batch norm is the JAX package's: an affine on the stored statistics
in training and evaluation alike, its four tensors all parameters
(``StatBN``), so a trainer of the net (``scripts.train_fan_proxy``)
updates the same leaves as the JAX one. The convolutions run in f32
without TF32 on the card (``face_unet.ieee_convs``); the resize is
``F.interpolate``'s antialiased bilinear, which is ``jax.image.resize``'s
"linear" when it shrinks as when it grows.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idealnerf_tpu_torch.models.face_unet import ieee_convs
from idealnerf_tpu_torch.models.nn import tensor_state_dict

N_LANDMARKS = 68
HEATMAP_SIZE = 64
CROP_SIZE = 256
NUM_MODULES = 4
HG_DEPTH = 4


class StatBN(nn.Module):
    """``weight * (x - running_mean) * rsqrt(running_var + eps) + bias``
    over NCHW channels, all four tensors parameters."""

    def __init__(self, c: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.running_mean = nn.Parameter(torch.zeros(c, device=device))
        self.running_var = nn.Parameter(torch.ones(c, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def v(t):
            return t[None, :, None, None]

        return (v(self.weight) * (x - v(self.running_mean))
                * torch.rsqrt(v(self.running_var) + self.eps)
                + v(self.bias))


class ConvBlock(nn.Module):
    """Pre-activation 3-way block: cat(c1, c2, c3) plus the input, through
    a BN-ReLU-1x1 ``downsample`` where the channel counts differ."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.bn1 = StatBN(cin, device=device)
        self.conv1 = nn.Conv2d(cin, cout // 2, 3, 1, 1, bias=False,
                               device=device)
        self.bn2 = StatBN(cout // 2, device=device)
        self.conv2 = nn.Conv2d(cout // 2, cout // 4, 3, 1, 1, bias=False,
                               device=device)
        self.bn3 = StatBN(cout // 4, device=device)
        self.conv3 = nn.Conv2d(cout // 4, cout // 4, 3, 1, 1, bias=False,
                               device=device)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Sequential(
                StatBN(cin, device=device), nn.ReLU(),
                nn.Conv2d(cin, cout, 1, bias=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], dim=1) + res


class HourGlass(nn.Module):
    def __init__(self, depth: int = HG_DEPTH, device=None):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            names = [f"b1_{level}", f"b2_{level}"]
            if level == 1:
                names.append(f"b2_plus_{level}")
            for name in names + [f"b3_{level}"]:
                self.add_module(name, ConvBlock(256, 256, device=device))

    def _level(self, level: int, x: torch.Tensor) -> torch.Tensor:
        up1 = self._modules[f"b1_{level}"](x)
        low1 = self._modules[f"b2_{level}"](F.avg_pool2d(x, 2, 2))
        if level > 1:
            low2 = self._level(level - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{level}"](low1)
        low3 = self._modules[f"b3_{level}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FAN(nn.Module):
    """``forward(x (B, 3, H, W) in [0, 1])`` -> the ``num_modules`` heatmap
    stacks, each (B, 68, H / 4, W / 4)."""

    def __init__(self, num_modules: int = NUM_MODULES, device=None):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, device=device)
        self.bn1 = StatBN(64, device=device)
        self.conv2 = ConvBlock(64, 128, device=device)
        self.conv3 = ConvBlock(128, 128, device=device)
        self.conv4 = ConvBlock(128, 256, device=device)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(device=device))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, device=device))
            self.add_module(f"conv_last{i}",
                            nn.Conv2d(256, 256, 1, device=device))
            self.add_module(f"bn_end{i}", StatBN(256, device=device))
            self.add_module(f"l{i}",
                            nn.Conv2d(256, N_LANDMARKS, 1, device=device))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1,
                                                    device=device))
                self.add_module(f"al{i}", nn.Conv2d(N_LANDMARKS, 256, 1,
                                                    device=device))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        m = self._modules
        with ieee_convs():
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.avg_pool2d(self.conv2(x), 2, 2)
            x = self.conv4(self.conv3(x))
            previous, outputs = x, []
            for i in range(self.num_modules):
                ll = m[f"top_m_{i}"](m[f"m{i}"](previous))
                ll = F.relu(m[f"bn_end{i}"](m[f"conv_last{i}"](ll)))
                out = m[f"l{i}"](ll)
                outputs.append(out)
                if i < self.num_modules - 1:
                    previous = (previous + m[f"bl{i}"](ll)
                                + m[f"al{i}"](out))
        return outputs

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Tensors or numpy arrays under the published names."""
        return super().load_state_dict(tensor_state_dict(state_dict), strict,
                                       assign)

    @classmethod
    def from_state_dict(cls, state_dict, device=None) -> "FAN":
        """A FAN with as many stacks as ``state_dict`` has ``l{i}`` heads,
        holding its weights."""
        sd = tensor_state_dict(state_dict)
        n = sum(1 for k in sd if re.fullmatch(r"l\d+\.weight", k))
        net = cls(n, device=device)
        net.load_state_dict(sd)
        return net


def resize_linear(image: torch.Tensor, size) -> torch.Tensor:
    """(H, W, C) -> (size[0], size[1], C): ``jax.image.resize(...,
    "linear")``, antialiased where it shrinks."""
    x = image.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def heatmaps_to_landmarks(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, 68, H, W) -> (B, 68, 2) (x, y) in heatmap pixels: the argmax,
    shifted 0.25 toward the stronger neighbour on each axis
    (face_alignment's get_preds_fromhm)."""
    B, L, H, W = heatmaps.shape
    flat = heatmaps.reshape(B, L, H * W)
    idx = torch.argmax(flat, dim=-1)
    y, x = idx // W, idx % W

    def at(yy, xx):
        return torch.gather(flat, -1, (yy * W + xx)[..., None])[..., 0]

    dx = at(y, (x + 1).clamp(0, W - 1)) - at(y, (x - 1).clamp(0, W - 1))
    dy = at((y + 1).clamp(0, H - 1), x) - at((y - 1).clamp(0, H - 1), x)
    fx = x.float() + 0.25 * torch.sign(dx)
    fy = y.float() + 0.25 * torch.sign(dy)
    return torch.stack([fx, fy], dim=-1)


def soft_landmarks(heatmaps: torch.Tensor,
                   temperature: float = 10.0) -> torch.Tensor:
    """Differentiable soft-argmax landmarks (B, 68, 2) in heatmap pixels."""
    B, L, H, W = heatmaps.shape
    p = torch.softmax(heatmaps.reshape(B, L, H * W) * temperature, dim=-1)
    p = p.reshape(B, L, H, W)
    ys = torch.arange(H, dtype=p.dtype, device=p.device)
    xs = torch.arange(W, dtype=p.dtype, device=p.device)
    fy = torch.sum(p.sum(dim=3) * ys, dim=-1)
    fx = torch.sum(p.sum(dim=2) * xs, dim=-1)
    return torch.stack([fx, fy], dim=-1)


@torch.no_grad()
def detect_landmarks(fan: FAN, image: np.ndarray, box) -> np.ndarray:
    """Offline detection: crop the face ``box`` [x0, y0, x1, y1] of the
    uint8 (H, W, 3) ``image``, resize it to ``CROP_SIZE``², run ``fan`` on
    its device and map the final stack's landmarks back to image pixels
    -> (68, 2) float (x, y), the .lms format."""
    x0, y0, x1, y1 = [int(v) for v in box]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, image.shape[1]), min(y1, image.shape[0])
    crop = torch.from_numpy(image[y0:y1, x0:x1].astype(np.float32) / 255.0)
    crop = resize_linear(crop.to(next(fan.parameters()).device),
                         (CROP_SIZE, CROP_SIZE))
    hm = fan(crop.permute(2, 0, 1)[None])[-1]
    lms = heatmaps_to_landmarks(hm)[0].cpu().numpy()
    hm_size = hm.shape[-1]
    return np.stack([lms[:, 0] * ((x1 - x0) / hm_size) + x0,
                     lms[:, 1] * ((y1 - y0) / hm_size) + y0], axis=-1)


def make_heatmap_detector(fan: FAN):
    """The landmark loss's detector: (H, W, 3) float [0, 1] on ``fan``'s
    device -> the final stack's (68, CROP_SIZE / 4, CROP_SIZE / 4)
    heatmaps, differentiable."""

    def detector(image: torch.Tensor) -> torch.Tensor:
        img = resize_linear(image, (CROP_SIZE, CROP_SIZE))
        return fan(img.permute(2, 0, 1)[None])[-1][0]

    return detector


def init_fan(seed, num_modules: Optional[int] = None
             ) -> Dict[str, np.ndarray]:
    """Random weights with the 2DFAN-4 state-dict structure, drawn from
    ``np.random.RandomState(seed)`` (or the RandomState given) in the JAX
    package's order: an int seed gives the draws the JAX ``init_fan``
    makes where its key maps to that int. ``num_modules`` defaults to
    ``NUM_MODULES``."""
    num_modules = NUM_MODULES if num_modules is None else num_modules
    rng = (seed if isinstance(seed, np.random.RandomState)
           else np.random.RandomState(seed))
    params: Dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k, bias=True):
        fan_in = cin * k * k
        params[f"{name}.weight"] = (
            rng.randn(cout, cin, k, k).astype(np.float32)
            * (2.0 / fan_in) ** 0.5)
        if bias:
            params[f"{name}.bias"] = np.zeros(cout, np.float32)

    def bn(name, c):
        params[f"{name}.weight"] = (np.abs(rng.randn(c).astype(np.float32))
                                    + 0.5)
        params[f"{name}.bias"] = rng.randn(c).astype(np.float32) * 0.1
        params[f"{name}.running_mean"] = rng.randn(c).astype(np.float32) * 0.1
        params[f"{name}.running_var"] = (
            np.abs(rng.randn(c).astype(np.float32)) + 0.5)

    def conv_block(name, cin, cout):
        bn(f"{name}.bn1", cin)
        conv(f"{name}.conv1", cin, cout // 2, 3, bias=False)
        bn(f"{name}.bn2", cout // 2)
        conv(f"{name}.conv2", cout // 2, cout // 4, 3, bias=False)
        bn(f"{name}.bn3", cout // 4)
        conv(f"{name}.conv3", cout // 4, cout // 4, 3, bias=False)
        if cin != cout:
            bn(f"{name}.downsample.0", cin)
            conv(f"{name}.downsample.2", cin, cout, 1, bias=False)

    conv("conv1", 3, 64, 7)
    bn("bn1", 64)
    conv_block("conv2", 64, 128)
    conv_block("conv3", 128, 128)
    conv_block("conv4", 128, 256)
    for i in range(num_modules):
        for level in range(HG_DEPTH, 0, -1):
            conv_block(f"m{i}.b1_{level}", 256, 256)
            conv_block(f"m{i}.b2_{level}", 256, 256)
            if level == 1:
                conv_block(f"m{i}.b2_plus_{level}", 256, 256)
            conv_block(f"m{i}.b3_{level}", 256, 256)
        conv_block(f"top_m_{i}", 256, 256)
        conv(f"conv_last{i}", 256, 256, 1)
        bn(f"bn_end{i}", 256)
        conv(f"l{i}", 256, N_LANDMARKS, 1)
        if i < num_modules - 1:
            conv(f"bl{i}", 256, 256, 1)
            conv(f"al{i}", N_LANDMARKS, 256, 1)
    return params
