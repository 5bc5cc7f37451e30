"""BiSeNet face-parsing network (counterpart of pipeline/parsing_net.py;
reference: data_util/face_parsing/model.py:19-270, resnet.py:23-103;
inference protocol test.py:29-109).

The reference's variant deletes the SpatialPath and feeds the ResNet18
1/8 feature in its place (model.py:240-250). 19 classes; weights
``79999_iter.pth``.

``BiSeNet`` is an ``nn.Module`` tree whose ``state_dict()`` names are the
reference's (``cp.resnet.conv1.weight``, ...), which are the JAX
package's flat parameter names, so ``BiSeNet.load_state_dict`` takes a
released torch dict, a JAX ``.npz`` or ``init_bisenet``'s output as they
are (BatchNorm's ``num_batches_tracked`` is dropped). The batch norms are
eval-mode with eps 1e-5, as an affine on the stored statistics
(``fan.StatBN``, the JAX formula); the convolutions run in f32 without
TF32 on the card (``face_unet.ieee_convs``). The upsamplings are the JAX
module's index arithmetic in f32: ``F.interpolate``'s nearest index
rounds otherwise at exact multiples, and the bilinear one is torch's
``align_corners=True``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idealnerf_tpu_torch.models.face_unet import ieee_convs
from idealnerf_tpu_torch.models.nn import tensor_state_dict
from idealnerf_tpu_torch.pipeline.fan import StatBN, resize_linear

N_CLASSES = 19
INFER_SIZE = 512   # test.py:62: the net sees every frame at 512², read at call time
# ImageNet normalization (test.py:48-51)
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------- ops


def _global_avg(x):
    return torch.mean(x, dim=(2, 3), keepdim=True)


def _interp_nearest(x, hw: Tuple[int, int]):
    """torch F.interpolate(mode='nearest'): index = floor(i * (in / out))
    in f32."""
    H, W = hw
    h, w = x.shape[2], x.shape[3]

    def idx(n_out, n_in):
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor(pos * (n_in / n_out)).long()

    return x[:, :, idx(H, h)][:, :, :, idx(W, w)]


def _interp_bilinear_ac(x, hw: Tuple[int, int]):
    """torch F.interpolate(mode='bilinear', align_corners=True)."""
    H, W = hw
    h, w = x.shape[2], x.shape[3]

    def axis_coords(out_n, in_n):
        if out_n == 1 or in_n == 1:
            z = torch.zeros(out_n, dtype=torch.long, device=x.device)
            return z, z, torch.zeros(out_n, dtype=x.dtype, device=x.device)
        pos = (torch.arange(out_n, dtype=x.dtype, device=x.device)
               * ((in_n - 1) / (out_n - 1)))
        lo = torch.clamp(torch.floor(pos).long(), 0, in_n - 2)
        return lo, lo + 1, pos - lo.to(x.dtype)

    r0, r1, rf = axis_coords(H, h)
    c0, c1, cf = axis_coords(W, w)
    top = x[:, :, r0]
    bot = x[:, :, r1]
    xr = top + (bot - top) * rf[None, None, :, None]
    left = xr[:, :, :, c0]
    right = xr[:, :, :, c1]
    return left + (right - left) * cf[None, None, None, :]


# ------------------------------------------------------------- blocks


def _conv(cin, cout, k, stride=1, pad=0, device=None):
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False, device=device)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=1, device=None):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, pad, device)
        self.bn = StatBN(cout, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """resnet.py:23-50: relu(bn1(conv1)), bn2(conv2), shortcut (1x1
    downsampled where the shape changes), relu(add)."""

    def __init__(self, cin, cout, stride=1, device=None):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1, device)
        self.bn1 = StatBN(cout, device=device)
        self.conv2 = _conv(cout, cout, 3, 1, 1, device)
        self.bn2 = StatBN(cout, device=device)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride, 0,
                                                  device),
                                            StatBN(cout, device=device))

    def forward(self, x):
        res = F.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        short = x if self.downsample is None else self.downsample(x)
        return F.relu(short + res)


class ResNet18(nn.Module):
    """(B,3,H,W) -> (feat8, feat16, feat32) (resnet.py:61-86)."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3, device)
        self.bn1 = StatBN(64, device=device)
        for i, (cin, cout, s) in enumerate(
                [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)],
                start=1):
            self.add_module(f"layer{i}", nn.Sequential(
                BasicBlock(cin, cout, s, device),
                BasicBlock(cout, cout, 1, device)))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)         # pads with -inf
        f8 = self.layer2(self.layer1(x))
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


class AttentionRefinement(nn.Module):
    """model.py:76-95."""

    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 3, 1, 1, device)
        self.conv_atten = _conv(cout, cout, 1, device=device)
        self.bn_atten = StatBN(cout, device=device)

    def forward(self, x):
        feat = self.conv(x)
        att = torch.sigmoid(self.bn_atten(self.conv_atten(_global_avg(feat))))
        return feat * att


class ContextPath(nn.Module):
    """model.py:98-130: -> (feat_res8, feat_cp8, feat_cp16)."""

    def __init__(self, device=None):
        super().__init__()
        self.resnet = ResNet18(device)
        self.arm16 = AttentionRefinement(256, 128, device)
        self.arm32 = AttentionRefinement(512, 128, device)
        self.conv_head32 = ConvBNReLU(128, 128, 3, 1, 1, device)
        self.conv_head16 = ConvBNReLU(128, 128, 3, 1, 1, device)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0, device)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = self.conv_avg(_global_avg(f32))
        f32_sum = self.arm32(f32) + avg.expand(-1, -1, *f32.shape[2:])
        f32_up = self.conv_head32(_interp_nearest(f32_sum, f16.shape[2:]))
        f16_sum = self.arm16(f16) + f32_up
        f16_up = self.conv_head16(_interp_nearest(f16_sum, f8.shape[2:]))
        return f8, f16_up, f32_up


class FeatureFusion(nn.Module):
    """model.py:185-216."""

    def __init__(self, device=None):
        super().__init__()
        self.convblk = ConvBNReLU(256, 256, 1, 1, 0, device)
        self.conv1 = _conv(256, 64, 1, device=device)
        self.conv2 = _conv(64, 256, 1, device=device)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        att = F.relu(self.conv1(_global_avg(feat)))
        att = torch.sigmoid(self.conv2(att))
        return feat * att + feat


class BiSeNetOutput(nn.Module):
    """model.py:41-56."""

    def __init__(self, cin, mid, n_classes, device=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3, 1, 1, device)
        self.conv_out = _conv(mid, n_classes, 1, device=device)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """``forward(x (B, 3, H, W) normalized)`` -> (out, out16, out32)
    logits at (H, W) (model.py:240-262)."""

    def __init__(self, n_classes: int = N_CLASSES, device=None):
        super().__init__()
        self.cp = ContextPath(device)
        self.ffm = FeatureFusion(device)
        self.conv_out = BiSeNetOutput(256, 256, n_classes, device)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes, device)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes, device)

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        with ieee_convs():
            feat_res8, feat_cp8, feat_cp16 = self.cp(x)
            feat_fuse = self.ffm(feat_res8, feat_cp8)
            outs = (self.conv_out(feat_fuse), self.conv_out16(feat_cp8),
                    self.conv_out32(feat_cp16))
        return tuple(_interp_bilinear_ac(o, (H, W)) for o in outs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Tensors or numpy arrays under the reference's names."""
        return super().load_state_dict(tensor_state_dict(state_dict), strict,
                                       assign)

    @classmethod
    def from_state_dict(cls, state_dict, device=None) -> "BiSeNet":
        """A BiSeNet with as many classes as ``state_dict``'s output
        head, holding its weights, in eval mode without gradients."""
        sd = tensor_state_dict(state_dict)
        net = cls(sd["conv_out.conv_out.weight"].shape[0], device=device)
        net.load_state_dict(sd)
        return net.eval().requires_grad_(False)


def init_bisenet(seed, n_classes: int = N_CLASSES) -> Dict[str, np.ndarray]:
    """Random weights with the exact state-dict structure, drawn from
    ``np.random.RandomState(seed)`` (or the RandomState given) in the JAX
    package's order: an int seed gives the draws the JAX ``init_bisenet``
    makes where its key maps to that int."""
    rng = (seed if isinstance(seed, np.random.RandomState)
           else np.random.RandomState(seed))
    params: Dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k, bias=False):
        fan = cin * k * k
        params[f"{name}.weight"] = (
            rng.randn(cout, cin, k, k).astype(np.float32) * (2.0 / fan) ** 0.5
        )
        if bias:
            params[f"{name}.bias"] = np.zeros(cout, np.float32)

    def bn(name, c):
        params[f"{name}.weight"] = np.abs(rng.randn(c).astype(np.float32)) + 0.5
        params[f"{name}.bias"] = rng.randn(c).astype(np.float32) * 0.1
        params[f"{name}.running_mean"] = rng.randn(c).astype(np.float32) * 0.1
        params[f"{name}.running_var"] = (
            np.abs(rng.randn(c).astype(np.float32)) + 0.5
        )

    def cbr(name, cin, cout, k):
        conv(f"{name}.conv", cin, cout, k)
        bn(f"{name}.bn", cout)

    def block(name, cin, cout, stride):
        conv(f"{name}.conv1", cin, cout, 3)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        bn(f"{name}.bn2", cout)
        if cin != cout or stride != 1:
            conv(f"{name}.downsample.0", cin, cout, 1)
            bn(f"{name}.downsample.1", cout)

    r = "cp.resnet"
    conv(f"{r}.conv1", 3, 64, 7)
    bn(f"{r}.bn1", 64)
    for i, (cin, cout, s) in enumerate(
        [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)], start=1
    ):
        block(f"{r}.layer{i}.0", cin, cout, s)
        block(f"{r}.layer{i}.1", cout, cout, 1)

    for name, cin, cout in (("cp.arm16", 256, 128), ("cp.arm32", 512, 128)):
        cbr(f"{name}.conv", cin, cout, 3)
        conv(f"{name}.conv_atten", cout, cout, 1)
        bn(f"{name}.bn_atten", cout)
    cbr("cp.conv_head32", 128, 128, 3)
    cbr("cp.conv_head16", 128, 128, 3)
    cbr("cp.conv_avg", 512, 128, 1)

    cbr("ffm.convblk", 256, 256, 1)
    conv("ffm.conv1", 256, 64, 1)
    conv("ffm.conv2", 64, 256, 1)

    for name, cin, mid in (("conv_out", 256, 256), ("conv_out16", 128, 64),
                           ("conv_out32", 128, 64)):
        cbr(f"{name}.conv", cin, mid, 3)
        conv(f"{name}.conv_out", mid, n_classes, 1)
    return params


@torch.no_grad()
def parse_logits(net: BiSeNet, image: np.ndarray,
                 infer_size: Optional[int] = None) -> torch.Tensor:
    """(H, W, 3) uint8 -> the main head's (19, S, S) logits at the
    inference size S (``INFER_SIZE`` by default) on the net's device:
    the resize is ``jax.image.resize``'s "linear" (antialiased where it
    shrinks), then ImageNet normalization (test.py:62-97)."""
    size = INFER_SIZE if infer_size is None else infer_size
    dev = next(net.parameters()).device
    x = torch.from_numpy(np.asarray(image, np.float32)).to(dev) / 255.0
    x = resize_linear(x, (size, size))
    x = (x - torch.from_numpy(_MEAN).to(dev)) / torch.from_numpy(_STD).to(dev)
    return net(x.permute(2, 0, 1)[None])[0][0]


def parse_image(net: BiSeNet, image: np.ndarray,
                infer_size: Optional[int] = None) -> np.ndarray:
    """Full inference protocol (test.py:62-97): ``parse_logits``, the
    argmax (the first of equal maxima) -> (H, W) int class map at the
    original size (nearest upsample, as the reference's cv2 resize)."""
    size = INFER_SIZE if infer_size is None else infer_size
    H, W = image.shape[0], image.shape[1]
    classes = torch.argmax(parse_logits(net, image, size), dim=0).int()
    dev = classes.device

    def idx(n):
        pos = torch.arange(n, dtype=torch.float32, device=dev)
        return torch.floor(pos * (size / n)).long()

    return classes[idx(H)][:, idx(W)].cpu().numpy()
