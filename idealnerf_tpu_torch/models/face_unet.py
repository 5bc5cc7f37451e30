"""FaceUNetCNN — a 4-down / 4-up conv UNet over the PE-embedded full
image, producing a (128 + embed_ln)-channel feature map for per-point
gathering (counterpart of models/face_unet.py; the GRF-style UNet path).

Encoder Conv2d(k7 s2 p2) then 3 x Conv2d(k3 s2 p1); decoder
ConvTranspose2d(k3 s2, dilation d = 1/2/4/8, padding d, output_padding 1)
with skip concats; a final replicate pad by 1, then the embedded-RGB
channels. The decoder weights are (in, out, k, k), the JAX package's
layout. The convolutions run in full f32 on the card (``ieee_convs``):
cuDNN would otherwise take TF32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

ENC = ((64, 7, 2), (128, 3, 1), (256, 3, 1), (512, 3, 1))  # out, k, pad
DEC = ((512, 256, 1), (512, 128, 2), (256, 64, 4), (128, 128, 8))


@contextlib.contextmanager
def ieee_convs():
    """cuDNN convolutions in f32 without TF32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _valid_size(n: int) -> int:
    """Smallest size >= n that the stage arithmetic returns exactly: every
    encoder stage must stay even for the skip concats, which holds for
    16k + 2 (450 = 16·28 + 2)."""
    return -(-(n - 2) // 16) * 16 + 2


class FaceUNet(nn.Module):
    def __init__(self, input_ch: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        enc, c = [], input_ch
        for out, k, pad in ENC:
            enc.append(nn.Conv2d(c, out, k, stride=2, padding=pad,
                                 device=device))
            c = out
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(
            nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=d,
                               output_padding=1, dilation=d, device=device)
            for cin, cout, d in DEC)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                    m.bias.fill_(0.01)

    def forward(self, x: torch.Tensor, embed_ln: int) -> torch.Tensor:
        """x (B, H, W, C_embed) -> (B, 128 + embed_ln, H, W). The first
        ``embed_ln`` input channels (the embedded RGB) go through to the
        output. Any H x W runs: the input is edge-padded up to the next
        stage-aligned size and the feature map cropped back."""
        H, W = x.shape[1], x.shape[2]
        Hp, Wp = _valid_size(H), _valid_size(W)
        h = x.permute(0, 3, 1, 2)
        embedded_rgb = h[:, :embed_ln]
        if (Hp, Wp) != (H, W):
            h = F.pad(h, (0, Wp - W, 0, Hp - H), mode="replicate")
        with ieee_convs():
            stack = []
            for conv in self.enc:
                h = torch.relu(conv(h))
                stack.append(h)
            stack.pop()
            for conv in self.dec:
                h = torch.relu(conv(h))
                if stack:
                    h = torch.cat([h, stack.pop()], dim=1)
        h = F.pad(h, (1, 1, 1, 1), mode="replicate")[:, :, :H, :W]
        return torch.cat([h, embedded_rgb], dim=1)
