"""Dataset container (counterpart of data/dataset.py).

Host-side numpy arrays; ``to_device(device)`` yields the torch tensors the
renderer and trainers index by frame id. The ``transforms_exp_*.json``
loader waits for a later slice: it decodes images through imageio, which
the card's machine does not provide.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FrameDataset:
    images: np.ndarray       # (N, H, W, 3) uint8
    poses: np.ndarray        # (N, 3, 4) float32 camera-to-world
    auds: np.ndarray         # (M, 16, 29) float32 DeepSpeech windows
    aud_ids: np.ndarray      # (N,) int32 index into auds
    exprs: np.ndarray        # (N, dim_expr) float32
    face_rects: np.ndarray   # (N, 4) int32 [x, y, w, h]
    mouth_boxes: np.ndarray  # (N, 4) float32 [min_x, max_x, min_y, max_y]
    landmarks: np.ndarray    # (N, 68, 2) float32 (x, y) as stored in .lms
    torso_masks: np.ndarray  # (N, H, W) uint8 {0,1}
    bc_img: np.ndarray       # (H, W, 3) uint8 background plate
    focal: float
    cx: float
    cy: float
    near: float = 0.3
    far: float = 0.9

    @property
    def size(self) -> int:
        return self.images.shape[0]

    @property
    def hw(self):
        return self.images.shape[1], self.images.shape[2]

    def to_device(self, device) -> dict:
        names = ("images", "poses", "auds", "aud_ids", "exprs", "face_rects",
                 "mouth_boxes", "landmarks", "torso_masks", "bc_img")
        out = {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k)))
               .to(device) for k in names}
        out["aud_ids"] = out["aud_ids"].long()
        return out
