"""Dataset container + transforms_exp_*.json loader (counterpart of
data/dataset.py).

Host-side numpy arrays; ``to_device(device)`` yields the torch tensors the
renderer and trainers index by frame id. ``load_transforms_dataset`` reads
a reference-format subject directory: ``transforms_exp_{train,val}.json``
holds focal_len/cx/cy and per-frame img_id/aud_id/transform_matrix/
face_rect/exp; ``aud.npy`` holds (M, 16, 29) DeepSpeech windows; ``bc.jpg``
is the static background plate; images live in ``gt_dirs``
(head_imgs/ori_imgs/com_imgs); mouth boxes come from the 48+ landmarks in
``ori_imgs/*.lms``; torso masks from the pure red of ``parsing/*.png``.
Frames are decoded by data/jpeg.py's thread pool into one buffer, the
parse maps by eval/video.read_png.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from idealnerf_tpu_torch.data.jpeg import (
    decode_jpeg_batch, jpeg_size, read_jpeg,
)


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


def _bounds_from_config(datadir: str, near, far):
    """near/far of the subject's HeadNeRF_config.txt where not given (the
    transforms json carries none)."""
    cfg_path = os.path.join(datadir, "HeadNeRF_config.txt")
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            for line in fh:
                k, _, v = line.partition("=")
                k = k.strip()
                if k == "near" and near is None:
                    near = float(v)
                elif k == "far" and far is None:
                    far = float(v)
    return near, far


def load_transforms_dataset(
    datadir: str,
    mode: str = "train",
    aud_file: str = "aud.npy",
    gt_dirs: str = "head_imgs",
    skip: int = 1,
    near: Optional[float] = None,
    far: Optional[float] = None,
    max_frames: Optional[int] = None,
) -> FrameDataset:
    """Load a reference-format subject directory (see module docstring).

    ``skip`` mirrors the testskip subsampling of val sets; near/far default
    to the subject's HeadNeRF_config.txt, then 0.3/0.9."""
    from idealnerf_tpu_torch.eval.video import read_png

    with open(os.path.join(datadir, f"transforms_exp_{mode}.json")) as fh:
        meta = json.load(fh)
    if near is None or far is None:
        near, far = _bounds_from_config(datadir, near, far)

    auds = np.load(os.path.join(datadir, aud_file)).astype(np.float32)
    bc_img = read_jpeg(os.path.join(datadir, "bc.jpg"))
    frames = meta["frames"][::skip]
    if max_frames is not None:
        frames = frames[:max_frames]

    img_paths = [os.path.join(datadir, gt_dirs, f"{f['img_id']}.jpg")
                 for f in frames]
    images = decode_jpeg_batch(img_paths, *jpeg_size(img_paths[0]))

    poses, aud_ids, exprs, rects, mouth_boxes, landmarks, torso_masks = (
        [], [], [], [], [], [], [])
    for frame in frames:
        img_id = frame["img_id"]
        poses.append(np.array(frame["transform_matrix"], np.float32)[:3, :4])
        aud_ids.append(min(int(frame["aud_id"]), auds.shape[0] - 1))
        exprs.append(np.array(frame["exp"], np.float32))
        rects.append(np.array(frame["face_rect"], np.int32))
        lms = np.loadtxt(os.path.join(datadir, "ori_imgs", f"{img_id}.lms"))
        landmarks.append(lms[:68].astype(np.float32))
        mouth = lms[48:]
        mouth_boxes.append(np.array(
            [mouth[:, 0].min() - 20, mouth[:, 0].max() + 20,
             mouth[:, 1].min() - 20, mouth[:, 1].max() + 20], np.float32))
        parse = read_png(os.path.join(datadir, "parsing", f"{img_id}.png"))
        torso = ((parse[:, :, 0] == 255) & (parse[:, :, 1] == 0)
                 & (parse[:, :, 2] == 0))
        torso_masks.append(torso.astype(np.uint8))

    return FrameDataset(
        images=images,
        poses=np.stack(poses),
        auds=auds,
        aud_ids=np.array(aud_ids, np.int32),
        exprs=np.stack(exprs),
        face_rects=np.stack(rects),
        mouth_boxes=np.stack(mouth_boxes),
        landmarks=np.stack(landmarks),
        torso_masks=np.stack(torso_masks),
        bc_img=bc_img,
        focal=float(meta["focal_len"]),
        cx=float(meta["cx"]),
        cy=float(meta["cy"]),
        near=0.3 if near is None else near,
        far=0.9 if far is None else far,
    )
