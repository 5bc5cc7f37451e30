"""Offline pipeline steps (counterpart of pipeline/process.py, which is
numpy: this is a copy, not an import; reference:
data_util/process_data.py).

- ``parse_color_map``: BiSeNet 19-class map -> the reference's color
  coding (red=face classes 1-13 & 17+, green=hair 14-15, blue=torso 16,
  white=background — face_parsing/test.py:41-57). The segmentation net
  is ``pipeline/parsing_net.py``.
- ``extract_background_plate``: the KNN background-plate estimation
  (process_data.py:143-184) — for each sampled frame, distance of every
  pixel to the nearest head pixel (done with a distance transform instead
  of a per-frame KD-tree); pixels > 5 px from the head in all frames form
  the plate, taken from the frame where they are farthest; remaining holes
  are filled from the nearest plate pixel.
- ``decouple_images``: com_imgs (background replaced by the plate) and
  head_imgs (everything but the head replaced) — process_data.py:188-215.
- ``write_transforms``: transforms_exp_{train,val}.json with inverted
  poses, lms-derived face_rects, exp coefficients, 10/11 split, and the
  per-id config files with near/far = mean_z ∓ (0.2, 0.4)
  (process_data.py:231-327).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

FACE_COLOR = np.array([255, 0, 0], np.uint8)
HAIR_COLOR = np.array([0, 255, 0], np.uint8)
TORSO_COLOR = np.array([0, 0, 255], np.uint8)
BG_COLOR = np.array([255, 255, 255], np.uint8)


def parse_color_map(class_map: np.ndarray) -> np.ndarray:
    """(H, W) int class ids -> (H, W, 3) reference color coding."""
    out = np.broadcast_to(BG_COLOR, class_map.shape + (3,)).copy()
    face = ((class_map >= 1) & (class_map <= 13)) | (class_map >= 17)
    out[face] = FACE_COLOR
    out[(class_map == 14) | (class_map == 15)] = HAIR_COLOR
    out[class_map == 16] = TORSO_COLOR
    return out


def head_mask_from_parse(parse_img: np.ndarray) -> np.ndarray:
    """Red (face) pixels of a parse color image."""
    return (
        (parse_img[:, :, 0] == 255)
        & (parse_img[:, :, 1] == 0)
        & (parse_img[:, :, 2] == 0)
    )


def extract_background_plate(
    images: np.ndarray,       # (N, H, W, 3) uint8 sampled frames
    head_masks: np.ndarray,   # (N, H, W) bool head pixels per frame
    dist_thresh: float = 5.0,
) -> np.ndarray:
    """(H, W, 3) uint8 static background plate."""
    from scipy.ndimage import distance_transform_edt

    n, h, w = head_masks.shape
    dists = np.stack([
        distance_transform_edt(~head_masks[i]) for i in range(n)
    ])  # distance to nearest head pixel, per frame
    max_dist = dists.max(0)
    max_id = dists.argmax(0)

    plate = np.zeros((h, w, 3), np.uint8)
    bc = max_dist > dist_thresh
    ys, xs = np.nonzero(bc)
    plate[ys, xs] = images[max_id[ys, xs], ys, xs]

    # hole fill: nearest confident-plate pixel
    _, (iy, ix) = distance_transform_edt(~bc, return_indices=True)
    hy, hx = np.nonzero(~bc)
    plate[hy, hx] = plate[iy[hy, hx], ix[hy, hx]]
    return plate


def decouple_images(
    image: np.ndarray,      # (H, W, 3) uint8 original frame
    parse_img: np.ndarray,  # (H, W, 3) parse color image
    plate: np.ndarray,      # (H, W, 3) background plate
):
    """-> (com_img, head_img) per process_data.py:188-215."""
    head = head_mask_from_parse(parse_img)
    bg = (
        (parse_img[:, :, 0] == 255)
        & (parse_img[:, :, 1] == 255)
        & (parse_img[:, :, 2] == 255)
    )
    com = image.copy()
    com[bg] = plate[bg]
    head_img = com.copy()
    head_img[~head] = plate[~head]
    return com, head_img


def face_rect_from_landmarks(lms: np.ndarray, h: int, w: int) -> np.ndarray:
    """(x, y, w, h) int32 rect per the reference's landmark geometry
    (process_data.py:269-283): width 1.5× the half-face span around the
    landmark centroid x, height 1.15× nose-bridge(27) to chin(8)."""
    min_x, max_x = np.min(lms, 0)[0], np.max(lms, 0)[0]
    cx = int((min_x + max_x) / 2.0)
    cy = int(lms[27, 1])
    h_w = int((max_x - cx) * 1.5)
    h_h = int((lms[8, 1] - cy) * 1.15)
    rect_x = max(cx - h_w, 0)
    rect_y = max(cy - h_h, 0)
    rect_w = min(w - 1 - rect_x, 2 * h_w)
    rect_h = min(h - 1 - rect_y, 2 * h_h)
    return np.array((rect_x, rect_y, rect_w, rect_h), np.int32)


def write_transforms(
    out_dir: str,
    img_ids: Sequence[int],
    euler: np.ndarray,        # (N, 3) tracker euler angles
    trans: np.ndarray,        # (N, 3) tracker translations (already /10)
    exps: np.ndarray,         # (N, dim_expr)
    landmarks: Dict[int, np.ndarray],  # img_id -> (68, 2)
    focal: float,
    h: int,
    w: int,
    subject: Optional[str] = None,
) -> Dict[str, str]:
    """Write transforms_exp_{train,val}.json (+ the HeadNeRF/TorsoNeRF
    config .txt files when ``subject`` is given). Poses are the INVERSE of
    the tracker extrinsics: R_inv = Rᵀ, t_inv = -Rᵀ t
    (process_data.py:244-267); near/far derive from mean head depth."""
    from idealnerf_tpu_torch.pipeline.tracking.geometry import euler2rot_np

    os.makedirs(out_dir, exist_ok=True)
    n = len(img_ids)
    rot = euler2rot_np(euler)
    rot_inv = rot.transpose(0, 2, 1)
    trans_inv = -np.einsum("nij,nj->ni", rot_inv, trans)
    mean_z = -float(np.mean(trans[:, 2]))

    split = int(n * 10 / 11)
    written = {}
    for name, ids in (("train", range(split)), ("val", range(split, n))):
        frames = []
        for i in ids:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot_inv[i]
            pose[:3, 3] = trans_inv[i]
            lms = landmarks[img_ids[i]]
            frames.append({
                "img_id": int(img_ids[i]),
                "aud_id": int(img_ids[i]),
                "transform_matrix": pose.tolist(),
                "face_rect": face_rect_from_landmarks(lms, h, w).tolist(),
                "exp": np.asarray(exps[i]).tolist(),
            })
        doc = {
            "focal_len": float(focal),
            "cx": float(w / 2.0),
            "cy": float(h / 2.0),
            "frames": frames,
        }
        path = os.path.join(out_dir, f"transforms_exp_{name}.json")
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, separators=(",", ": "))
        written[name] = path

    if subject is not None:
        testskip = max(int((n - split) / 7), 1)
        for cfg_name, expsuffix in (("HeadNeRF_config.txt", "_head"),
                                    ("TorsoNeRF_config.txt", "_com")):
            path = os.path.join(out_dir, cfg_name)
            with open(path, "w") as fh:
                fh.write(f"expname = {subject}{expsuffix}\n")
                fh.write(f"datadir = {out_dir}\n")
                fh.write(f"basedir = {os.path.join(out_dir, 'logs')}\n")
                fh.write(f"near = {mean_z - 0.2}\n")
                fh.write(f"far = {mean_z + 0.4}\n")
                fh.write(f"testskip = {testskip}\n")
            written[cfg_name] = path
    return written
