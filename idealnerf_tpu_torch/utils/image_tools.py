"""Dataset-surgery image tools (counterpart of utils/image_tools.py;
reference: utils/image_util/image_utils.py:11-145 — background blackout,
face crop, mouth-region visualization).

``crop_face`` resizes with ``resize_bilinear``, OpenCV's ``INTER_LINEAR``
written out in numpy: half-pixel centres, edge-clamped taps, no
antialiasing when it shrinks. OpenCV rounds its uint8 coefficients to
fixed point, so the two agree to within one level.
"""

from __future__ import annotations

import numpy as np

from idealnerf_tpu_torch.pipeline.process import head_mask_from_parse


def blackout_background(image: np.ndarray, parse_img: np.ndarray,
                        color=(0, 0, 0)) -> np.ndarray:
    """Replace non-head pixels with ``color`` (head = red parse pixels)."""
    out = image.copy()
    out[~head_mask_from_parse(parse_img)] = color
    return out


def _taps(n_out: int, n_in: int):
    """Per output index: the two source indices and the second's weight,
    src = (i + 0.5) * n_in / n_out - 0.5, clamped at both edges."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src)
    frac = src - lo
    lo = lo.astype(np.int64)
    frac = np.where(lo < 0, 0.0, frac)
    frac = np.where(lo >= n_in - 1, 0.0, frac)
    lo = np.clip(lo, 0, n_in - 1)
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize_bilinear(image: np.ndarray, size) -> np.ndarray:
    """(H, W[, C]) uint8 -> (size[0], size[1][, C]) uint8, bilinear with
    half-pixel centres and no antialiasing (cv2.INTER_LINEAR)."""
    r0, r1, fy = _taps(size[0], image.shape[0])
    c0, c1, fx = _taps(size[1], image.shape[1])
    img = image.astype(np.float64)
    fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    rows = img[r0] * (1.0 - fy) + img[r1] * fy
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    out = rows[:, c0] * (1.0 - fx) + rows[:, c1] * fx
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def crop_face(image: np.ndarray, face_rect, size: int = 256) -> np.ndarray:
    """Square face crop resized to ``size`` (second-stage preprocessing,
    get_data_second_stage.py:24-102)."""
    x, y, w, h = [int(v) for v in face_rect]
    H, W = image.shape[:2]
    side = max(w, h)
    cx, cy = x + w // 2, y + h // 2
    x0 = np.clip(cx - side // 2, 0, max(W - side, 0))
    y0 = np.clip(cy - side // 2, 0, max(H - side, 0))
    crop = image[y0 : y0 + side, x0 : x0 + side]
    return resize_bilinear(crop, (size, size))


def visualize_mouth_region(image: np.ndarray, landmarks: np.ndarray,
                           margin: int = 20) -> np.ndarray:
    """Draw the mouth sampling box (landmarks 48+ ± margin) used by the
    ray-budget sampler (audio_exp_nerf.py:137-140)."""
    out = image.copy()
    mouth = landmarks[48:]
    x0 = max(int(mouth[:, 0].min()) - margin, 0)
    x1 = min(int(mouth[:, 0].max()) + margin, image.shape[1] - 1)
    y0 = max(int(mouth[:, 1].min()) - margin, 0)
    y1 = min(int(mouth[:, 1].max()) + margin, image.shape[0] - 1)
    out[y0, x0:x1] = [255, 0, 0]
    out[y1, x0:x1] = [255, 0, 0]
    out[y0:y1, x0] = [255, 0, 0]
    out[y0:y1, x1] = [255, 0, 0]
    return out
