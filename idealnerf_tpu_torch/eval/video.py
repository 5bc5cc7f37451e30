"""Frame output (counterpart of eval/video.py, frames only).

Frames are written as 8-bit RGB PNGs with the standard library (zlib +
struct), so no image package is needed. The 25 fps .avi of the JAX
package waits for a later slice.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x, np.float32), 0, 1)).astype(np.uint8)


def write_png(path: str, img) -> None:
    """img: (H, W, 3) uint8 RGB, or float in [0, 1]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to8b(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    h, w, _ = img.shape
    # each scanline starts with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)


class FrameWriter:
    """Writes each added frame as ``{stem}_{index:05d}.png``."""

    def __init__(self, stem: str):
        self.stem = stem
        self.paths = []
        os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)

    def add(self, frame) -> str:
        path = f"{self.stem}_{len(self.paths):05d}.png"
        write_png(path, frame)
        self.paths.append(path)
        return path
