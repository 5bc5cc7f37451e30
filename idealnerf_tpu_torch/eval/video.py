"""Frame and video files (counterpart of eval/video.py).

``VideoWriter`` writes the reference's eval video: a 25 fps MJPG stream in
a RIFF AVI container, laid out with ``struct`` (``hdrl`` with ``avih`` and
one ``strl`` of ``strh`` vids/MJPG and a BITMAPINFOHEADER ``strf``, a
``movi`` list of ``00dc`` chunks, an ``idx1`` index), with every
``frame_jpg_every``-th frame also written as ``<stem>_<i:05d>.jpg``.
``read_avi_frames`` reads such a file back. PNGs are written and read with
the standard library's zlib, the rows' filters undone in native code
(native/png_filter.cpp); JPEG goes through Pillow (data/jpeg.py).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

from idealnerf_tpu_torch.data import jpeg
from idealnerf_tpu_torch.native import png_unfilter


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x, np.float32), 0, 1)).astype(np.uint8)


def _rgb8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to8b(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    return np.ascontiguousarray(img)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # grey, RGB, RGBA


def write_png(path: str, img) -> None:
    """img: (H, W, 3) uint8 RGB, or float in [0, 1]."""
    img = _rgb8(img)
    h, w, _ = img.shape
    # each scanline starts with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                          1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (_PNG_SIG
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)


def read_png(path: str) -> np.ndarray:
    """An 8-bit grey, RGB or RGBA non-interlaced PNG -> (H, W) or
    (H, W, C) uint8. Any other kind raises, naming the file."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit grey/RGB/RGBA non-interlaced PNGs are read "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    c = _PNG_CHANNELS[color]
    img = png_unfilter(zlib.decompress(b"".join(idat)), h, w, c, path)
    return img[:, :, 0] if c == 1 else img


# ------------------------------------------------------------------ AVI

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
JPEG_QUALITY = 95     # cv2's MJPG default, the JAX writer's encoder


def _chunk_header(tag: bytes, size: int) -> bytes:
    return tag + struct.pack("<I", size)


class VideoWriter:
    """MJPG .avi writer; every ``frame_jpg_every``-th frame also goes to
    ``<stem>_<i:05d>.jpg`` (the reference writes every 10th). The headers
    are written with the first frame and their counts and sizes filled in
    by ``close``; use it as a context manager."""

    def __init__(self, path: str, fps: int = 25, frame_jpg_every: int = 10):
        self.path = path
        self.fps = fps
        self.frame_jpg_every = frame_jpg_every
        self.count = 0
        self._fh = None
        self._hw = None
        self._index: List[Tuple[int, int]] = []   # (offset in movi, size)
        self._max_chunk = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _header(self, frames: int) -> bytes:
        h, w = self._hw
        avih = struct.pack(
            "<14I", 1000000 // self.fps, 0, 0, _AVIF_HASINDEX, frames, 0, 1,
            self._max_chunk, w, h, 0, 0, 0, 0)
        strh = (b"vids" + b"MJPG"
                + struct.pack("<IHHIIIIIIII4h", 0, 0, 0, 0, 1, self.fps, 0,
                              frames, self._max_chunk, 0xFFFFFFFF, 0,
                              0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk_header(b"strh", len(strh)) + strh
                + _chunk_header(b"strf", len(strf)) + strf)
        hdrl = (b"hdrl" + _chunk_header(b"avih", len(avih)) + avih
                + _chunk_header(b"LIST", len(strl)) + strl)
        return _chunk_header(b"LIST", len(hdrl)) + hdrl

    def _open(self, h: int, w: int) -> None:
        self._hw = (h, w)
        self._fh = open(self.path, "wb")
        self._fh.write(_chunk_header(b"RIFF", 0) + b"AVI ")
        self._fh.write(self._header(0))
        self._movi = self._fh.tell()          # the movi LIST header
        self._fh.write(_chunk_header(b"LIST", 0) + b"movi")

    def add(self, frame) -> None:
        """frame: (H, W, 3) float in [0, 1] or uint8, RGB."""
        img = _rgb8(frame)
        if self._fh is None:
            self._open(img.shape[0], img.shape[1])
        elif img.shape[:2] != self._hw:
            raise ValueError(f"frame {self.count} is {img.shape[:2]}, the "
                             f"video {self._hw}")
        jpg = jpeg.encode_jpeg(img, JPEG_QUALITY)
        # idx1 offsets count from the 'movi' fourcc
        self._index.append((self._fh.tell() - (self._movi + 8), len(jpg)))
        self._fh.write(_chunk_header(b"00dc", len(jpg)) + jpg
                       + b"\0" * (len(jpg) & 1))
        self._max_chunk = max(self._max_chunk, len(jpg))
        if self.frame_jpg_every and self.count % self.frame_jpg_every == 0:
            stem, _ = os.path.splitext(self.path)
            with open(f"{stem}_{self.count:05d}.jpg", "wb") as fh:
                fh.write(jpg)
        self.count += 1

    def close(self) -> None:
        if self._fh is None:
            return
        fh, self._fh = self._fh, None
        try:
            end = fh.tell()
            idx = b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME,
                                       off, size)
                           for off, size in self._index)
            fh.write(_chunk_header(b"idx1", len(idx)) + idx)
            total = fh.tell()
            fh.seek(4)
            fh.write(struct.pack("<I", total - 8))
            fh.write(b"AVI " + self._header(self.count))
            fh.seek(self._movi + 4)
            fh.write(struct.pack("<I", end - self._movi - 8))
        finally:
            fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avi_frames(path: str) -> Tuple[np.ndarray, float]:
    """The frames (n, H, W, 3) uint8 RGB and the frame rate of an MJPG AVI
    as ``VideoWriter`` writes it."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    fps, jpgs = None, []

    def walk(start: int, end: int) -> None:
        nonlocal fps
        pos = start
        while pos + 8 <= end:
            tag = data[pos:pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
            body = pos + 8
            if body + size > end:
                raise ValueError(f"{path}: truncated {tag!r} chunk")
            if tag == b"LIST":
                walk(body + 4, body + size)
            elif tag == b"strh":
                if data[body + 4:body + 8] != b"MJPG":
                    raise ValueError(f"{path}: stream codec "
                                     f"{data[body + 4:body + 8]!r}, not MJPG")
                scale, rate = struct.unpack("<II", data[body + 20:body + 28])
                fps = rate / scale
            elif tag == b"00dc":
                jpgs.append(data[body:body + size])
            pos = body + size + (size & 1)

    walk(12, len(data))
    if fps is None:
        raise ValueError(f"{path}: no stream header")
    if not jpgs:
        return np.zeros((0, 0, 0, 3), np.uint8), fps
    return np.stack([jpeg.decode_jpeg_bytes(j) for j in jpgs]), fps
