"""JPEG frames through Pillow (counterpart of data/native_loader.py and
native/frameloader.cpp).

The card's machine has no libjpeg headers or library, but Pillow imports
there and carries its own libjpeg-turbo; the JAX package reads the same
files through imageio, which is Pillow. Pillow releases the interpreter
lock while it decodes, so a thread pool decodes frames in parallel
straight into one preallocated (N, H, W, 3) buffer.

There is no fallback: a missing Pillow raises, naming it, and a file that
does not open, does not decode or has another size raises, naming the
file. Nothing here runs at import time.
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "the JPEG route is Pillow (PIL), which does not import here: "
            f"{exc}") from exc
    return Image


def library_version() -> str:
    """'Pillow <version>, libjpeg <API version> (libjpeg-turbo <version>)'
    of the JPEG route."""
    import PIL
    from PIL import features

    turbo = (f" (libjpeg-turbo {features.version_feature('libjpeg_turbo')})"
             if features.check_feature("libjpeg_turbo") else "")
    return (f"Pillow {PIL.__version__}, libjpeg {features.version('jpg')}"
            + turbo)


def _threads(n_threads: Optional[int]) -> int:
    return max(1, n_threads or min(os.cpu_count() or 1, 16))


def _decode(Image, src, name: str, hw=None) -> np.ndarray:
    """One JPEG (a path or a file object) -> (H, W, 3) uint8 RGB; with
    ``hw`` its size must be (h, w)."""
    try:
        with Image.open(src) as im:
            if im.format not in ("JPEG", "MPO"):
                raise ValueError(f"{name}: a {im.format} file, not a JPEG")
            if hw is not None and im.size != (hw[1], hw[0]):
                raise ValueError(f"{name}: {im.size[1]}x{im.size[0]} pixels, "
                                 f"expected {hw[0]}x{hw[1]}")
            return np.array(im if im.mode == "RGB" else im.convert("RGB"))
    except (OSError, SyntaxError) as exc:   # Pillow's unreadable-file errors
        raise ValueError(f"{name}: does not decode as a JPEG ({exc})") from exc


def jpeg_size(path: str) -> Tuple[int, int]:
    """(height, width) from the file's header."""
    Image = _pil()
    try:
        with Image.open(path) as im:
            return im.size[1], im.size[0]
    except (OSError, SyntaxError) as exc:
        raise ValueError(f"{path}: does not open as an image ({exc})") from exc


def _decode_all(pool, Image, paths, out, lo: int = 0) -> list:
    """Futures decoding ``paths`` into ``out[i - lo]``."""
    def one(i):
        out[i - lo] = _decode(Image, paths[i], paths[i], out.shape[1:3])

    return [pool.submit(one, i) for i in range(lo, lo + len(out))]


def decode_jpeg_batch(paths: List[str], h: int, w: int,
                      n_threads: Optional[int] = None) -> np.ndarray:
    """(N, h, w, 3) uint8 RGB, decoded by a pool of threads. A corrupt or
    missing file, or one of another size, raises ValueError naming it
    (the first of them in ``paths`` order)."""
    Image = _pil()
    out = np.empty((len(paths), h, w, 3), np.uint8)
    with ThreadPoolExecutor(_threads(n_threads)) as pool:
        for f in _decode_all(pool, Image, paths, out):
            f.result()
    return out


def stream_decode_chunks(paths: List[str], h: int, w: int, chunk: int = 256,
                         n_threads: Optional[int] = None,
                         ) -> Iterator[Tuple[int, np.ndarray]]:
    """Generator of ``(chunk_index, frames (n, h, w, 3) uint8)`` with
    double-buffered read-ahead: while the consumer stages chunk k, the
    pool already decodes chunk k+1 into the other buffer half. The yielded
    array is a VIEW of the ring buffer, valid only until the next
    iteration (copy to retain). Errors as ``decode_jpeg_batch``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    Image = _pil()
    n = len(paths)
    bufs = [np.empty((min(chunk, n), h, w, 3), np.uint8) for _ in range(2)]
    n_chunks = (n + chunk - 1) // chunk

    def submit(pool, c):
        lo = c * chunk
        return _decode_all(pool, Image, paths,
                           bufs[c & 1][:min(chunk, n - lo)], lo)

    with ThreadPoolExecutor(_threads(n_threads)) as pool:
        pending = submit(pool, 0) if n_chunks else []
        for c in range(n_chunks):
            for f in pending:
                f.result()
            # chunk c+1 fills the half that chunk c-1 used, which the
            # consumer released by asking for chunk c
            pending = submit(pool, c + 1) if c + 1 < n_chunks else []
            try:
                yield c, bufs[c & 1][:min(chunk, n - c * chunk)]
            except GeneratorExit:
                for f in pending:
                    f.cancel()
                raise


def read_jpeg(path: str) -> np.ndarray:
    """One JPEG file -> (H, W, 3) uint8 RGB."""
    return _decode(_pil(), path, path)


def decode_jpeg_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """One JPEG in memory -> (H, W, 3) uint8 RGB."""
    return _decode(_pil(), io.BytesIO(data), name)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes (4:2:0, the standard
    tables scaled to ``quality``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    buf = io.BytesIO()
    _pil().fromarray(np.ascontiguousarray(img)).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    data = encode_jpeg(img, quality)
    with open(path, "wb") as fh:
        fh.write(data)
