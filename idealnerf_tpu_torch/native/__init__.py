"""Host-side native code of the port, built with g++ at first use.

``png_filter.cpp`` undoes PNG row filters for ``eval.video.read_png``. It
is compiled into ``native/build/`` (not committed), named by a hash of the
source and flags, so a changed source rebuilds and an unchanged one loads
the cached file. A missing compiler or a failed build raises; nothing
falls back. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "png_filter.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libpng_filter_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; -> its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) on PATH to build {SRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC} failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.png_filter_version.argtypes = []
    lib.png_filter_version.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def png_unfilter(raw: bytes, h: int, w: int, channels: int,
                 name: str = "<png>") -> np.ndarray:
    """h rows of a filter byte + w * channels bytes -> (h, w, channels)
    uint8. An unknown filter type raises, naming ``name`` and the row."""
    if len(raw) != h * (1 + w * channels):
        raise ValueError(f"{name}: {len(raw)} bytes for {h} rows of "
                         f"{w}x{channels}")
    out = np.empty((h, w, channels), np.uint8)
    bad = load_library().png_unfilter(raw, h, w * channels, channels,
                                      out.ctypes.data)
    if bad >= 0:
        raise ValueError(f"{name}: row {bad} has filter type "
                         f"{raw[bad * (1 + w * channels)]}, not 0-4")
    return out
