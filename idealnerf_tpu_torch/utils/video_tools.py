"""Frame and video conversion (counterpart of utils/video_tools.py):
``images_to_video`` muxes JPEG or PNG frames into the MJPG .avi of
eval/video.py, ``video_to_images`` extracts such a file's frames as
``{i}.jpg``. Other containers and codecs need the offline pipeline's
decoder, which is not ported (ROADMAP.md A12).
"""

from __future__ import annotations

import os
from typing import List, Optional

from idealnerf_tpu_torch.data.jpeg import read_jpeg, write_jpeg
from idealnerf_tpu_torch.eval.video import (
    VideoWriter, read_avi_frames, read_png,
)


def images_to_video(image_paths: List[str], out_path: str,
                    fps: int = 25) -> int:
    """Mux ordered .jpg/.png frames into an MJPG .avi -> the frame count."""
    with VideoWriter(out_path, fps=fps, frame_jpg_every=0) as w:
        for p in image_paths:
            ext = os.path.splitext(p)[1].lower()
            if ext in (".jpg", ".jpeg"):
                w.add(read_jpeg(p))
            elif ext == ".png":
                img = read_png(p)
                if img.ndim != 3 or img.shape[2] not in (3, 4):
                    raise ValueError(f"{p}: not an RGB or RGBA PNG")
                w.add(img[:, :, :3])
            else:
                raise ValueError(f"{p}: frames must be .jpg or .png")
    return len(image_paths)


def video_to_images(video_path: str, out_dir: str,
                    max_frames: Optional[int] = None) -> int:
    """Extract an MJPG .avi's frames as ``{i}.jpg`` -> the count written.
    Any other container raises."""
    if os.path.splitext(video_path)[1].lower() != ".avi":
        raise NotImplementedError(
            f"{video_path}: only MJPG .avi files are read; other containers "
            "need the offline pipeline's decoder, not ported yet "
            "(ROADMAP.md A12)")
    try:
        frames, _ = read_avi_frames(video_path)
    except ValueError as exc:
        raise NotImplementedError(
            f"{exc}; other codecs need the offline pipeline's decoder, not "
            "ported yet (ROADMAP.md A12)") from exc
    if max_frames is not None:
        frames = frames[:max_frames]
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        write_jpeg(os.path.join(out_dir, f"{i}.jpg"), f)
    return len(frames)
