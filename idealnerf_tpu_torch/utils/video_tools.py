"""Frame and video conversion (counterpart of utils/video_tools.py):
``images_to_video`` muxes JPEG or PNG frames into the MJPG .avi of
eval/video.py, ``video_to_images`` extracts a video's frames as
``{i}.jpg``: an MJPG .avi by eval/video.py's reader, any other container
or codec through an ``ffmpeg`` binary on ``PATH`` (the reference's own
step 1, data_util/process_data.py:88-100), and without one it raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess
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


def _ffmpeg_frames(video_path: str, out_dir: str,
                   max_frames: Optional[int],
                   reader_error: Optional[ValueError] = None) -> int:
    """Frames of any container through ffmpeg as ``{i}.jpg`` from 0. Where
    the MJPG reader refused the file first, ``reader_error`` says why, and
    without ffmpeg it is named and chained."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        why = ("not an MJPG .avi" if reader_error is None
               else f"the MJPG reader refused it ({reader_error})")
        raise RuntimeError(
            f"{video_path}: {why}, and there is no ffmpeg binary on PATH "
            "to extract its frames") from reader_error
    os.makedirs(out_dir, exist_ok=True)
    cmd = [ffmpeg, "-nostdin", "-loglevel", "error", "-i", video_path]
    if max_frames is not None:
        cmd += ["-frames:v", str(max_frames)]
    cmd += ["-qmin", "1", "-q:v", "1", "-start_number", "0",
            os.path.join(out_dir, "%d.jpg")]
    subprocess.run(cmd, check=True)
    return sum(1 for f in os.listdir(out_dir) if f.endswith(".jpg"))


def video_to_images(video_path: str, out_dir: str,
                    max_frames: Optional[int] = None) -> int:
    """Extract a video's frames as ``{i}.jpg`` -> the count written. An
    MJPG .avi is read here; anything else goes through ffmpeg."""
    reader_error = None
    if os.path.splitext(video_path)[1].lower() == ".avi":
        try:
            frames, _ = read_avi_frames(video_path)
        except ValueError as exc:
            reader_error = exc    # another codec in an AVI: ffmpeg's job
        else:
            if max_frames is not None:
                frames = frames[:max_frames]
            os.makedirs(out_dir, exist_ok=True)
            for i, f in enumerate(frames):
                write_jpeg(os.path.join(out_dir, f"{i}.jpg"), f)
            return len(frames)
    return _ffmpeg_frames(video_path, out_dir, max_frames, reader_error)
