from idealnerf_tpu_torch.eval.metrics import psnr, ssim
from idealnerf_tpu_torch.eval.renderer import (
    foreground_prior, foreground_prior_fields, make_frame_renderer,
    render_frame, render_frame_outputs,
)
from idealnerf_tpu_torch.eval.stream import TemporalStream
from idealnerf_tpu_torch.eval.temporal import (
    dilate_bands, fg_band, make_temporal_composite_renderer,
    make_temporal_frame_renderer,
)
from idealnerf_tpu_torch.eval.video import (
    VideoWriter, read_avi_frames, read_png, write_png,
)

__all__ = ["TemporalStream", "VideoWriter", "dilate_bands", "fg_band",
           "foreground_prior", "foreground_prior_fields",
           "make_frame_renderer", "make_temporal_composite_renderer",
           "make_temporal_frame_renderer", "psnr", "read_avi_frames",
           "read_png", "render_frame", "render_frame_outputs", "ssim",
           "write_png"]
