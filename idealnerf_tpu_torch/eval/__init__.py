from idealnerf_tpu_torch.eval.metrics import lpips, psnr, ssim
from idealnerf_tpu_torch.eval.operating_points import (
    AGREEMENT_DB, DIL_CARD, FIXED_CARD, GATE_DB, TEMPORAL_EVIDENCE_FILES,
    cost_constants, fit_delta_cost, gated_video_config,
    load_temporal_evidence, mode_cost, mode_key, parse_mode_key,
    pick_masked_point, pick_quality_matched_rung,
    pick_temporal_mode_configs, pick_temporal_points,
)
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

__all__ = ["AGREEMENT_DB", "DIL_CARD", "FIXED_CARD", "GATE_DB",
           "TEMPORAL_EVIDENCE_FILES", "TemporalStream", "VideoWriter",
           "cost_constants", "dilate_bands", "fg_band", "fit_delta_cost",
           "foreground_prior", "foreground_prior_fields",
           "gated_video_config", "load_temporal_evidence", "lpips",
           "make_frame_renderer", "make_temporal_composite_renderer",
           "make_temporal_frame_renderer", "mode_cost", "mode_key",
           "parse_mode_key", "pick_masked_point",
           "pick_quality_matched_rung", "pick_temporal_mode_configs",
           "pick_temporal_points", "psnr", "read_avi_frames", "read_png",
           "render_frame", "render_frame_outputs", "ssim", "write_png"]
