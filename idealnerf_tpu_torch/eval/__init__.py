from idealnerf_tpu_torch.eval.metrics import psnr, ssim
from idealnerf_tpu_torch.eval.renderer import make_frame_renderer
from idealnerf_tpu_torch.eval.video import FrameWriter, write_png

__all__ = ["FrameWriter", "make_frame_renderer", "psnr", "ssim", "write_png"]
