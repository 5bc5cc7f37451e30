from idealnerf_tpu_torch.core.composite import raw2outputs
from idealnerf_tpu_torch.core.embedding import pe_dim, positional_encoding
from idealnerf_tpu_torch.core.rays import get_rays, ndc_rays
from idealnerf_tpu_torch.core.render import RenderConfig, render_rays
from idealnerf_tpu_torch.core.sampling import sample_pdf, stratified_sample

__all__ = [
    "RenderConfig", "get_rays", "ndc_rays", "pe_dim", "positional_encoding",
    "raw2outputs", "render_rays", "sample_pdf", "stratified_sample",
]
