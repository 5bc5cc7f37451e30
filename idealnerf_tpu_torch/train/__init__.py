from idealnerf_tpu_torch.train.head import compute_aud_feature
from idealnerf_tpu_torch.train.state import ModelState, init_params

__all__ = ["ModelState", "compute_aud_feature", "init_params"]
