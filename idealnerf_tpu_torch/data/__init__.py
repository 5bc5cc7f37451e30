from idealnerf_tpu_torch.data.dataset import FrameDataset
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["FrameDataset", "make_synthetic_dataset"]
