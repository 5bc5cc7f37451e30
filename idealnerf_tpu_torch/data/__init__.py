from idealnerf_tpu_torch.data.dataset import FrameDataset
from idealnerf_tpu_torch.data.sampler import (
    RayBudget, rays_at_coords, sample_ray_coords,
)
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["FrameDataset", "RayBudget", "make_synthetic_dataset",
           "rays_at_coords", "sample_ray_coords"]
