from idealnerf_tpu_torch.data.dataset import (
    FrameDataset, load_transforms_dataset,
)
from idealnerf_tpu_torch.data.export import write_reference_format
from idealnerf_tpu_torch.data.sampler import (
    RayBudget, rays_at_coords, sample_ray_coords,
)
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["FrameDataset", "RayBudget", "load_transforms_dataset",
           "make_synthetic_dataset", "rays_at_coords", "sample_ray_coords",
           "write_reference_format"]
