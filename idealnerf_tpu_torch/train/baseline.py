"""AD-NeRF baseline trainer (counterpart of train/baseline.py).

Differences from the paper head trainer, as the reference's baseline:
- audio conditioning only (dim_expr = dim_latent = 0);
- one random train frame per step instead of sequential epochs;
- the central-crop ray warm-up for the first precrop_iters steps;
- rect-stratified sampling at sample_rate, no mouth or torso budgets.

One Adam over the union of the nets replaces the reference's three at the
same rate: Adam's state is per parameter, so the update is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from idealnerf_tpu_torch.train.head import HeadTrainer


def baseline_config(cfg):
    """The baseline's conditioning: audio only."""
    return dataclasses.replace(cfg, dim_expr=0, dim_latent=0, mouth_rays=0,
                               torso_rays=0, model_variant="face_nerf")


class BaselineTrainer(HeadTrainer):
    def __init__(self, cfg, dataset, seed: int = 0,
                 ckpt_dir: Optional[str] = None, resume: bool = True,
                 device="cpu"):
        super().__init__(baseline_config(cfg), dataset, seed=seed,
                         ckpt_dir=ckpt_dir, resume=resume, device=device)

    def run(self, n_epochs=None, log_every=None, on_metrics=None,
            frame_order: str = "random"):
        return super().run(n_epochs=n_epochs, log_every=log_every,
                           on_metrics=on_metrics, frame_order=frame_order)
