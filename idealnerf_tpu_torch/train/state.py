"""Model parameters for the head model (counterpart of the parameter part
of train/state.py's ``init_train_state``; the optimizer comes with the
training slice)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.audio_net import (
    AudioAttNet, AudioNet, DeepSpeechAudNet,
)
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF
from idealnerf_tpu_torch.models.variants import variant_nerf_config


class ModelState(NamedTuple):
    step: int                    # global training step of the weights
    params: nn.ModuleDict        # coarse/fine/aud_net/aud_att/ds_aud
    latent_codes: torch.Tensor   # (data_size, max(dim_latent, 1))


def init_params(cfg, data_size: int,
                generator: Optional[torch.Generator] = None,
                device=None) -> ModelState:
    """The parameter tree ``init_train_state`` builds, freshly initialised
    from ``generator`` (xavier-uniform, bias 0.01), latent codes all ones."""
    nerf_cfg = variant_nerf_config(cfg)
    params = nn.ModuleDict({
        "coarse": FaceNeRF(nerf_cfg, generator, device),
        "fine": FaceNeRF(nerf_cfg, generator, device),
        "aud_net": AudioNet(cfg.dim_aud, cfg.win_size, generator, device),
        "aud_att": AudioAttNet(cfg.dim_aud, cfg.smo_size, generator, device),
        "ds_aud": DeepSpeechAudNet(cfg.win_size, generator, device),
    })
    # dim_latent=0 keeps a 1-wide dummy table, as the JAX package does
    latent = torch.ones((data_size, max(cfg.dim_latent, 1)),
                        dtype=torch.float32, device=device)
    return ModelState(step=0, params=params, latent_codes=latent)
