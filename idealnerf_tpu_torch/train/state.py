"""Train state: model parameters + per-frame latent codes + Adam
(counterpart of train/state.py).

One Adam over the network parameters and the learned (data_size,
dim_latent) latent table (latent codes start at ones), betas (0.9, 0.999),
eps 1e-8, with the exponential decay of train/schedule.py. The JAX
package's flat-vector Adam and its checkpoint layout migration have no
counterpart: torch.optim.Adam updates per tensor already.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.audio_net import (
    AudioAttNet, AudioNet, DeepSpeechAudNet,
)
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF
from idealnerf_tpu_torch.models.variants import (
    init_variant_extras, variant_nerf_config,
)


class ModelState(NamedTuple):
    step: int                    # global training step of the weights
    params: nn.ModuleDict        # coarse/fine/aud_net/aud_att/ds_aud[+extras]
    latent_codes: torch.Tensor   # (data_size, max(dim_latent, 1))


def init_params(cfg, data_size: int,
                generator: Optional[torch.Generator] = None,
                device=None) -> ModelState:
    """The parameter tree ``init_train_state`` builds, freshly initialised
    from ``generator`` (xavier-uniform, bias 0.01), latent codes all ones;
    with the variant's extras ("agg" or "self_att") beside the nets."""
    nerf_cfg = variant_nerf_config(cfg)
    params = nn.ModuleDict({
        "coarse": FaceNeRF(nerf_cfg, generator, device),
        "fine": FaceNeRF(nerf_cfg, generator, device),
        "aud_net": AudioNet(cfg.dim_aud, cfg.win_size, generator, device),
        "aud_att": AudioAttNet(cfg.dim_aud, cfg.smo_size, generator, device),
        "ds_aud": DeepSpeechAudNet(cfg.win_size, generator, device),
    })
    params.update(init_variant_extras(cfg, generator, device))
    # dim_latent=0 keeps a 1-wide dummy table, as the JAX package does
    latent = torch.ones((data_size, max(cfg.dim_latent, 1)),
                        dtype=torch.float32, device=device)
    return ModelState(step=0, params=params, latent_codes=latent)


@dataclasses.dataclass
class TrainState:
    step: int                        # updates made so far
    params: nn.ModuleDict
    latent_codes: nn.Parameter       # (data_size, max(dim_latent, 1))
    optimizer: torch.optim.Optimizer

    def trainable(self) -> List[torch.Tensor]:
        return [*self.params.parameters(), self.latent_codes]


def make_optimizer(cfg, params: nn.Module,
                   latent_codes: torch.Tensor) -> torch.optim.Adam:
    """Adam over the parameters and the latent table. The trainer sets the
    rate of each update from train.schedule.exponential_lr at the step
    before that update, as optax's schedule does."""
    return torch.optim.Adam([*params.parameters(), latent_codes],
                            lr=cfg.lrate, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(cfg, data_size: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Fresh weights drawn on the host from ``generator`` (so a seed gives
    the same model on every device), moved to ``device``, plus Adam."""
    st = init_params(cfg, data_size, generator)
    params = st.params.to(device)
    latent = nn.Parameter(st.latent_codes.to(device))
    return TrainState(step=0, params=params, latent_codes=latent,
                      optimizer=make_optimizer(cfg, params, latent))
