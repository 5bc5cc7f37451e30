"""Initialisation and activation helpers (counterpart of models/nn.py).

Xavier-uniform weights and bias 0.01 for Linear and Conv1d, as the
reference's ``init_weights``; LeakyReLU slope 0.02 everywhere; the
state-dict reader the aux nets' ``load_state_dict`` share.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn


def init_weights_(module: nn.Module,
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Xavier-uniform weights, bias 0.01, for every Linear/Conv1d inside."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.fill_(0.01)
    return module


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.02) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def tensor_state_dict(state_dict, keep=None) -> dict:
    """A state dict of f32 tensors from tensors or numpy arrays (a released
    torch dict, an ``np.load``-ed npz, an ``init_*`` dict), without
    BatchNorm's ``num_batches_tracked``; with ``keep`` (a set of names),
    only the keys in it."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked") or (keep is not None
                                                  and k not in keep):
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out[k] = t.float()
    return out
