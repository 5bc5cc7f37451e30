"""Initialisation and activation helpers (counterpart of models/nn.py).

Xavier-uniform weights and bias 0.01 for Linear and Conv1d, as the
reference's ``init_weights``; LeakyReLU slope 0.02 everywhere.
"""

from __future__ import annotations

from typing import Optional

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
