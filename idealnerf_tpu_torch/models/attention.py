"""Attention aggregation modules (counterpart of models/attention.py).

- SelfAttention: single-head QKV with a residual output projection, with
  the reference's 1/sqrt(d) applied AFTER the softmax (a linear output
  scale, kept for parity).
- AttentionSets: AttSets-style masked-softmax pooling over the view axis,
  with the final projection L -> L on the pooled vector (the reference's
  Linear(1, L) there cannot run).
- SlotAttention: GRU-updated slots over per-point multi-view features (3
  iterations) behind a dense encoder and the dense7 projection. Slots
  start at N(mean(mu), std(sigma)) drawn from a ``torch.Generator``, or
  are passed in by the caller.

Weights are ``nn.Linear`` layouts, (out, in); the GRU is ``nn.GRUCell``
(gates r, z, n, as the JAX package's ``_gru_cell``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.nn import init_weights_, leaky_relu


class SelfAttention(nn.Module):
    def __init__(self, input_ch: int, attn_output_ch: int = 256,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.q = nn.Linear(input_ch, attn_output_ch, device=device)
        self.k = nn.Linear(input_ch, attn_output_ch, device=device)
        self.v = nn.Linear(input_ch, attn_output_ch, device=device)
        self.out = nn.Linear(attn_output_ch, input_ch, device=device)
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, input_ch) -> (N, input_ch)."""
        q, k, v = self.q(x), self.k(x), self.v(x)
        attn = torch.softmax(q @ k.T, dim=-1) / (q.shape[-1] ** 0.5)
        return self.out(attn @ v) + x


class AttentionSets(nn.Module):
    def __init__(self, input_ch: int, W: int = 256,
                 attention_output_length: int = 512,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        L = attention_output_length
        self.d1 = nn.Linear(input_ch, W, device=device)
        self.d2 = nn.Linear(W, W, device=device)
        self.d3 = nn.Linear(W, W, device=device)
        self.d4 = nn.Linear(W + input_ch, L, device=device)
        self.d5 = nn.Linear(L, L, device=device)
        self.d6 = nn.Linear(L, L, device=device)
        init_weights_(self, generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs (B, N_views, C) -> (B, attention_output_length)."""
        x = inputs
        for layer in (self.d1, self.d2, self.d3):
            x = torch.relu(layer(x))
        x = leaky_relu(self.d4(torch.cat([x, inputs], dim=-1)), 0.01)
        mask = torch.softmax(self.d5(x), dim=1)
        return self.d6(torch.sum(x * mask, dim=1))


class SlotAttention(nn.Module):
    def __init__(self, dim: int, input_ch: int, embed_ch: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dims = [(input_ch, 64), (64, 32), (32, 32), (32, 32), (32, 32),
                (32, 32)]
        self.dense = nn.ModuleList(nn.Linear(a, b, device=device)
                                   for a, b in dims)
        self.dense7 = nn.Linear(input_ch + embed_ch + 32, dim, device=device)
        for name in ("q", "k", "v", "mlp1", "mlp2"):
            setattr(self, name, nn.Linear(dim, dim, device=device))
        self.gru = nn.GRUCell(dim, dim, device=device)
        self.ln_input = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.ln_slots = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.ln_pre_ff = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.slots_mu = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.slots_sigma = nn.Parameter(torch.empty(1, 1, dim,
                                                    device=device))
        init_weights_(self, generator)
        with torch.no_grad():
            for p in (self.slots_mu, self.slots_sigma):
                p.copy_(torch.randn(p.shape, generator=generator))
            for w in (self.gru.weight_ih, self.gru.weight_hh):
                w.copy_(torch.randn(w.shape, generator=generator)
                        / dim ** 0.5)
            self.gru.bias_ih.zero_()
            self.gru.bias_hh.zero_()

    def initial_slots(self, batch: int, num_slots: int,
                      generator: Optional[torch.Generator] = None):
        """(batch, num_slots, dim) slots drawn at N(mean(mu), std(sigma))."""
        dim = self.slots_mu.shape[-1]
        noise = torch.randn((batch, num_slots, dim), generator=generator,
                            device=self.slots_mu.device)
        return (self.slots_mu.mean()
                + self.slots_sigma.std(unbiased=False) * noise)

    def forward(self, inputs: torch.Tensor, embed_pts: torch.Tensor,
                num_slots: int, generator: Optional[torch.Generator] = None,
                slots: Optional[torch.Tensor] = None, iters: int = 3,
                eps: float = 1e-8) -> torch.Tensor:
        """inputs (B, N, input_ch), embed_pts (B, N, embed_ch) ->
        (B, num_slots * dim). ``slots`` (B, num_slots, dim) replaces the
        draw from ``generator``."""
        x = inputs
        for layer in self.dense:
            x = layer(x)  # the reference applies no activations here
        x = self.dense7(torch.cat([inputs, embed_pts, x], dim=-1))
        batch, _, dim = x.shape
        if slots is None:
            slots = self.initial_slots(batch, num_slots, generator)
        x = self.ln_input(x)
        k, v = self.k(x), self.v(x)
        for _ in range(iters):
            prev = slots
            q = self.q(self.ln_slots(slots))
            dots = torch.einsum("bid,bjd->bij", q, k) * dim ** -0.5
            attn = torch.softmax(dots, dim=1) + eps
            attn = attn / attn.sum(dim=-1, keepdim=True)
            updates = torch.einsum("bjd,bij->bid", v, attn)
            slots = self.gru(updates.reshape(-1, dim),
                             prev.reshape(-1, dim)).reshape(batch,
                                                             num_slots, dim)
            slots = slots + self.mlp2(self.mlp1(self.ln_pre_ff(slots)))
        return slots.reshape(batch, num_slots * dim)
