"""Stratified and hierarchical (inverse-CDF) sampling along rays
(counterpart of core/sampling.py).

``generator=None`` selects the deterministic paths (perturb=0 / det=True),
the reference's eval semantics. The JAX package draws its jitter from
``jax.random``; a ``torch.Generator`` gives other numbers from the same
seed, so agreement is tested on the deterministic paths only. A
``Replay`` stands in for a generator where the numbers were drawn
beforehand (``core.render.render_draws``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Replay:
    """Random numbers drawn beforehand, handed out in the order the
    renderer asks for them, in place of a ``torch.Generator``. A
    ray-sharded step draws a whole frame's numbers and renders its own
    rows of them; a rematerialised forward is handed the same numbers
    again by a fresh Replay of the same tensors."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._tensors = list(tensors)
        self._next = 0

    def take(self, shape) -> torch.Tensor:
        if self._next >= len(self._tensors):
            raise ValueError("Replay: more draws asked for than were made")
        t = self._tensors[self._next]
        self._next += 1
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Replay: draw {self._next - 1} has shape "
                             f"{tuple(t.shape)}, asked for {tuple(shape)}")
        return t


def uniform(generator, shape, dtype, device) -> torch.Tensor:
    """U[0, 1) numbers from ``generator``, or the next of a Replay's."""
    if isinstance(generator, Replay):
        return generator.take(shape)
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def normal(generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) numbers from ``generator``, or the next of a Replay's."""
    if isinstance(generator, Replay):
        return generator.take(shape)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def stratified_sample(
    near,
    far,
    n_samples: int,
    n_rays: int,
    generator: Optional[torch.Generator] = None,
    lindisp: bool = False,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """(n_rays, n_samples) depths, linear in depth (or disparity).

    ``near``/``far`` may be scalars or (n_rays, 1) tensors. With a
    generator, samples are jittered within strata and the last one stays
    pinned to ``far`` (the background-plate sample of raw2outputs).
    """
    if isinstance(near, torch.Tensor) and device is None:
        device = near.device
    # t_j = j / (n - 1), correctly rounded on every device (as the fused
    # coarse kernel computes its depths)
    t = torch.arange(n_samples, dtype=torch.float64, device=device)
    t = (t / max(n_samples - 1, 1)).to(dtype)
    near = torch.as_tensor(near, dtype=dtype, device=device)
    far = torch.as_tensor(far, dtype=dtype, device=device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z = z.expand(n_rays, n_samples)

    if generator is None:
        return z.contiguous()

    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    t_rand = uniform(generator, z.shape, dtype, z.device)
    t_rand = torch.cat([t_rand[..., :-1], torch.ones_like(t_rand[..., -1:])],
                       dim=-1)
    return lower + (upper - lower) * t_rand


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` depths per ray.

    ``bins`` (R, B), ``weights`` (R, B-1) -> (R, n_samples). Same epsilons
    as the reference: ``+1e-5`` on the weights, and a CDF step below 1e-5
    is treated as 1. ``searchsorted(right=True)`` gives the same below/
    above indices as the JAX package's masked reduces.

    The CDF's last entry is set to 1, its exact value. In float32 the
    running sum ends a few ulp above or below 1 depending on summation
    order, and when the last bin's step is under the 1e-5 floor (a ray
    whose weight ends before the last bin) that rounding alone would
    move the u = 1 sample by a whole bin; pinned, it lands on the last
    bin edge in every implementation (the fused coarse kernel pins it the
    same way).
    """
    weights = weights + 1e-5
    # accumulated in float64 and rounded once: the order of the sums then
    # leaves no trace in the float32 CDF, so the fused coarse kernel and
    # this function place the same depths
    w64 = weights.double()
    cdf = torch.cumsum(w64 / torch.sum(w64, dim=-1, keepdim=True), dim=-1)
    cdf = cdf.to(weights.dtype)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1],
                     torch.ones_like(cdf[..., :1])], dim=-1)  # (R, B)

    shape = cdf.shape[:-1] + (n_samples,)
    if generator is None:
        # u_j = j / (n - 1), correctly rounded on every device (the fused
        # coarse kernel computes the same f32 quotient)
        u = torch.arange(n_samples, dtype=torch.float64, device=cdf.device)
        u = (u / max(n_samples - 1, 1)).to(cdf.dtype)
        u = u.expand(shape).contiguous()
    else:
        u = uniform(generator, shape, cdf.dtype, cdf.device)

    n_b = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_b - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
