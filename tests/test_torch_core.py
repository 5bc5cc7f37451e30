"""Core math of the PyTorch port against the JAX package, in float32.

Inputs come from numpy with a fixed seed and go to both packages. The
tolerance is 1e-5 (float32 ops evaluated in a different order), and
2e-6 for sample_pdf, the bound the JAX package holds its own in-kernel
depth placement to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.core.composite import raw2outputs as jax_raw2outputs
from idealnerf_tpu.core.embedding import positional_encoding as jax_pe
from idealnerf_tpu.core.rays import get_rays as jax_get_rays
from idealnerf_tpu.core.rays import ndc_rays as jax_ndc_rays
from idealnerf_tpu.core.render import RenderConfig as JaxRenderConfig
from idealnerf_tpu.core.render import render_rays as jax_render_rays
from idealnerf_tpu.core.sampling import sample_pdf as jax_sample_pdf
from idealnerf_tpu.core.sampling import stratified_sample as jax_stratified
from idealnerf_tpu_torch.core.composite import raw2outputs
from idealnerf_tpu_torch.core.embedding import pe_dim, positional_encoding
from idealnerf_tpu_torch.core.rays import get_rays, ndc_rays
from idealnerf_tpu_torch.core.render import RenderConfig, render_rays
from idealnerf_tpu_torch.core.sampling import sample_pdf, stratified_sample

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=atol, rtol=rtol)


def _pe_evidence(x, port, ref, num_freqs):
    """What a failing PE comparison reports (ROADMAP.md C4): the worst
    values, their inputs and phases, each side's distance from f64 there,
    and the settings either side's result could depend on."""
    import os

    import jax

    err = np.abs(port - ref)
    xb = x.astype(np.float64)[:, None, :] * 2.0 ** np.arange(num_freqs)[:, None]
    exact = np.concatenate(
        [x, np.stack([np.sin(xb), np.cos(xb)], -2).reshape(len(x), -1)], -1)
    lines = [f"max |port - jax| {err.max():.3g} on {(err > 1e-4).sum()} of "
             f"{err.size} values"]
    for flat in np.argsort(err, axis=None)[::-1][:8]:
        i, j = np.unravel_index(flat, err.shape)
        lines.append(
            f"  point {i} x={x[i].tolist()} lane {j}: port {port[i, j]!r} "
            f"jax {ref[i, j]!r} f64 {exact[i, j]!r}")
    lines.append(
        f"port vs f64 {np.abs(port - exact).max():.3g}, jax vs f64 "
        f"{np.abs(ref - exact).max():.3g}; torch threads "
        f"{torch.get_num_threads()}, torch default dtype "
        f"{torch.get_default_dtype()}; XLA_FLAGS "
        f"{os.environ.get('XLA_FLAGS')!r}; jax_enable_x64 "
        f"{jax.config.jax_enable_x64}, default matmul precision "
        f"{jax.config.jax_default_matmul_precision!r}")
    return "\n".join(lines)


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding_matches_jax(num_freqs):
    """The port's PE against JAX's within 1e-4 absolute; a failure reports
    its evidence (``_pe_evidence``; ROADMAP.md C4)."""
    x = np.random.RandomState(0).uniform(-1.5, 1.5, (257, 3)).astype(np.float32)
    out = positional_encoding(_t(x), num_freqs)
    assert out.shape[-1] == pe_dim(3, num_freqs)
    # phases reach 512·x: sin/cos of large f32 arguments differ by a few
    # ulp of the argument between libraries, hence the absolute bound
    port = out.numpy()
    ref = np.asarray(jax_pe(jnp.asarray(x), num_freqs))
    assert np.abs(port - ref).max() <= 1e-4, _pe_evidence(x, port, ref,
                                                          num_freqs)


def test_positional_encoding_multires10_against_f64():
    """The paper's multires 10 (phases up to 512·x) on seeded points, three
    ways: XLA on the CPU, torch, and numpy in f64 on the same f32 points
    (each phase x·2^k is exact in f32, so f64 gives the exact sine of the
    phase both f32 sides evaluate). Each f32 side must stay within one f32
    ulp of 1.0 (1.19e-7) of f64; the closer side goes into ROADMAP C."""
    x = np.random.RandomState(7).uniform(-4, 4, (4096, 3)).astype(np.float32)
    xb = x.astype(np.float64)[:, None, :] * 2.0 ** np.arange(10)[:, None]
    exact = np.concatenate(
        [x, np.stack([np.sin(xb), np.cos(xb)], -2).reshape(len(x), -1)], -1)
    errs = {
        "xla": np.abs(np.asarray(jax_pe(jnp.asarray(x), 10), np.float64)
                      - exact).max(),
        "torch": np.abs(positional_encoding(_t(x), 10).numpy()
                        .astype(np.float64) - exact).max(),
    }
    for side, err in errs.items():
        assert err < np.finfo(np.float32).eps, f"{side}: {err:.3e}"


def test_get_rays_matches_jax():
    rng = np.random.RandomState(1)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    pose = np.concatenate([q, rng.randn(3, 1)], 1).astype(np.float32)
    for cx, cy in ((None, None), (9.5, 6.25)):
        o, d = get_rays(12, 17, 21.5, _t(pose), cx, cy)
        jo, jd = jax_get_rays(12, 17, 21.5, jnp.asarray(pose), cx, cy)
        _close(o, jo)
        _close(d, jd)

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ndc_rays_matches_jax(seed):
    """Seeded rays of a random pose (directions pointing down -z, the
    forward-facing case NDC is for) in normalised device coordinates,
    against the JAX function at 1e-6."""
    rng = np.random.RandomState(seed)
    H, W, focal, near = 12, 10, 30.0, 1.0
    o = (rng.randn(H, W, 3) * 0.2 + [0.0, 0.0, 0.5]).astype(np.float32)
    d = np.concatenate([rng.randn(H, W, 2) * 0.3,
                        -rng.uniform(0.5, 1.5, (H, W, 1))], -1)
    d = d.astype(np.float32)
    got = ndc_rays(H, W, focal, near, torch.from_numpy(o),
                   torch.from_numpy(d))
    want = jax_ndc_rays(H, W, focal, near, jnp.asarray(o), jnp.asarray(d))
    for g, w in zip(got, want):
        assert g.shape == (H, W, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_ndc_rays_z_convention():
    """A ray down -z from the camera centre: its origin lands on the near
    plane at NDC z = -1 and its direction spans the rest of the frustum,
    as the JAX function's (tests/test_core_math.py)."""
    o = torch.tensor([[0.0, 0.0, -1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    o2, d2 = ndc_rays(8, 8, 10.0, 1.0, o, d)
    assert o2.shape == (1, 3) and d2.shape == (1, 3)
    assert torch.isfinite(o2).all() and torch.isfinite(d2).all()
    jo, jd = jax_ndc_rays(8, 8, 10.0, 1.0, jnp.asarray(o.numpy()),
                          jnp.asarray(d.numpy()))
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(o2.numpy(), [[0.0, 0.0, -1.0]], atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), [[0.0, 0.0, 2.0]], atol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_sample_deterministic_matches_jax(lindisp):
    z = stratified_sample(0.5772, 1.1772, 64, 5, lindisp=lindisp)
    _close(z, jax_stratified(0.5772, 1.1772, 64, 5, key=None, lindisp=lindisp))
    near = np.linspace(0.3, 0.5, 5, dtype=np.float32)[:, None]
    z = stratified_sample(_t(near), 1.2, 16, 5, lindisp=lindisp)
    _close(z, jax_stratified(jnp.asarray(near), 1.2, 16, 5, key=None,
                             lindisp=lindisp))


def test_stratified_sample_jitter_keeps_far_pinned():
    g = torch.Generator().manual_seed(0)
    z = stratified_sample(0.5, 1.5, 32, 7, generator=g)
    assert torch.all(z[:, -1] == 1.5)
    assert torch.all(z[:, 1:] >= z[:, :-1])


@pytest.mark.parametrize("n_samples", [1, 16, 128])
def test_sample_pdf_deterministic_matches_jax(n_samples):
    rng = np.random.RandomState(2)
    bins = np.sort(rng.uniform(0.5, 1.2, (40, 63)), -1).astype(np.float32)
    # every bin keeps a mass well above the 1e-5 floor: where a bin's CDF
    # step is tiny, dz/du is bin width over step, and float32 rounding of
    # the running sum (summed in another order here) is amplified by it;
    # the last bin's step above the floor also keeps the u = 1 sample off
    # its rounding-dependent case (see the next test)
    w = rng.uniform(0.05, 1, (40, 62)).astype(np.float32)
    w[:5] = 0.0                      # uniform-pdf rays
    w[5:8, 30] = 5.0                 # spiky rays
    out = sample_pdf(_t(bins), _t(w), n_samples)
    _close(out, jax_sample_pdf(jnp.asarray(bins), jnp.asarray(w), n_samples),
           atol=2e-6, rtol=0)


def test_sample_pdf_u1_lands_on_last_edge():
    """An opaque ray whose mass ends before the last bin: the u = 1 sample
    is the last bin edge, its exact-arithmetic value, however the float32
    running sum of the CDF rounds."""
    rng = np.random.RandomState(5)
    bins = np.sort(rng.uniform(0.5, 1.2, (64, 63)), -1).astype(np.float32)
    w = np.zeros((64, 62), np.float32)
    w[np.arange(64), rng.randint(5, 40, 64)] = 1.0
    w += rng.uniform(0, 1e-3, w.shape).astype(np.float32) * (np.arange(62) < 40)
    out = sample_pdf(_t(bins), _t(w), 8).numpy()
    np.testing.assert_array_equal(out[:, -1], bins[:, -1])
    assert np.all(np.diff(out, axis=-1) >= 0)


@pytest.mark.parametrize("density", ["relu", "softplus"])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_matches_jax(density, white_bkgd):
    rng = np.random.RandomState(3)
    R, S = 50, 24
    raw = (rng.randn(R, S, 4) * 2.0).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 1.5, (R, S)), -1).astype(np.float32)
    rays_d = rng.randn(R, 3).astype(np.float32)
    bc = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    out = raw2outputs(_t(raw), _t(z), _t(rays_d), _t(bc), white_bkgd=white_bkgd,
                      density_activation=density)
    ref = jax_raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                          jnp.asarray(rays_d), jnp.asarray(bc),
                          white_bkgd=white_bkgd, density_activation=density)
    for name in ref._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            atol=TOL, rtol=TOL, err_msg=name)


def test_raw2outputs_rejects_unknown_activation():
    z = torch.linspace(0.5, 1.0, 4).expand(2, 4)
    with pytest.raises(ValueError):
        raw2outputs(torch.zeros(2, 4, 4), z, torch.ones(2, 3),
                    torch.zeros(2, 3), density_activation="exp")


def test_render_rays_deterministic_matches_jax():
    """The plain hierarchical renderer (eval mode) with the same analytic
    field in both packages: a soft sphere of radius 0.4."""
    rng = np.random.RandomState(4)
    R = 32
    rays_o = np.tile(np.array([[0.0, 0.0, 1.5]], np.float32), (R, 1))
    rays_d = (rng.randn(R, 3) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    bc = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    a = rng.randn(3, 3).astype(np.float32)

    def field_t(pts, viewdirs):
        rgb = torch.sin(pts @ _t(a))
        sigma = 30.0 * (0.4 - torch.linalg.norm(pts, dim=-1, keepdim=True))
        return torch.cat([rgb, sigma], -1)

    def field_j(pts, viewdirs):
        rgb = jnp.sin(pts @ jnp.asarray(a))
        sigma = 30.0 * (0.4 - jnp.linalg.norm(pts, axis=-1, keepdims=True))
        return jnp.concatenate([rgb, sigma], -1)

    kw = dict(n_samples=32, n_importance=32, perturb=False)
    out = render_rays(field_t, _t(rays_o), _t(rays_d), _t(bc), 0.6, 2.2,
                      RenderConfig(**kw))
    ref = jax_render_rays(field_j, jnp.asarray(rays_o), jnp.asarray(rays_d),
                          jnp.asarray(bc), 0.6, 2.2, JaxRenderConfig(**kw))
    # z_std is left out: on opaque rays the JAX u = 1 sample sits a bin
    # below the port's pinned last edge (test_sample_pdf_u1_lands_on_last_edge)
    for k in ("rgb_map", "acc_map", "last_weight", "depth_map", "rgb0",
              "acc0"):
        _close(out[k], ref[k])
