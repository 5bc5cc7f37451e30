"""The fused point MLP of the PyTorch port (kernels/fused_mlp.py) against
the JAX package's Pallas kernel (fused_point_mlp with fuse_pe=True, in
interpret mode), at the dims of tests/test_fused_mlp.py. On the CPU the
port's wrapper runs the kernel's plain version, which rounds at the same
bf16 points. Bound: 3e-2 absolute and a correlation above 0.999 per output
lane, the fused kernels' bound (both sides round weights, PE and
activations to bf16, at points that can land one ulp apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.kernels.fused_mlp import fused_point_mlp as jax_fused
from idealnerf_tpu.models import face_nerf as jax_fn
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.kernels import fused_mlp
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, apply_folded, fold_conditioning, make_field_fn,
)

ATOL = 3e-2
MIN_CORR = 0.999


def _setup(dim_aud=64, dim_expr=79, dim_latent=32, n=300, seed=0):
    jcfg = jax_fn.FaceNeRFConfig(dim_aud=dim_aud, dim_expr=dim_expr,
                                 dim_latent=dim_latent)
    cfg = FaceNeRFConfig(dim_aud=dim_aud, dim_expr=dim_expr,
                         dim_latent=dim_latent)
    jparams = jax_fn.init_face_nerf(jax.random.PRNGKey(seed), jcfg)
    model = bridge.load_module_(FaceNeRF(cfg),
                                jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(seed + 1)
    pts = rng.randn(n, 3).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cond = [rng.randn(d).astype(np.float32) if d else None
            for d in (dim_aud, dim_expr, dim_latent)]
    jfold = jax_fn.fold_conditioning(
        jparams, jcfg, *[None if c is None else jnp.asarray(c) for c in cond])
    folded = fold_conditioning(
        model, cfg, *[None if c is None else torch.from_numpy(c)
                      for c in cond])
    return jcfg, jparams, jfold, cfg, model, folded, pts, dirs


@pytest.mark.parametrize("kw,tile", [
    (dict(n=300), 128), (dict(n=1), 128),
    (dict(dim_aud=0, dim_expr=0, dim_latent=0, n=64), 64),
], ids=["conditioned", "one_point", "no_conditioning"])
def test_point_mlp_matches_jax_kernel(kw, tile):
    jcfg, jparams, jfold, cfg, model, folded, pts, dirs = _setup(**kw)
    want = np.asarray(jax_fused(jparams, jfold, jcfg, jnp.asarray(pts),
                                jnp.asarray(dirs), tile=tile, interpret=True))
    before = dict(fused_mlp.launch_counts)
    with torch.no_grad():
        got = fused_mlp.fused_point_mlp(model, folded, cfg,
                                        torch.from_numpy(pts),
                                        torch.from_numpy(dirs)).numpy()
    assert fused_mlp.launch_counts == before  # CPU tensors: plain version
    assert got.shape == want.shape == (pts.shape[0], 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if pts.shape[0] > 1:
        for c in range(4):
            r = np.corrcoef(got[:, c], want[:, c])[0, 1]
            assert r > MIN_CORR, (c, r)


@pytest.mark.parametrize("kw,tile", [
    (dict(n=300), 128), (dict(n=1), 128),
    (dict(dim_aud=0, dim_expr=0, dim_latent=0, n=64), 64),
], ids=["conditioned", "one_point", "no_conditioning"])
def test_point_mlp_pe_matches_jax_kernel(kw, tile):
    """fuse_pe=False: the encodings are built outside the kernel and
    rounded to bf16 (the port's positional_encoding against XLA's f32 sin,
    up to ~1e-4 apart at multires 10, under the same bound)."""
    jcfg, jparams, jfold, cfg, model, folded, pts, dirs = _setup(**kw)
    want = np.asarray(jax_fused(jparams, jfold, jcfg, jnp.asarray(pts),
                                jnp.asarray(dirs), tile=tile, interpret=True,
                                fuse_pe=False))
    before = dict(fused_mlp.launch_counts)
    with torch.no_grad():
        got = fused_mlp.fused_point_mlp(model, folded, cfg,
                                        torch.from_numpy(pts),
                                        torch.from_numpy(dirs),
                                        fuse_pe=False).numpy()
    assert fused_mlp.launch_counts == before  # CPU tensors: plain version
    assert got.shape == want.shape == (pts.shape[0], 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if pts.shape[0] > 1:
        for c in range(4):
            r = np.corrcoef(got[:, c], want[:, c])[0, 1]
            assert r > MIN_CORR, (c, r)


def test_point_mlp_pe_refuses_what_the_kernel_does_not_take():
    """The encoded-input wrapper takes (N, 64) and (N, 32) bf16 encodings
    on the card; CPU tensors of any float type take the plain version."""
    _, _, _, cfg, model, folded, pts, dirs = _setup(n=8, seed=4)
    net = fused_mlp.pack_operands(model, folded, cfg)
    pe, ped = fused_mlp.encode_points(net, torch.from_numpy(pts),
                                      torch.from_numpy(dirs))
    want = fused_mlp.point_mlp_reference(net, torch.from_numpy(pts),
                                         torch.from_numpy(dirs))
    np.testing.assert_array_equal(fused_mlp.point_mlp_pe(net, pe, ped),
                                  want)
    with pytest.raises(ValueError, match="cuda"):
        fused_mlp.point_mlp_pe(net, pe.to(torch.bfloat16).to("meta"),
                               ped.to(torch.bfloat16))


def test_point_mlp_tracks_the_f32_mlp():
    """The bf16 kernel's plain version against the f32 plain MLP on the
    same inputs (directions taken as given, not normalised)."""
    _, _, _, cfg, model, folded, pts, dirs = _setup(n=200, seed=3)
    dirs = dirs * 1.7
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    with torch.no_grad():
        got = fused_mlp.fused_point_mlp_reference(model, folded, cfg, p, d)
        want = apply_folded(model, folded, cfg,
                            positional_encoding(p, cfg.multires),
                            positional_encoding(d, cfg.multires_views))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True, "train", "train_bf16"])
def test_field_fn_paths_agree(use_pallas):
    """make_field_fn's four paths give the same field on the CPU."""
    _, _, _, cfg, model, _, pts, dirs = _setup(dim_expr=8, n=60, seed=5)
    rng = np.random.RandomState(7)
    aud, expr = (torch.from_numpy(rng.randn(d).astype(np.float32))
                 for d in (64, 8))
    lat = torch.ones(32)
    p = torch.from_numpy(pts).reshape(6, 10, 3)
    vd = torch.from_numpy(dirs[:6])
    fn = make_field_fn(model, cfg, aud, expr, lat, use_pallas=use_pallas)
    ref = make_field_fn(model, cfg, aud, expr, lat)
    with torch.no_grad():
        got, want = fn(p, vd), ref(p, vd)
    assert got.shape == (6, 10, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=0 if use_pallas is False else ATOL)
    with pytest.raises(ValueError):
        make_field_fn(model, cfg, aud, expr, lat, use_pallas="bf16")


def test_field_fn_compute_dtype_and_refusals():
    """compute_dtype casts the plain path's parameters and inputs; the
    fused paths take no compute_dtype and need view directions."""
    _, _, _, cfg, model, _, pts, dirs = _setup(dim_expr=8, n=60, seed=6)
    aud, expr, lat = torch.ones(64), torch.ones(8) * 0.5, torch.ones(32)
    p = torch.from_numpy(pts).reshape(6, 10, 3)
    vd = torch.from_numpy(dirs[:6])
    with torch.no_grad():
        got = make_field_fn(model, cfg, aud, expr, lat,
                            compute_dtype=torch.float64)(p, vd)
        want = make_field_fn(model, cfg, aud, expr, lat)(p, vd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_field_fn(model, cfg, aud, expr, lat, torch.bfloat16, "train")
    no_views = FaceNeRFConfig(use_viewdirs=False)
    with pytest.raises(ValueError, match="use_viewdirs"):
        make_field_fn(FaceNeRF(no_views), no_views, use_pallas="train_bf16")
