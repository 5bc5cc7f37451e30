"""The port's fused render wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode.

Parameters move through idealnerf_tpu_torch.bridge; rays and
conditioning come from numpy with a fixed seed. The render outputs are
held to 3e-2 plus a correlation above 0.999, the bound of the JAX
package's own kernel tests (tests/test_fused_render.py): both sides round
weights and activations to bf16, and the two frameworks can round a value
one ulp apart. The depth placement is held to 2e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.core.sampling import sample_pdf as jax_sample_pdf
from idealnerf_tpu.core.sampling import stratified_sample as jax_stratified
from idealnerf_tpu.kernels import fused_render as jfr
from idealnerf_tpu.models import face_nerf as jax_fn
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.core.sampling import stratified_sample
from idealnerf_tpu_torch.kernels import build as kbuild
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF, fold_conditioning

SMALL = dict(dim_aud=16, dim_expr=8, dim_latent=4, netdepth=6, netwidth=64)
PAPER = dict(dim_aud=16, dim_expr=8, dim_latent=4)   # D=8, W=256
NEAR, FAR = 0.5772, 1.1772


def _t(x):
    return torch.from_numpy(np.array(x))


def _setup(n_rays, seed=0, density="relu", **cfg_kw):
    """JAX params + folded biases, the bridged port model + its folded
    biases, and numpy rays/plate."""
    jcfg = JaxConfig(**cfg_kw, density_activation=density)
    ncfg_j = jcfg.face_nerf_config()
    jparams = jax_fn.init_face_nerf(jax.random.PRNGKey(seed), ncfg_j)
    rng = np.random.RandomState(seed)
    aud = rng.randn(ncfg_j.dim_aud).astype(np.float32)
    expr = rng.randn(ncfg_j.dim_expr).astype(np.float32)
    lat = (rng.randn(ncfg_j.dim_latent) * 0.1).astype(np.float32)
    jfold = jax_fn.fold_conditioning(jparams, ncfg_j, jnp.asarray(aud),
                                     jnp.asarray(expr), jnp.asarray(lat))
    from idealnerf_tpu_torch.config import ExperimentConfig

    ncfg = ExperimentConfig(**cfg_kw, density_activation=density
                            ).face_nerf_config()
    model = bridge.load_module_(FaceNeRF(ncfg),
                                jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, _t(aud), _t(expr), _t(lat))
    rays_o = np.tile(np.array([[0.0, 0.0, 1.5]], np.float32), (n_rays, 1))
    rays_d = (rng.randn(n_rays, 3) * 0.08 + [0.0, 0.0, -1.0]).astype(np.float32)
    bc = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    return (jparams, jfold, ncfg_j), (model, folded, ncfg), (rays_o, rays_d, bc)


def _agree(port, ref, keys, corr_key="rgb_map"):
    for k in keys:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   atol=3e-2, err_msg=k)
    c = np.corrcoef(port[corr_key].numpy().ravel(),
                    np.asarray(ref[corr_key]).ravel())[0, 1]
    assert c > 0.999, c


KEYS = ("rgb_map", "acc_map", "weights", "last_weight", "rgb_fg", "depth")


@pytest.mark.parametrize("n_rays,n_samples,density,cfg_kw", [
    (64, 32, "relu", SMALL), (100, 64, "relu", SMALL),
    (64, 32, "softplus", SMALL), (64, 32, "relu", PAPER)],
    ids=["r64-s32", "r100-s64", "softplus", "paper-width"])
def test_fused_render_rays_matches_jax(n_rays, n_samples, density, cfg_kw):
    (jp, jf, jc), (m, f, c), (ro, rd, bc) = _setup(n_rays, density=density,
                                                  **cfg_kw)
    # spread the rays over 0.6..2.2 so some cross the field's density
    z = np.asarray(jax_stratified(0.6, 2.2, n_samples, n_rays, key=None))
    ref = jfr.fused_render_rays(jp, jf, jc, jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(z), jnp.asarray(bc),
                                point_tile=512)
    with torch.no_grad():
        out = fr.fused_render_rays(m, f, c, _t(ro), _t(rd), _t(z), _t(bc))
    _agree(out, ref, KEYS)


@pytest.mark.parametrize("n_s,n_i", [(64, 128), (16, 16)])
def test_fused_render_coarse_hier_matches_jax(n_s, n_i):
    """64+128 is the paper's sampling; 16+16 a power-of-two total."""
    (jp, jf, jc), (m, f, c), (ro, rd, bc) = _setup(64, seed=1, **SMALL)
    coarse_j, z_j = jfr.fused_render_coarse_hier(
        jp, jf, jc, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bc),
        NEAR, FAR, n_s, n_i, point_tile=1024)
    with torch.no_grad():
        coarse, z = fr.fused_render_coarse_hier(m, f, c, _t(ro), _t(rd),
                                                _t(bc), NEAR, FAR, n_s, n_i)
    _agree(coarse, coarse_j, KEYS)
    # the depths follow the bf16-rounded coarse weights of each side
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=3e-2)
    assert z.shape == (64, n_s + n_i)
    assert torch.all(z[:, 1:] >= z[:, :-1])


@pytest.mark.parametrize("n_s,n_i", [(64, 128), (16, 16), (8, 2)])
def test_importance_depths_match_jax_sample_pdf_sort(n_s, n_i):
    """The port's inverse CDF + merge, fed the same numpy weights, against
    JAX sample_pdf + jnp.sort at 2e-6."""
    rng = np.random.RandomState(n_s)
    R = 96
    z = np.asarray(jax_stratified(NEAR, FAR, n_s, R, key=None))
    # bin masses well above sample_pdf's 1e-5 floor (see test_torch_core)
    w = rng.uniform(0.02, 0.3, (R, n_s)).astype(np.float32)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    ref = jnp.sort(jnp.concatenate([
        jnp.asarray(z), jax_sample_pdf(jnp.asarray(z_mid),
                                       jnp.asarray(w[:, 1:-1]), n_i)], -1), -1)
    out = fr.importance_depths(_t(z), _t(w), n_i)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6,
                               rtol=0)


def test_render_rays_fused_hier_and_plain_branches_match_jax():
    """render_rays_fused: the in-kernel depth placement branch (scalar
    near/far) and the plain-sampling branch (per-ray near/far), with
    separate coarse and fine networks, against the JAX driver."""
    (jp, jf, jc), (m, f, c), (ro, rd, bc) = _setup(48, seed=2, **SMALL)
    (jp2, jf2, _), (m2, f2, _), _ = _setup(48, seed=3, **SMALL)
    near_r = np.full((48, 1), NEAR, np.float32)
    for near, jnear in ((NEAR, NEAR), (_t(near_r), jnp.asarray(near_r))):
        ref = jfr.render_rays_fused(
            jp, jf, jc, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bc),
            jnear, FAR, 32, 32, fine_params=jp2, fine_folded=jf2,
            point_tile=512)
        with torch.no_grad():
            out = fr.render_rays_fused(m, f, c, _t(ro), _t(rd), _t(bc), near,
                                       FAR, 32, 32, fine_params=m2,
                                       fine_folded=f2)
        _agree(out, ref, ("rgb_map", "acc_map", "last_weight", "rgb0",
                          "acc0"))


def test_ray_missing_all_density_composites_to_plate():
    (_, _, _), (m, f, c), (ro, rd, bc) = _setup(16, seed=4, **SMALL)
    with torch.no_grad():
        m.alpha_linear.bias -= 100.0
        f = fold_conditioning(m, c, torch.ones(16), torch.ones(8),
                              torch.ones(4))
    z = stratified_sample(0.5, 1.5, 32, 16)
    out = fr.fused_render_rays(m, f, c, _t(ro), _t(rd), z, _t(bc))
    np.testing.assert_allclose(out["rgb_map"].numpy(), bc, atol=1e-3)
    np.testing.assert_allclose(out["rgb_fg"].numpy(), 0.0, atol=1e-3)


def test_cpu_path_launches_nothing_and_builds_nothing():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted and the CUDA library is never built or loaded, so the module
    works without nvcc."""
    fr.reset_launch_counts()
    kbuild.load_library.cache_clear()
    (_, _, _), (m, f, c), (ro, rd, bc) = _setup(8, seed=5, **SMALL)
    with torch.no_grad():
        fr.render_rays_fused(m, f, c, _t(ro), _t(rd), _t(bc), NEAR, FAR, 8, 8)
    assert fr.launch_counts == {"fused_render_rays": 0,
                                "fused_render_coarse_hier": 0}
    assert kbuild.load_library.cache_info().currsize == 0


def test_non_cpu_tensors_never_reach_the_plain_version():
    """A tensor that is not on the CPU must launch the kernel or raise;
    meta tensors are refused before any build."""
    (_, _, _), (m, f, c), (ro, rd, bc) = _setup(8, seed=6, **SMALL)
    meta = {k: torch.empty(v.shape, device="meta")
            for k, v in dict(ro=ro, rd=rd, bc=bc).items()}
    z = torch.empty((8, 16), device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="expected cuda"):
        fr.fused_render_rays(m, f, c, meta["ro"], meta["rd"], z, meta["bc"])
    with torch.no_grad(), pytest.raises(ValueError, match="expected cuda"):
        fr.fused_render_coarse_hier(m, f, c, meta["ro"], meta["rd"],
                                    meta["bc"], NEAR, FAR, 16, 16)
    with pytest.raises(ValueError, match="n_importance > 1"):
        fr.fused_render_coarse_hier(m, f, c, _t(ro), _t(rd), _t(bc), NEAR,
                                    FAR, 16, 1)


def test_pack_operands_layout():
    """The packed heads route rgb to columns 0..2 and sigma to column 3,
    the skip layer is split, and the weights are bf16 (in, out)."""
    (_, _, _), (m, f, c), _ = _setup(4, seed=7, **SMALL)
    net = fr.pack_operands(m, f, c)
    assert net.w[0].shape == (fr.PE_PAD, 64) and net.w[0].dtype == torch.bfloat16
    assert set(net.wskip) == {5} and net.w[5].shape == (64, 64)
    assert [w.shape for w in net.wv] == [(64, 32), (32, 32)]
    assert net.wv0d.shape == (fr.PED_PAD, 32)
    assert torch.all(net.w_alpha[:, [0, 1, 2, *range(4, 16)]] == 0)
    assert torch.all(net.w_rgb[:, 3:] == 0)
    with pytest.raises(ValueError, match="use_viewdirs"):
        fr.pack_operands(m, f, dataclasses.replace(c, use_viewdirs=False))
