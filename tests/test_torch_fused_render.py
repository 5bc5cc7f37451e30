"""The port's fused render wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode.

Parameters move through idealnerf_tpu_torch.bridge; rays and
conditioning come from numpy with a fixed seed. The render outputs are
held to 3e-2 plus a correlation above 0.999, the bound of the JAX
package's own kernel tests (tests/test_fused_render.py): both sides round
weights and activations to bf16, and the two frameworks can round a value
one ulp apart. The depth placement is held to 2e-6; the temporal delta
kernel's next-frame band and mass follow its bf16 render, so they are held
to 3e-2 like the render.
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
from idealnerf_tpu_torch.core.composite import fg_band
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


def _delta_inputs(R, s_prev, seed):
    """The inputs of the JAX package's delta-kernel test
    (tests/test_fused_render.py:test_fused_delta_matches_xla_chain), from
    numpy: rays through the field, the previous frame's sorted depths with
    the plate pin at far, weights well above sample_pdf's 1e-5 floor, and
    a cached band inside [near, far]."""
    rng = np.random.RandomState(seed)
    ro = rng.uniform(-0.2, 0.2, (R, 3)).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    bc = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    z_in = np.sort(rng.uniform(NEAR, FAR, (R, s_prev - 1)), -1)
    z_prev = np.concatenate([z_in, np.full((R, 1), FAR)], 1).astype(np.float32)
    w_prev = rng.uniform(0.0, 0.1, (R, s_prev)).astype(np.float32)
    lo = (NEAR + 0.1 + 0.05 * rng.uniform(size=R)).astype(np.float32)
    hi = (lo + 0.2 + 0.1 * rng.uniform(size=R)).astype(np.float32)
    return ro, rd, bc, z_prev, w_prev, lo, hi


@pytest.mark.parametrize("s_prev,s_uni,s_imp,cfg_kw", [
    (16, 3, 12, SMALL), (24, 4, 11, SMALL), (16, 3, 12, PAPER)],
    ids=["s16-3+12", "s24-4+11", "paper-width"])
def test_fused_render_delta_matches_jax(s_prev, s_uni, s_imp, cfg_kw):
    """The delta kernel's plain version against the JAX kernel in
    interpret mode: depths 2e-6; render and mass 3e-2 with rgb correlation
    > 0.999. The band holds at 2e-6 as a function of the render (the
    port's fg_band on JAX's depths and weights against JAX's band), and
    at 3e-2 against JAX's band on every ray that carries foreground mass
    (above 1e-3; a massless ray's weights are f32 noise around 6e-8, and
    the temporal renderer drops its band as invalid) and whose cumulative
    weight stays more than 2e-3 of its total away from q * total. The
    band is a step function: within the two sides' bf16 noise of a
    threshold, lo or hi moves by a whole sample gap."""
    (jp, jf, jc), (m, f, c), _ = _setup(4, seed=8, **cfg_kw)
    R = 48
    ins = _delta_inputs(R, s_prev, seed=s_prev)
    ro, rd, bc, z_prev, w_prev, lo, hi = ins
    ref = jfr.fused_render_delta(
        jp, jf, jc, *(jnp.asarray(x) for x in (ro, rd, z_prev, w_prev, lo,
                                               hi, bc)),
        FAR, s_uni, s_imp, point_tile=512)
    with torch.no_grad():
        out = fr.fused_render_delta(m, f, c, _t(ro), _t(rd), _t(z_prev),
                                    _t(w_prev), _t(lo), _t(hi), _t(bc), FAR,
                                    s_uni, s_imp)
    S = s_uni + s_imp + 1
    assert out["z_vals"].shape == (R, S) and out["weights"].shape == (R, S)
    np.testing.assert_allclose(out["z_vals"].numpy(), np.asarray(ref["z_vals"]),
                               atol=2e-6, rtol=0)
    _agree(out, ref, KEYS + ("fg_mass",))
    b_lo, b_hi, _ = fg_band(_t(ref["z_vals"]), _t(ref["weights"]))
    w = np.asarray(ref["weights"])[:, :-1].astype(np.float64)
    cw = np.cumsum(w, -1) / np.maximum(w.sum(-1, keepdims=True), 1e-10)
    for k, b, q in (("band_lo", b_lo, 0.02), ("band_hi", b_hi, 0.98)):
        np.testing.assert_allclose(b.numpy(), np.asarray(ref[k]), atol=2e-6,
                                   rtol=0, err_msg=k)
        clear = (np.abs(cw - q).min(-1) > 2e-3) & (w.sum(-1) > 1e-3)
        assert clear.mean() >= 0.75, (k, clear.mean())
        np.testing.assert_allclose(out[k].numpy()[clear],
                                   np.asarray(ref[k])[clear], atol=3e-2,
                                   err_msg=k)


def test_delta_plain_version_is_the_chain():
    """fused_render_delta's plain version is delta_depths -> the fine pass
    -> fg_band on its own depths and weights, with the plate pin last."""
    (_, _, _), (m, f, c), _ = _setup(4, seed=9, **SMALL)
    ro, rd, bc, z_prev, w_prev, lo, hi = (_t(x) for x in
                                          _delta_inputs(32, 16, seed=9))
    with torch.no_grad():
        out = fr.fused_render_delta(m, f, c, ro, rd, z_prev, w_prev, lo, hi,
                                    bc, FAR, 3, 12)
        z = fr.delta_depths(z_prev, w_prev, lo, hi, FAR, 3, 12)
        ref = fr.fused_render_rays(m, f, c, ro, rd, z, bc)
    assert torch.equal(out["z_vals"], z)
    assert torch.all(z[:, 1:] >= z[:, :-1]) and torch.all(z[:, -1] == FAR)
    for k in KEYS:
        assert torch.equal(out[k], ref[k]), k
    b_lo, b_hi, _ = fg_band(z, ref["weights"])
    assert torch.equal(out["band_lo"], b_lo)
    assert torch.equal(out["band_hi"], b_hi)
    assert torch.equal(out["fg_mass"], ref["acc_map"] - ref["last_weight"])


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
    z_prev, w_prev, lo, hi = (_t(x) for x in _delta_inputs(8, 16, 5)[3:])
    with torch.no_grad():
        fr.render_rays_fused(m, f, c, _t(ro), _t(rd), _t(bc), NEAR, FAR, 8, 8)
        fr.fused_render_delta(m, f, c, _t(ro), _t(rd), z_prev, w_prev, lo, hi,
                              _t(bc), FAR, 3, 12)
    assert fr.launch_counts == {"fused_render_rays": 0,
                                "fused_render_coarse_hier": 0,
                                "fused_render_delta": 0}
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
    zp = torch.empty((8, 16), device="meta")
    band = torch.empty((8,), device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="expected cuda"):
        fr.fused_render_delta(m, f, c, meta["ro"], meta["rd"], zp, zp, band,
                              band, meta["bc"], FAR, 3, 12)
    with pytest.raises(ValueError, match="n_importance > 1"):
        fr.fused_render_coarse_hier(m, f, c, _t(ro), _t(rd), _t(bc), NEAR,
                                    FAR, 16, 1)
    for s_uni, s_imp in ((1, 12), (3, 1)):
        with pytest.raises(ValueError, match="s_uni >= 2 and s_imp >= 2"):
            fr.fused_render_delta(m, f, c, meta["ro"], meta["rd"], zp, zp,
                                  band, band, meta["bc"], FAR, s_uni, s_imp)


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
