"""The temporal depth-cache renderer of the PyTorch port (head field)
against the JAX package: band estimation and dilation, ray selection,
keyframe exactness, delta frames (all rays, delta_keep-pruned, the torch
chain), rolling refresh, delta-frame geometry, the foreground prior and
the renderer's refusals.

Inputs come from numpy with a fixed seed; weights go across through the
bridge. The JAX side runs as its own tests run it on the CPU: its kernels
in interpret mode, its delta frames through the XLA chain. Tolerances:
band and dilation 2e-6 (f32 on both sides); a keyframe against the
port's frame renderer 2e-5 (the same computation); frames against JAX
3e-2 with correlation > 0.999, the bound of the fused kernels' tests (both
sides round weights and activations to bf16). Comparisons that run
through the delta-frame feedback use softplus density, so every CDF bin
stays above sample_pdf's 1e-5 floor (ROADMAP.md C)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.eval import renderer as jax_renderer
from idealnerf_tpu.eval import temporal as jtm
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval import temporal as tm
from idealnerf_tpu_torch.eval.renderer import (
    foreground_prior, make_frame_renderer,
)
from idealnerf_tpu_torch.train.state import init_params

SMALL = dict(dim_aud=16, dim_expr=8, dim_latent=4, netdepth=6, netwidth=64,
             N_samples=16, N_importance=16)
NEAR, FAR = 0.5, 1.5


def _pose(tx=0.0, ty=0.0, tz=0.9, rot=None):
    r = np.eye(3, dtype=np.float32) if rot is None else rot
    return np.concatenate([r, np.array([[tx], [ty], [tz]], np.float32)],
                          1).astype(np.float32)


class _Scene:
    """A random field of both packages (bridged weights) over a random
    plate, as tests/test_temporal.py:_random_setup builds it."""

    def __init__(self, H=24, W=24, **kw):
        kw = {**SMALL, **kw}
        self.cfg, self.jcfg = ExperimentConfig(**kw), JaxConfig(**kw)
        self.ncfg, self.rc = self.cfg.face_nerf_config(), self.cfg.render_config()
        self.H, self.W, self.focal = H, W, 1.5 * H
        self.cx, self.cy = W / 2.0, H / 2.0
        self.params = init_params(self.cfg, 1,
                                  torch.Generator().manual_seed(0)).params
        self.jparams = jax.tree.map(jnp.asarray,
                                    bridge.params_to_jax(self.params))
        rng = np.random.RandomState(1)
        self.bc = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        self.cond = dict(aud=rng.randn(16).astype(np.float32),
                         expr=rng.randn(8).astype(np.float32),
                         latent=np.ones(4, np.float32))

    def renderer(self, **kw):
        return tm.make_temporal_frame_renderer(
            self.ncfg, self.H, self.W, self.focal, NEAR, FAR, self.rc,
            cx=kw.pop("cx", self.cx), cy=kw.pop("cy", self.cy), **kw)

    def jax_renderer(self, **kw):
        return jtm.make_temporal_frame_renderer(
            self.jcfg.face_nerf_config(), self.H, self.W, self.focal, NEAR,
            FAR, self.jcfg.render_config(), cx=self.cx, cy=self.cy, **kw)

    def render(self, r, pose, cache=None):
        frame, cache = r(self.params, torch.from_numpy(pose),
                         torch.from_numpy(self.bc), cache=cache,
                         **{k: torch.from_numpy(v)
                            for k, v in self.cond.items()})
        return frame.numpy(), cache

    def jax_render(self, r, pose, cache=None):
        frame, cache = r(self.jparams, jnp.asarray(pose), jnp.asarray(self.bc),
                         cache=cache,
                         **{k: jnp.asarray(v) for k, v in self.cond.items()})
        return np.asarray(frame), cache


def _agree(got, want):
    np.testing.assert_allclose(got, want, atol=3e-2)
    c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert c > 0.999, c


# ---------------------------------------------------------------- units

def test_fg_band_matches_jax():
    """The cases of tests/test_temporal.py:16-32 (concentrated, plate-only
    and bimodal mass) plus random rays: lo, hi and mass to 2e-6."""
    S = 33
    z = np.tile(np.linspace(0.5, 1.5, S, dtype=np.float32)[None], (3, 1))
    w = np.zeros((3, S), np.float32)
    w[0, 10:14] = 0.25
    w[1, -1] = 0.9
    w[2, 5] = w[2, 20] = 0.5
    rng = np.random.RandomState(0)
    zr = np.sort(rng.uniform(NEAR, FAR, (64, S)), -1).astype(np.float32)
    wr = (rng.uniform(0, 1, (64, S)) ** 3 / 8).astype(np.float32)
    for zz, ww in ((z, w), (zr, wr)):
        got = tm.fg_band(torch.from_numpy(zz), torch.from_numpy(ww))
        want = jtm.fg_band(jnp.asarray(zz), jnp.asarray(ww))
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6,
                                       rtol=0)
    lo, hi, mass = tm.fg_band(torch.from_numpy(z), torch.from_numpy(w))
    assert z[0, 9] <= lo[0] <= z[0, 11] and z[0, 12] <= hi[0] <= z[0, 14]
    assert mass[0] > 0.9 and mass[1] < 1e-6
    assert lo[2] <= z[0, 5] + 1e-6 and hi[2] >= z[0, 20] - 1e-6


@pytest.mark.parametrize("case", ["one-valid", "random-subset"])
def test_dilate_bands_matches_jax(case):
    """tests/test_temporal.py:35-47's single valid ray, and random bands
    and validity over a shuffled subset of the grid: 2e-6."""
    H, W = 8, 10
    rng = np.random.RandomState(3)
    if case == "one-valid":
        sel = np.arange(H * W, dtype=np.int32)
        lo = np.full(H * W, 0.9, np.float32)
        hi = np.full(H * W, 1.1, np.float32)
        valid = np.zeros(H * W, bool)
        valid[3 * W + 3] = True
        radius = 1
    else:
        sel = rng.permutation(H * W)[:57].astype(np.int32)
        lo = rng.uniform(0.5, 1.0, 57).astype(np.float32)
        hi = (lo + rng.uniform(0.0, 0.5, 57)).astype(np.float32)
        valid = rng.uniform(size=57) < 0.3
        radius = 2
    got = tm.dilate_bands(torch.from_numpy(lo), torch.from_numpy(hi),
                          torch.from_numpy(valid),
                          torch.from_numpy(sel).long(), H, W, radius, 0.5,
                          1.5)
    want = jtm.dilate_bands(jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(valid), jnp.asarray(sel), H, W,
                            radius, 0.5, 1.5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6,
                                   rtol=0)
    if case == "one-valid":
        lo_d = got[0].numpy().reshape(H, W)
        hi_d = got[1].numpy().reshape(H, W)
        assert np.allclose(lo_d[2:5, 2:5], 0.9)
        assert np.allclose(hi_d[2:5, 2:5], 1.1)
        assert lo_d[0, 0] == 0.5 and hi_d[7, 7] == 1.5


@pytest.mark.parametrize("roll_k", [0, 3, 7])
def test_prior_selection_and_roll_padding_match_jax(roll_k):
    """_prior_sel (prior rays first, stable, 256-aligned) and
    _pad_sel_for_roll (repeat the last ray) equal the JAX package's."""
    rng = np.random.RandomState(roll_k)
    mask = rng.uniform(size=(23, 25)) < 0.4
    sel = tm._prior_sel(mask, 23 * 25)
    np.testing.assert_array_equal(sel, jtm._prior_sel(mask, 23 * 25))
    assert sel.shape == (min(23 * 25, -(-int(mask.sum()) // 256) * 256),)
    assert mask.reshape(-1)[sel[:mask.sum()]].all()
    if roll_k:
        got = tm._pad_sel_for_roll(sel, roll_k)
        np.testing.assert_array_equal(got,
                                      jtm._pad_sel_for_roll(sel, roll_k))
        assert len(got) % roll_k == 0 and (got[len(sel):] == sel[-1]).all()


def test_keep_ranking_breaks_ties_as_jax_top_k():
    """The delta_keep ranking max-dilates the mass grid, which holds many
    exact ties; the port's stable descending sort must keep the same rays
    as jax.lax.top_k (ties to the lower index)."""
    H = W = 32
    rng = np.random.RandomState(5)
    sel = np.arange(H * W, dtype=np.int32)
    # few distinct values: plateaus in the dilated grid and ties between
    # whole plateaus
    mass = rng.choice([0.0, 0.25, 0.5, 1.0], size=H * W,
                      p=[0.7, 0.1, 0.1, 0.1]).astype(np.float32)
    args = (H, W, 40.0, None, None)
    kw = dict(s_delta=8, band_pad_frac=0.02, min_band_frac=0.04,
              dilate_px=2, fg_thresh=0.2, tag="head", delta_keep=0.5,
              roll_k=4)
    cfg = ExperimentConfig(**SMALL)
    port = tm._field_pipeline(cfg.face_nerf_config(), *args,
                              cfg.render_config(), (NEAR, FAR), sel, **kw)
    jcfg = JaxConfig(**SMALL)
    ref = jtm._field_pipeline(jcfg.face_nerf_config(), *args,
                              jcfg.render_config(), jnp.float32, (NEAR, FAR),
                              jnp.asarray(sel), **kw)
    got = port.roll.select(torch.from_numpy(mass)).numpy()
    want = np.asarray(ref.roll.select(jnp.asarray(mass)))
    assert got.shape == (512,)
    np.testing.assert_array_equal(got, want)


def test_foreground_prior_matches_jax():
    ds = make_synthetic_dataset(n_frames=3, H=40, W=40, dim_expr=8)
    jds = jax_synthetic(n_frames=3, H=40, W=40, dim_expr=8)
    for head_parse in (False, True):
        mask, k = foreground_prior(ds, margin=3, head_parse=head_parse)
        jmask, jk = jax_renderer.foreground_prior(jds, margin=3,
                                                  head_parse=head_parse)
        np.testing.assert_array_equal(mask, jmask)
        assert k == jk and k % 256 == 0 and mask.any()


@pytest.mark.parametrize("case", ["roll-k-1", "cycle-without-cache"])
def test_head_renderer_refusals(case):
    """A rolling period of 1 is refused at construction (the field builds
    no rolling stages for it); render.cycle renders delta frames only, so
    it needs a keyframe's or a delta frame's cache."""
    sc = _Scene(H=8, W=8)
    if case == "roll-k-1":
        with pytest.raises(ValueError, match="roll_k"):
            sc.renderer(s_delta=8, roll_k=1)
        return
    with pytest.raises(ValueError, match="cache"):
        sc.renderer(s_delta=8).cycle(sc.params,
                                     torch.from_numpy(_pose())[None],
                                     torch.from_numpy(sc.bc), None)


# ------------------------------------------------------------- renderer

def test_keyframe_equals_frame_renderer():
    """A temporal keyframe is the full fused frame (2e-5), unmasked and
    under an all-true prior; a delta frame under a prior is finite and
    the plate outside it (up to the 256-alignment padding)."""
    sc = _Scene()
    full = make_frame_renderer(sc.ncfg, sc.H, sc.W, sc.focal, NEAR, FAR,
                               sc.rc, cx=sc.cx, cy=sc.cy)
    with torch.no_grad():
        ref = full(sc.params, torch.from_numpy(_pose()),
                   torch.from_numpy(sc.bc),
                   **{k: torch.from_numpy(v) for k, v in sc.cond.items()})
    frame, cache = sc.render(sc.renderer(s_delta=8), _pose())
    np.testing.assert_allclose(frame, ref.numpy(), atol=2e-5)
    lo, hi = cache[0].numpy(), cache[1].numpy()
    assert (lo >= NEAR - 1e-6).all() and (hi <= FAR + 1e-6).all()
    assert (lo <= hi + 1e-6).all()
    frame, _ = sc.render(sc.renderer(
        s_delta=8, prior_mask=np.ones((sc.H, sc.W), bool)), _pose())
    np.testing.assert_allclose(frame, ref.numpy(), atol=2e-5)

    mask = np.zeros((sc.H, sc.W), bool)
    mask[3:20, 5:19] = True
    r = sc.renderer(s_delta=8, prior_mask=mask)
    _, c0 = sc.render(r, _pose())
    f1, _ = sc.render(r, _pose(), c0)
    assert np.isfinite(f1).all()
    n_pad = min(sc.H * sc.W, -(-int(mask.sum()) // 256) * 256) - mask.sum()
    off = np.abs(f1[~mask] - sc.bc[~mask]).max(-1) >= 1e-6
    assert off.sum() <= n_pad


@pytest.mark.parametrize("kw", [
    dict(s_delta=8), dict(s_delta=8, delta_keep=0.5),
    dict(s_delta=4, dilate_every=2)],
    ids=["keep1.0", "keep0.5", "chain-s4-dilate2"])
def test_frames_match_jax(kw):
    """A keyframe and two delta frames at moved poses against the JAX
    renderer, per frame 3e-2 and correlation > 0.999. s_delta 8 is one
    delta-kernel launch per delta frame (the kernel's plain version here);
    s_delta 4 leaves one importance depth, so it takes the torch chain of
    depth placement + fine pass, with the thinned dilation cadence."""
    sc = _Scene(density_activation="softplus")
    poses = [_pose(), _pose(0.03, 0.02, 0.92), _pose(-0.02, 0.04, 0.88)]
    r, jr = sc.renderer(**kw), sc.jax_renderer(**kw)
    assert r.field.uses_delta_kernel == (kw["s_delta"] >= 5)
    cache = jcache = None
    for pose in poses:
        frame, cache = sc.render(r, pose, cache)
        want, jcache = sc.jax_render(jr, pose, jcache)
        _agree(frame, want)
    if "delta_keep" in kw:
        # the same kept rays; two plateaus of the dilated mass grid within
        # bf16 noise of each other may rank in either order
        np.testing.assert_array_equal(np.sort(cache["keep"].numpy()),
                                      np.sort(np.asarray(jcache["keep"])))


def test_delta_keep_freezes_weak_rays():
    """tests/test_temporal.py:165-191: a pruned delta frame re-renders at
    most the k_keep kept rays; every other pixel holds the keyframe."""
    sc = _Scene()
    r = sc.renderer(s_delta=8, delta_keep=0.5)
    f0, c0 = sc.render(r, _pose())
    assert c0["keep"].shape == (256,)       # 576 rays * 0.5, 256-aligned
    f1, c1 = sc.render(r, _pose(0.2, 0.1, 1.1), c0)
    assert np.isfinite(f1).all()
    changed = (np.abs(f1 - f0).max(-1) > 1e-7).sum()
    assert 0 < changed <= 256, changed
    f2, _ = sc.render(r, _pose(), c1)
    assert np.isfinite(f2).all()


def test_delta_rays_match_keyframe_geometry():
    """tests/test_temporal.py:214-243: a delta frame at the keyframe's
    own rotated pose with an off-centre principal point agrees with the
    keyframe above 20 dB (a transposed rotation or a cx/cy sign error in
    the delta path's direction table drops it to about 10 dB)."""
    sc = _Scene(H=32, W=32)
    th = 0.35
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    pose = _pose(0.3, 0.1, 0.9, rot)
    r = sc.renderer(s_delta=32, cx=32 * 0.41, cy=32 * 0.57)
    kf, c0 = sc.render(r, pose)
    delta, _ = sc.render(r, pose, c0)
    psnr = -10.0 * np.log10(np.mean((kf - delta) ** 2) + 1e-12)
    assert psnr > 20.0, psnr


def test_rolling_refresh():
    """tests/test_temporal.py:688-766: frame 0 is the full frame (2e-5);
    the phase wraps after K frames and the keep set is re-ranked at its
    size; slice p's fine render equals rows p::K of the keyframe's; the
    cache keeps the s_delta width, the plate pin at far and bands inside
    the field interval. H*W % K != 0 exercises the padded selection."""
    sc = _Scene(H=23, W=25)
    K = 4
    full = make_frame_renderer(sc.ncfg, sc.H, sc.W, sc.focal, NEAR, FAR,
                               sc.rc, cx=sc.cx, cy=sc.cy)
    cond = {k: torch.from_numpy(v) for k, v in sc.cond.items()}
    with torch.no_grad():
        ref = full(sc.params, torch.from_numpy(_pose()),
                   torch.from_numpy(sc.bc), **cond).numpy()
    r = sc.renderer(s_delta=8, delta_keep=0.75, roll_k=K)
    frame, cache = sc.render(r, _pose())
    np.testing.assert_allclose(frame, ref, atol=2e-5)
    assert cache["phase"] == 0
    keep0 = cache["dev"]["keep"]
    for i in range(K):
        assert cache["phase"] == i
        frame, cache = sc.render(r, _pose(), cache)
        assert frame.shape == (sc.H, sc.W, 3) and np.isfinite(frame).all()
    assert cache["phase"] == 0 and cache["dev"]["keep"].shape == keep0.shape
    dev = cache["dev"]
    assert dev["z"].shape[-1] == 8 and dev["w"].shape[-1] == 8
    assert (dev["lo"] >= NEAR - 1e-6).all() and (dev["hi"] <= FAR + 1e-6).all()

    field = r.field
    c = tuple(cond[k] for k in ("aud", "expr", "latent"))
    pose, bc = torch.from_numpy(_pose()), torch.from_numpy(sc.bc)
    with torch.no_grad():
        st = field.kf_coarse(sc.params, pose, bc, c)
        rgb_kf = field.kf_fine(sc.params, st, c)[0].numpy()
        for p in (0, K - 1):
            sl = field.roll.slice_fine(
                sc.params, field.roll.slice_coarse(sc.params, pose, bc, c, p),
                c)
            d = np.abs(sl["rgb"].numpy() - rgb_kf[p::K])
            assert d.max() < 5e-3 and (d <= 2e-5).mean() > 0.9, d.max()
            z = sl["z"].numpy()
            assert z.shape[-1] == 8 and np.allclose(z[:, -1], FAR)
            assert (np.diff(z[:, :-1], axis=-1) >= -1e-6).all()


def test_roll_merge_carries_band_of_invalid_slice():
    """tests/test_temporal.py:869-915: a refreshed slice with no
    foreground mass keeps its rays' previous bands; a valid one
    overwrites them."""
    sc = _Scene()
    K, p = 4, 1
    roll = sc.renderer(s_delta=8, roll_k=K).field.roll
    n = sc.H * sc.W
    cache = dict(lo=torch.full((n,), 0.6), hi=torch.full((n,), 1.2),
                 **{k: torch.zeros(n, 3) for k in ("rgb", "lw", "fg")},
                 z=torch.zeros(n, 8), w=torch.zeros(n, 8),
                 mass=torch.zeros(n))
    m = n // K
    sl = dict(lo=torch.full((m,), NEAR), hi=torch.full((m,), FAR),
              valid=torch.zeros(m, dtype=torch.bool),
              **{k: torch.ones(m, 3) for k in ("rgb", "lw", "fg")},
              z=torch.ones(m, 8), w=torch.ones(m, 8), mass=torch.ones(m))
    merged = roll.merge(cache, sl, p)
    assert torch.all(merged["lo"] == 0.6) and torch.all(merged["hi"] == 1.2)
    assert torch.all(merged["rgb"].reshape(m, K, 3)[:, p] == 1)
    assert torch.all(merged["rgb"].reshape(m, K, 3)[:, p + 1] == 0)
    sl["valid"][:] = True
    merged = roll.merge(cache, sl, p)
    assert torch.all(merged["lo"].reshape(m, K)[:, p] == NEAR)
    assert torch.all(merged["lo"].reshape(m, K)[:, 0] == 0.6)
