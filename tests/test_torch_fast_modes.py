"""The per-frame fast modes of the PyTorch port against the JAX package:
the plain tiled frame (``render_frame``, ``render_frame_outputs``), the
pruned and prior-masked frames on both routes (field fns; the fused
kernels), ``make_pruned_frame_renderer``, ``make_composite_fast_renderer``,
the occupancy prior and its cache, ``reenact(fast_keep=, bounds=)`` and
the CLIs' fast flags on the CPU.

Tolerances: the fused routes round weights and activations to bf16 on
both sides (JAX's Pallas kernels in interpret mode, the port's plain
versions of K1/K2): 3e-2 with a correlation above 0.999, the bound of
tests/test_torch_render_val.py. The field-fn routes are f32 on both
sides: without importance samples they agree to 1e-5. With them the
fine depths come from ``sample_pdf``, whose CDF the port sums in f64 and
pins at 1 (ROADMAP.md C): on the same coarse weights some rays' fine
depths move by up to about 2e-4 where the CDF is steep, so those frames
are held to the render bound, not to 1e-5. The occupancy masks are
compared bool for bool."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.eval import renderer as jr
from idealnerf_tpu.eval.reenact import reenact as jax_reenact
from idealnerf_tpu.models.face_nerf import fold_conditioning as jax_fold
from idealnerf_tpu.models.face_nerf import make_field_fn as jax_field_fn
from idealnerf_tpu.train.torso import torso_nerf_config as jax_torso_config
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.cli import eval_reenact, render_val, train_torso
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval import reenact as reenact_mod
from idealnerf_tpu_torch.eval import renderer as pr
from idealnerf_tpu_torch.eval.video import read_avi_frames
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.models.face_nerf import (
    fold_conditioning, make_field_fn,
)
from idealnerf_tpu_torch.train.head import HeadTrainer
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.train.torso import (
    init_torso_params, torso_nerf_config, torso_signal,
)

SMALL = dict(dim_aud=16, dim_expr=8, dim_latent=4, dim_aud_body=8,
             netdepth=4, netwidth=64, N_samples=8, N_importance=8,
             density_activation="softplus")
HW = 24
# the exactness tests: keep 1.0 keeps every ray when H*W is a multiple of
# 256, as the JAX package's fine budget k rounds down to one
FULL = 32
CLI_SMALL = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
             "--dim_aud_body", "16", "--netdepth", "4", "--netwidth", "64",
             "--N_samples", "8", "--N_importance", "8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-2)
    c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert c > 0.999, c


def _exact(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-5)


class Scene:
    """Seeded head (and torso) weights on both sides, one frame's
    conditioning, the synthetic subject's pose and plate."""

    def __init__(self, seed=0, hw=HW, torso=False, **over):
        kw = {**SMALL, **over}
        self.cfg, self.jcfg = ExperimentConfig(**kw), JaxConfig(**kw)
        self.ncfg, self.jncfg = (self.cfg.face_nerf_config(),
                                 self.jcfg.face_nerf_config())
        self.ds = make_synthetic_dataset(n_frames=2, H=hw, W=hw, dim_expr=8,
                                         with_torso=torso)
        self.hw = hw
        self.params = init_params(self.cfg, 2, torch.Generator().manual_seed(
            seed)).params
        self.jparams = jax.tree.map(jnp.asarray,
                                    bridge.params_to_jax(self.params))
        rng = np.random.RandomState(seed)
        self.aud = rng.randn(kw["dim_aud"]).astype(np.float32)
        self.expr = self.ds.exprs[1]
        self.latent = rng.randn(4).astype(np.float32)
        self.bc = self.ds.bc_img.astype(np.float32) / 255.0
        self.pose = self.ds.poses[1]
        if torso:
            self.torso = init_torso_params(
                self.cfg, torch.Generator().manual_seed(seed + 1))
            self.jtorso = jax.tree.map(
                jnp.asarray, bridge.torso_params_to_jax(self.torso))
            self.signal = torso_signal(
                torch.from_numpy(self.aud), torch.from_numpy(self.pose),
                self.cfg.dim_aud_body).numpy()

    # the conditioning on each side
    def cond(self):
        return tuple(torch.from_numpy(x) for x in
                     (self.aud, self.expr, self.latent))

    def jcond(self):
        return tuple(jnp.asarray(x) for x in
                     (self.aud, self.expr, self.latent))

    def fns(self):
        return tuple(make_field_fn(self.params[k], self.ncfg, *self.cond())
                     for k in ("coarse", "fine"))

    def jfns(self):
        return tuple(jax_field_fn(self.jparams[k], self.jncfg, *self.jcond())
                     for k in ("coarse", "fine"))

    def fused(self):
        return (self.params, self.ncfg,
                *(fold_conditioning(self.params[k], self.ncfg, *self.cond())
                  for k in ("coarse", "fine")))

    def jfused(self):
        return (self.jparams, self.jncfg,
                *(jax_fold(self.jparams[k], self.jncfg, *self.jcond())
                  for k in ("coarse", "fine")))

    def view(self):
        ds = self.ds
        return (self.hw, self.hw, ds.focal, torch.from_numpy(self.pose),
                torch.from_numpy(self.bc), ds.near, ds.far,
                self.cfg.render_config())

    def jview(self):
        ds = self.ds
        return (self.hw, self.hw, ds.focal, jnp.asarray(self.pose),
                jnp.asarray(self.bc), ds.near, ds.far,
                self.jcfg.render_config())

    def where(self):
        return dict(cx=self.ds.cx, cy=self.ds.cy)

    def prior(self, margin=2):
        return pr.foreground_prior(self.ds, margin=margin)


# ------------------------------------------------------ the plain frame

def _hold(got, want, n_imp, corr=True):
    """1e-5 without importance samples, else the render bound (with the
    correlation for colours only: acc and last_weight sit near 1 on every
    ray, where a correlation measures nothing)."""
    if not n_imp:
        _exact(got, want)
    elif corr:
        _agree(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=3e-2)


@pytest.mark.parametrize("n_imp", [0, 8])
def test_render_frame_and_outputs_match_jax(n_imp):
    """The plain tiled frame on f32 field fns (a ragged last tile of 200
    rays), its rgb and the outputs the depth probe reads, depth_band
    included."""
    s = Scene(N_importance=n_imp)
    kw = dict(**s.where(), tile=200)
    got = pr.render_frame(s.fns()[0], *s.view(), fine_fn=s.fns()[1], **kw)
    want = jr.render_frame(s.jfns()[0], *s.jview(), fine_fn=s.jfns()[1],
                           **kw)
    assert got.shape == (HW, HW, 3)
    _hold(got, want, n_imp)
    keys = ("acc_map", "last_weight", "depth_band", "rgb_fg")
    got = pr.render_frame_outputs(s.fns()[0], *s.view(), fine_fn=s.fns()[1],
                                  keys=keys, **kw)
    want = jr.render_frame_outputs(s.jfns()[0], *s.jview(),
                                   fine_fn=s.jfns()[1], keys=keys, **kw)
    assert got["depth_band"].shape == (HW, HW, 2)
    for k in keys:
        _hold(got[k], want[k], n_imp, corr=k.startswith("rgb"))


# ------------------------------------------------------ pruned and masked

@pytest.mark.parametrize("route,n_imp", [("field_fn", 0), ("field_fn", 8),
                                         ("fused", 8)])
def test_render_frame_pruned_matches_jax(route, n_imp):
    s = Scene(N_importance=n_imp)
    kw = dict(**s.where(), keep_fraction=0.5, tile=256, fine_tile=256)
    if route == "fused":
        got = pr.render_frame_pruned(None, None, *s.view(), fused=s.fused(),
                                     **kw)
        want = jr.render_frame_pruned(None, None, *s.jview(),
                                      fused=s.jfused(), **kw)
        _agree(got, want)
    else:
        got = pr.render_frame_pruned(*s.fns(), *s.view(), **kw)
        want = jr.render_frame_pruned(*s.jfns(), *s.jview(), **kw)
        _hold(got, want, n_imp)


@pytest.mark.parametrize("route,basis,n_imp", [
    ("field_fn", "frame", 0), ("field_fn", "mask", 0),
    ("field_fn", "frame", 8), ("fused", "frame", 8)])
def test_render_frame_prior_masked_matches_jax(route, basis, n_imp):
    s = Scene(N_importance=n_imp)
    mask, kc = s.prior()
    kw = dict(**s.where(), keep_fraction=0.5, coarse_tile=256,
              fine_tile=256, keep_basis=basis)
    if route == "fused":
        got = pr.render_frame_prior_masked(None, None, *s.view(), mask, kc,
                                           fused=s.fused(), **kw)
        want = jr.render_frame_prior_masked(None, None, *s.jview(),
                                            jnp.asarray(mask), kc,
                                            fused=s.jfused(), **kw)
        _agree(got, want)
    else:
        got = pr.render_frame_prior_masked(*s.fns(), *s.view(), mask, kc,
                                           **kw)
        want = jr.render_frame_prior_masked(*s.jfns(), *s.jview(),
                                            jnp.asarray(mask), kc, **kw)
        _hold(got, want, n_imp)


@pytest.mark.parametrize("masked,basis", [(False, "frame"), (True, "frame"),
                                          (True, "mask")],
                         ids=["unmasked", "masked-frame", "masked-mask"])
def test_pruned_frame_renderer_matches_jax(masked, basis):
    """The CLIs' route: K1 coarse, the keep ranking, sample_pdf, K1 fine,
    the scatter; masked, the prior's first rays and the plate outside."""
    s = Scene()
    mask, kc = s.prior() if masked else (None, None)
    kw = dict(keep_fraction=0.4, prior_mask=mask, k_coarse=kc,
              keep_basis=basis, **s.where())
    ds = s.ds
    want = jr.make_pruned_frame_renderer(
        s.jncfg, HW, HW, ds.focal, ds.near, ds.far, s.jcfg.render_config(),
        tile=256, fine_tile=256, **{**kw, "prior_mask": None if mask is None
                                    else jnp.asarray(mask)})(
        s.jparams, jnp.asarray(s.pose), jnp.asarray(s.bc),
        *s.jcond())
    fr.reset_launch_counts()
    got = pr.make_pruned_frame_renderer(
        s.ncfg, HW, HW, ds.focal, ds.near, ds.far, s.cfg.render_config(),
        **kw)(s.params, torch.from_numpy(s.pose), torch.from_numpy(s.bc),
              *s.cond())
    _agree(got, want)
    if masked:
        # outside the prior's k_coarse rays the frame is the plate exactly
        out = np.ones(HW * HW, bool)
        out[pr._prior_rays(mask, kc)] = False
        np.testing.assert_array_equal(got.numpy().reshape(-1, 3)[out],
                                      s.bc.reshape(-1, 3)[out])
    # on the CPU no kernel launches: the plain versions ran
    assert all(v == 0 for v in fr.launch_counts.values())


def test_top_k_breaks_ties_by_the_lowest_index_as_jax():
    """Empty rays score exactly 0: the selection keeps lax.top_k's order."""
    score = torch.tensor([0.0, 0.5, 0.0, 0.5, 0.0, 0.0, 1.0, 0.0])
    _, want = jax.lax.top_k(jnp.asarray(score.numpy()), 6)
    np.testing.assert_array_equal(pr._top_k(score, 6).numpy(),
                                  np.asarray(want))
    m = np.zeros((4, 4), bool)
    m[1, 2] = m[3, 0] = True
    _, want = jax.lax.top_k(jnp.asarray(m.reshape(-1), jnp.float32), 5)
    np.testing.assert_array_equal(pr._prior_rays(m, 5), np.asarray(want))


# ------------------------------------------------------ exactness, port alone

def test_pruned_renderer_keep_all_matches_full():
    """keep 1.0 reproduces the full hierarchical frame: the field-fn route
    the plain frame to 1e-5, the fused renderer the port's K2 + K1 frame
    exactly (the same plain chain on the CPU)."""
    s = Scene(hw=FULL)
    full = pr.render_frame(s.fns()[0], *s.view(), fine_fn=s.fns()[1],
                           **s.where(), tile=256)
    pruned = pr.render_frame_pruned(*s.fns(), *s.view(), keep_fraction=1.0,
                                    tile=256, **s.where())
    _exact(pruned, full)
    ds = s.ds
    args = (s.ncfg, FULL, FULL, ds.focal, ds.near, ds.far, s.cfg.render_config())
    call = (s.params, torch.from_numpy(s.pose), torch.from_numpy(s.bc),
            *s.cond())
    ref = pr.make_frame_renderer(*args, **s.where())(*call)
    for kw in (dict(), dict(prior_mask=np.ones((FULL, FULL), bool),
                            k_coarse=FULL * FULL)):
        got = pr.make_pruned_frame_renderer(*args, keep_fraction=1.0,
                                            **kw, **s.where())(*call)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    # an empty prior (an occupancy cut of an empty field) is the plate
    empty = pr.make_pruned_frame_renderer(
        *args, prior_mask=np.zeros((FULL, FULL), bool), k_coarse=0,
        **s.where())(*call)
    np.testing.assert_array_equal(empty.numpy(), s.bc)
    half = pr.render_frame_pruned(*s.fns(), *s.view(), keep_fraction=0.5,
                                  **s.where())
    assert half.shape == (FULL, FULL, 3) and torch.isfinite(half).all()


def test_prior_masked_renderer_full_mask_matches_full():
    """An all-true prior at keep 1.0 equals the full frame (1e-5); with a
    partial prior every pixel outside the k_coarse prior rays is the
    plate exactly."""
    s = Scene(hw=FULL)
    full = pr.render_frame(s.fns()[0], *s.view(), fine_fn=s.fns()[1],
                           **s.where(), tile=256)
    exact = pr.render_frame_prior_masked(
        *s.fns(), *s.view(), np.ones((FULL, FULL), bool), FULL * FULL,
        keep_fraction=1.0, coarse_tile=256, fine_tile=256, **s.where())
    _exact(exact, full)
    mask = np.zeros((FULL, FULL), bool)
    mask[4:24, 6:26] = True
    kc = 512
    partial = pr.render_frame_prior_masked(
        *s.fns(), *s.view(), mask, kc, keep_fraction=0.5, coarse_tile=256,
        fine_tile=256, **s.where())
    out = np.ones(FULL * FULL, bool)
    out[pr._prior_rays(mask, kc)] = False
    assert out.sum() > 0
    np.testing.assert_array_equal(partial.numpy().reshape(-1, 3)[out],
                                  s.bc.reshape(-1, 3)[out])


def _composite_call(s, torch_side=True):
    if torch_side:
        return ((s.params, s.torso, torch.from_numpy(s.pose),
                 torch.from_numpy(s.ds.poses[0]), torch.from_numpy(s.bc)),
                dict(aud=torch.from_numpy(s.aud),
                     signal=torch.from_numpy(s.signal),
                     expr=torch.from_numpy(s.expr),
                     latent=torch.from_numpy(s.latent)))
    return ((s.jparams, s.jtorso, jnp.asarray(s.pose),
             jnp.asarray(s.ds.poses[0]), jnp.asarray(s.bc)),
            dict(aud=jnp.asarray(s.aud), signal=jnp.asarray(s.signal),
                 expr=jnp.asarray(s.expr), latent=jnp.asarray(s.latent)))


def test_composite_fast_renderer_matches_full():
    """keep 1.0, unmasked and with all-true shared or per-field priors,
    reproduces the composite frame renderer exactly; per-field bounds
    equal to (near, far) change nothing; a partial prior leaves every
    pixel outside its rays the plate exactly."""
    s = Scene(hw=FULL, torso=True)
    ds = s.ds
    args = (s.ncfg, torso_nerf_config(s.cfg), FULL, FULL, ds.focal, ds.near,
            ds.far, s.cfg.render_config())
    a, kw = _composite_call(s)
    ref = pr.make_composite_frame_renderer(*args, **s.where())(*a, **kw)
    ones = np.ones((FULL, FULL), bool)
    for extra in (dict(), dict(prior_mask=ones, k_coarse=FULL * FULL),
                  dict(prior_mask_head=ones, prior_mask_torso=ones),
                  dict(bounds_head=(ds.near, ds.far),
                       bounds_torso=(ds.near, ds.far))):
        got = pr.make_composite_fast_renderer(
            *args, keep_head=1.0, keep_torso=1.0, **extra, **s.where())(
            *a, **kw)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    mask = np.zeros((FULL, FULL), bool)
    mask[4:30, 6:26] = True
    kc = ((int(mask.sum()) + 255) // 256) * 256
    fast = pr.make_composite_fast_renderer(
        *args, prior_mask=mask, k_coarse=kc, keep_head=0.5, keep_torso=0.5,
        **s.where())(*a, **kw)
    out = np.ones(FULL * FULL, bool)
    out[pr._prior_rays(mask, kc)] = False
    np.testing.assert_array_equal(fast.numpy().reshape(-1, 3)[out],
                                  s.bc.reshape(-1, 3)[out])
    with pytest.raises(ValueError, match="n_importance >= 2"):
        pr.make_composite_fast_renderer(
            *args[:-1], s.cfg.render_config().__class__(n_importance=1))
    with pytest.raises(ValueError, match="'fine' params"):
        pr.make_composite_fast_renderer(*args)(
            torch.nn.ModuleDict({"coarse": s.params["coarse"]}), *a[1:],
            **kw)


def _torso_prior(hw):
    """A torso prior that overlaps the head's only in part."""
    m = np.zeros((hw, hw), bool)
    m[hw // 2:, 3:hw - 5] = True
    return m


@pytest.mark.parametrize("mode", ["shared", "per_field", "per_field_bounds"])
def test_composite_fast_renderer_matches_jax(mode):
    """Per-field K2 coarse within its bounds, the torso-weighted keep
    ranking, K1 fine, and the union composite through the constant maps,
    at a size where the head's and the torso's priors differ."""
    s = Scene(torso=True)
    ds = s.ds
    mh, _ = pr.foreground_prior_fields(ds, margin=1)
    mt = _torso_prior(HW)
    assert (mh & mt).any() and (mh & ~mt).any() and (mt & ~mh).any()
    mask, kc = s.prior()
    extra = {"shared": dict(prior_mask=mask, k_coarse=kc),
             "per_field": dict(prior_mask_head=mh, prior_mask_torso=mt),
             "per_field_bounds": dict(
                 prior_mask_head=mh, prior_mask_torso=mt,
                 bounds_head=(ds.near + 0.05, ds.far - 0.1),
                 bounds_torso=(ds.near + 0.1, ds.far))}[mode]
    jextra = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in extra.items()}
    kw = dict(keep_head=0.4, keep_torso=0.5, **s.where())
    want = jr.make_composite_fast_renderer(
        s.jncfg, jax_torso_config(s.jcfg), HW, HW, ds.focal, ds.near,
        ds.far, s.jcfg.render_config(), **kw, **jextra)
    got = pr.make_composite_fast_renderer(
        s.ncfg, torso_nerf_config(s.cfg), HW, HW, ds.focal, ds.near, ds.far,
        s.cfg.render_config(), **kw, **extra, _expose_stages=True)
    ja, jkw = _composite_call(s, torch_side=False)
    a, tkw = _composite_call(s)
    _agree(got(*a, **tkw), want(*ja, **jkw))
    if mode == "per_field":
        # the selections and the union maps' sets, against JAX's own
        jstages = jr.make_composite_fast_renderer(
            s.jncfg, jax_torso_config(s.jcfg), HW, HW, ds.focal, ds.near,
            ds.far, s.jcfg.render_config(), **kw, **jextra,
            _expose_stages=True).stages
        for k in ("sel_h", "sel_t", "sel_u"):
            np.testing.assert_array_equal(got.stages[k],
                                          np.asarray(jstages[k]))


def test_composite_keep_ranking_matches_jax():
    """stage_keep on the same scores as JAX's: the head's fine set ranks
    by acc - last weight times the torso's transmittance through h2t (1.0
    off the torso's rays), with exact ties at 0."""
    s = Scene(torso=True)
    ds = s.ds
    mh, _ = pr.foreground_prior_fields(ds, margin=1)
    mt = _torso_prior(HW)
    kw = dict(keep_head=0.3, keep_torso=0.4, prior_mask_head=mh,
              prior_mask_torso=mt, _expose_stages=True, **s.where())
    got = pr.make_composite_fast_renderer(
        s.ncfg, torso_nerf_config(s.cfg), HW, HW, ds.focal, ds.near, ds.far,
        s.cfg.render_config(), **kw).stages
    want = jr.make_composite_fast_renderer(
        s.jncfg, jax_torso_config(s.jcfg), HW, HW, ds.focal, ds.near,
        ds.far, s.jcfg.render_config(), **kw).stages
    rng = np.random.RandomState(3)
    n_h, n_t = len(got["sel_h"]), len(got["sel_t"])
    acc_h, lw_h = rng.rand(n_h).astype(np.float32), np.zeros(n_h, np.float32)
    acc_h[::3] = 0.0      # empty rays: exact ties
    acc_t, lw_t = rng.rand(n_t).astype(np.float32), rng.rand(n_t).astype(
        np.float32)
    k_got = got["keep"](*(torch.from_numpy(x) for x in
                          (acc_h, lw_h, acc_t, lw_t)))
    k_want = want["keep"](*(jnp.asarray(x) for x in
                            (acc_h, lw_h, acc_t, lw_t)))
    for g, w in zip(k_got, k_want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ occupancy prior

def _probes(s, n=2):
    poses = [s.ds.poses[i] for i in range(n)]
    rng = np.random.RandomState(7)
    conds = [(rng.randn(16).astype(np.float32), s.ds.exprs[i])
             for i in range(n)]
    return poses, conds


def test_field_occupancy_prior_matches_jax():
    """The coarse-mass cut of the base prior, bool for bool, on a field
    whose probe masses stay clear of ``thresh`` (f32 on both sides)."""
    s = Scene(netwidth=32, density_activation="relu")
    ds = s.ds
    base = np.zeros((HW, HW), bool)
    base[2:21, 3:22] = True
    poses, conds = _probes(s)
    thresh, margin = 0.15, 1
    args = (HW, HW, ds.focal)
    tconds = [tuple(torch.from_numpy(x) for x in c) for c in conds]
    kw = dict(cx=ds.cx, cy=ds.cy, thresh=thresh, margin=margin)
    got, k = pr.field_occupancy_prior(
        s.ncfg, s.params, *args, poses, tconds, ds.near, ds.far,
        s.cfg.render_config(), base, latent=torch.from_numpy(s.latent), **kw)
    want, k_want = jr.field_occupancy_prior(
        s.jncfg, s.jparams, *args, poses,
        [tuple(jnp.asarray(x) for x in c) for c in conds], ds.near, ds.far,
        s.jcfg.render_config(), jnp.asarray(base),
        latent=jnp.asarray(s.latent), **kw)
    # the premise: every probe mass is clear of the threshold by far more
    # than the two packages' masses differ (f32 sums, about 1e-9 here)
    sel = np.nonzero(base.reshape(-1))[0]
    ccfg = s.cfg.render_config().__class__(n_samples=8, n_importance=0,
                                            perturb=False)
    for pose, c in zip(poses, tconds):
        o, d = pr.get_rays(HW, HW, ds.focal, torch.from_numpy(pose), ds.cx,
                           ds.cy)
        cf = make_field_fn(s.params["coarse"], s.ncfg, *c,
                           torch.from_numpy(s.latent))
        with torch.no_grad():
            w = pr.render_rays(cf, o.reshape(-1, 3)[sel],
                               d.reshape(-1, 3)[sel],
                               torch.zeros(len(sel), 3), ds.near, ds.far,
                               ccfg)["weights"]
        assert (w[:, :-1].sum(-1) - thresh).abs().min() > 1e-6
    assert got.dtype == bool and got.shape == (HW, HW)
    assert 0 < got.sum() < base.sum() and not (got & ~base).any()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert k == k_want


def test_cached_occupancy_prior_keys_on_every_input(tmp_path):
    """Read back without a probe on the same inputs; recomputed when the
    threshold, the margin, the probe set, the bounds or the base mask
    changes (the JAX package's file is keyed on the step alone)."""
    calls = []
    mask = np.zeros((8, 8), bool)
    mask[2:5, 3:6] = True

    def compute():
        calls.append(1)
        return mask, 64

    rng = np.random.RandomState(0)
    poses = [rng.randn(3, 4).astype(np.float32) for _ in range(2)]
    conds = [(torch.from_numpy(rng.randn(4).astype(np.float32)), None)
             for _ in range(2)]
    key = dict(base_mask=np.ones((8, 8), bool), poses=poses, conds=conds,
               near=0.3, far=0.9, thresh=1e-3, margin=6)
    got, k = pr.cached_occupancy_prior(str(tmp_path), 100, compute, **key)
    again, k2 = pr.cached_occupancy_prior(str(tmp_path), 100, compute, **key)
    assert len(calls) == 1 and k == k2 == 64
    np.testing.assert_array_equal(again, got)
    changed = [dict(thresh=2e-3), dict(margin=4), dict(poses=poses[:1],
                                                       conds=conds[:1]),
               dict(conds=[(c[0] + 1, None) for c in conds]),
               dict(near=0.35), dict(base_mask=mask)]
    for n, ch in enumerate(changed, 2):
        pr.cached_occupancy_prior(str(tmp_path), 100, compute,
                                  **{**key, **ch})
        assert len(calls) == n, ch
    pr.cached_occupancy_prior(str(tmp_path), 200, compute, **key)
    assert len(calls) == len(changed) + 2
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("occ_prior_")]) == len(changed) + 2
    pr.cached_occupancy_prior(None, 100, compute, **key)
    assert len(calls) == len(changed) + 3


# ------------------------------------------------------ reenact and CLIs

REENACT = dict(dim_aud=32, dim_expr=8, dim_latent=4, dim_aud_body=16,
               netdepth=4, netwidth=64, smo_size=4, N_samples=8,
               N_importance=8, density_activation="softplus")


@pytest.mark.parametrize("torso,prior,bounds", [
    (False, False, None), (False, True, (0.7, 2.2)),
    (True, True, {"head": (0.7, 2.2), "torso": (0.8, 2.375)})],
    ids=["head", "head-prior-bounds", "composite-prior-bounds"])
def test_reenact_fast_matches_jax(torso, prior, bounds):
    jcfg, cfg = JaxConfig(**REENACT), ExperimentConfig(**REENACT)
    ds = make_synthetic_dataset(n_frames=2, H=24, W=24, dim_expr=8,
                                with_torso=torso)
    st = init_params(cfg, ds.size, torch.Generator().manual_seed(4))
    run = dict(driving_exprs=ds.exprs, max_frames=2, fast_keep=0.5,
               use_prior=prior, bounds=bounds)
    jrun = dict(run)
    tp = None
    if torso:
        tp = init_torso_params(cfg, torch.Generator().manual_seed(5))
        jrun["torso_params"] = jax.tree.map(
            jnp.asarray, bridge.torso_params_to_jax(tp))
    want = jax_reenact(jcfg, jax.tree.map(jnp.asarray,
                                          bridge.params_to_jax(st.params)),
                       ds, ds.auds, latent_codes=jnp.asarray(
                           st.latent_codes.detach().numpy()), **jrun)
    times = []
    got = reenact_mod.reenact(cfg, st.params, ds, ds.auds,
                              latent_codes=st.latent_codes, torso_params=tp,
                              frame_times=times, **run)
    assert got.shape == (2, 24, 24, 3) and len(times) == 2
    for g, w in zip(got, np.asarray(want)):
        _agree(g, w)


_BOUNDS_ERRORS = {
    "tuple-with-torso": (dict(bounds=(0.3, 0.8), torso_params=object(),
                              fast_keep=0.4), "per-field bands"),
    "dict-without-fast": (dict(bounds={"head": (0.3, 0.8)},
                               torso_params=object()), "FAST/temporal"),
    "dict-head-only": (dict(bounds={"head": (0.3, 0.8)}, fast_keep=0.4),
                       "head-only renders take"),
    "temporal-with-fast": (dict(temporal=3, fast_keep=0.4), "incompatible"),
}


@pytest.mark.parametrize("kw,match", _BOUNDS_ERRORS.values(),
                         ids=_BOUNDS_ERRORS.keys())
def test_reenact_refuses_as_jax(kw, match):
    """JAX's ValueErrors, message for message: both packages raise."""
    for fn, cfg in ((reenact_mod.reenact, ExperimentConfig()),
                    (jax_reenact, JaxConfig())):
        with pytest.raises(ValueError, match=match):
            fn(cfg, None, None, None, **kw)


def _cli(tmp_path, hw="24"):
    return ["--device", "cpu", "--synthetic", "2", "--synthetic_hw", hw,
            *CLI_SMALL, "--basedir", str(tmp_path)]


def test_fast_clis_on_cpu(tmp_path):
    """render_val --pruned/--prior_masked/--occ_prior/--tighten_bounds and
    eval_reenact --fast/--prior/--tighten_bounds on a checkpoint: each
    writes its .avi; the band and the occupancy prior are cached beside
    the checkpoint and read back on the next run."""
    cfg = ExperimentConfig(**{k: v for k, v in REENACT.items()
                              if k != "smo_size"})
    ds = make_synthetic_dataset(n_frames=2, H=24, W=24, dim_expr=8)
    ckpt = str(tmp_path / "head")
    HeadTrainer(cfg, ds, seed=0, ckpt_dir=ckpt).save()
    argv = [*_cli(tmp_path), "--head_ckpt", ckpt]
    fr.reset_launch_counts()
    res = render_val.main([*argv, "--pruned", "40", "--prior_masked", "1",
                           "--occ_prior", "1", "--tighten_bounds", "1",
                           "--save_path", str(tmp_path / "rv")])
    near, far = res["tightened_bounds"]
    assert ds.near <= near < far <= ds.far
    assert res["frames"].shape == (2, 24, 24, 3)
    assert math.isfinite(res["psnr"]) and math.isfinite(res["frame_ms"])
    assert read_avi_frames(str(tmp_path / "rv" / "exp_val.avi"))[0].shape == (
        2, 24, 24, 3)
    cached = sorted(f for f in os.listdir(ckpt) if not f.startswith("step"))
    assert cached[0] == "depth_bands.json" and len(cached) == 2
    assert cached[1].startswith("occ_prior_0_")
    again = render_val.main([*argv, "--pruned", "1", "--prior_masked", "1",
                             "--occ_prior", "1", "--tighten_bounds", "1",
                             "--keep_basis", "mask"])
    assert again["tightened_bounds"] == (near, far)
    assert sorted(f for f in os.listdir(ckpt)
                  if not f.startswith("step")) == cached

    out = eval_reenact.main([*argv, "--fast", "40", "--prior", "1",
                             "--tighten_bounds", "1", "--save_path",
                             str(tmp_path / "re")])
    assert out["frames"] == 2 and np.isfinite(out["video"]).all()
    assert read_avi_frames(str(tmp_path / "re" / "exp.avi"))[0].shape == (
        2, 24, 24, 3)
    torso = train_torso.main([*argv, "--steps", "1", "--N_rand", "64"])[
        "ckpt_dir"]
    out = eval_reenact.main([*argv, "--torso_ckpt", torso, "--fast", "40",
                             "--prior", "1", "--save_path",
                             str(tmp_path / "comp")])
    assert out["frames"] == 2 and np.isfinite(out["video"]).all()
    assert read_avi_frames(str(tmp_path / "comp" / "exp.avi"))[0].shape == (
        2, 24, 24, 3)
    assert all(v == 0 for v in fr.launch_counts.values())
    with pytest.raises(SystemExit):
        render_val.main([*argv, "--prior_masked", "1"])
    with pytest.raises(SystemExit):
        eval_reenact.main([*argv, "--tighten_bounds", "1", "--torso_ckpt",
                           ckpt])
