"""The temporal head + torso composite of the PyTorch port
(eval/temporal.make_temporal_composite_renderer) against the JAX package:
the per-field priors, keyframe exactness, a keyframe and two delta frames
under each mode of the torso field, the torso's frozen depth grid and
refresh-only roll, ``render.cycle`` and the refusals.

Inputs come from numpy with a fixed seed; weights go across through the
bridge. The JAX side runs as its own tests run it on the CPU: its kernels
in interpret mode, its delta frames through the XLA chain. Tolerances, as
tests/test_torch_temporal.py: frames against JAX 3e-2 with correlation >
0.999 (both sides round weights and activations to bf16); a keyframe
against the port's composite frame renderer 2e-5 (the same computation);
bands 2e-6. The fields use softplus density wherever the delta-frame
feedback runs, so every CDF bin stays above sample_pdf's 1e-5 floor
(ROADMAP.md C)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.eval import renderer as jax_renderer
from idealnerf_tpu.eval import temporal as jtm
from idealnerf_tpu.train.torso import torso_nerf_config as jax_torso_config
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval import temporal as tm
from idealnerf_tpu_torch.eval.renderer import (
    foreground_prior_fields, make_composite_frame_renderer,
)
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.train.torso import (
    init_torso_params, torso_nerf_config,
)

SMALL = dict(dim_aud=16, dim_expr=8, dim_latent=4, dim_aud_body=8,
             netdepth=6, netwidth=64, N_samples=16, N_importance=16,
             density_activation="softplus")
NEAR, FAR = 0.5, 1.5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(tx=0.0, ty=0.0, tz=0.9):
    return np.concatenate([np.eye(3, dtype=np.float32),
                           np.array([[tx], [ty], [tz]], np.float32)], 1)


def _agree(got, want):
    np.testing.assert_allclose(got, want, atol=3e-2)
    c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert c > 0.999, c


class _Scene:
    """Random head and torso fields of both packages (bridged weights)
    over a random plate, as tests/test_temporal.py:_random_setup builds
    them: the head at ``pose``, the torso from the fixed ``pose0``."""

    def __init__(self, H=24, W=24):
        self.cfg, self.jcfg = ExperimentConfig(**SMALL), JaxConfig(**SMALL)
        self.hcfg, self.tcfg = (self.cfg.face_nerf_config(),
                                torso_nerf_config(self.cfg))
        self.rc = self.cfg.render_config()
        self.H, self.W, self.focal = H, W, 1.5 * H
        self.cx, self.cy = W / 2.0, H / 2.0
        self.head = init_params(self.cfg, 1,
                                torch.Generator().manual_seed(0)).params
        self.torso = init_torso_params(self.cfg,
                                       torch.Generator().manual_seed(1))
        self.jhead = jax.tree.map(jnp.asarray, bridge.params_to_jax(self.head))
        self.jtorso = jax.tree.map(jnp.asarray,
                                   bridge.torso_params_to_jax(self.torso))
        rng = np.random.RandomState(2)
        self.bc = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        self.pose0 = _pose(0.05, 0.0, 0.95)
        self.cond = dict(aud=rng.randn(16).astype(np.float32),
                         expr=rng.randn(8).astype(np.float32),
                         latent=np.ones(4, np.float32),
                         signal=rng.randn(self.tcfg.dim_aud)
                         .astype(np.float32))

    def renderer(self, **kw):
        return tm.make_temporal_composite_renderer(
            self.hcfg, self.tcfg, self.H, self.W, self.focal, NEAR, FAR,
            self.rc, cx=self.cx, cy=self.cy, **kw)

    def jax_renderer(self, **kw):
        return jtm.make_temporal_composite_renderer(
            self.jcfg.face_nerf_config(), jax_torso_config(self.jcfg),
            self.H, self.W, self.focal, NEAR, FAR, self.jcfg.render_config(),
            cx=self.cx, cy=self.cy, **kw)

    def render(self, r, pose, cache=None, **cond):
        cond = {k: torch.from_numpy(v) for k, v in {**self.cond,
                                                     **cond}.items()}
        frame, cache = r(self.head, self.torso, torch.from_numpy(pose),
                         torch.from_numpy(self.pose0),
                         torch.from_numpy(self.bc), cache=cache, **cond)
        return frame.numpy(), cache

    def jax_render(self, r, pose, cache=None):
        frame, cache = r(self.jhead, self.jtorso, jnp.asarray(pose),
                         jnp.asarray(self.pose0), jnp.asarray(self.bc),
                         cache=cache,
                         **{k: jnp.asarray(v) for k, v in self.cond.items()})
        return np.asarray(frame), cache

    def torso_cond(self, signal=None):
        s = self.cond["signal"] if signal is None else signal
        return (torch.from_numpy(s), None, None)

    def masks(self):
        mh = np.zeros((self.H, self.W), bool)
        mh[3:15, 5:19] = True
        mt = np.zeros((self.H, self.W), bool)
        mt[12:, 2:22] = True
        return mh, mt


POSES = [_pose(), _pose(0.03, 0.02, 0.92), _pose(-0.02, 0.04, 0.88)]


# ---------------------------------------------------------------- priors

@pytest.mark.parametrize("head_parse", [False, True])
def test_foreground_prior_fields_match_jax(head_parse):
    ds = make_synthetic_dataset(n_frames=3, H=40, W=40, dim_expr=8)
    jds = jax_synthetic(n_frames=3, H=40, W=40, dim_expr=8)
    mh, mt = foreground_prior_fields(ds, margin=3, head_parse=head_parse)
    jh, jt = jax_renderer.foreground_prior_fields(jds, margin=3,
                                                  head_parse=head_parse)
    np.testing.assert_array_equal(mh, jh)
    np.testing.assert_array_equal(mt, jt)
    assert mh.any() and mt.any() and not (mh == mt).all()


# -------------------------------------------------------------- keyframe

def test_keyframe_equals_the_composite_frame_renderer():
    """tests/test_temporal.py:76-120: a keyframe is the full composite
    frame (2e-5), unmasked and under all-true per-field priors; the
    cache's bands lie inside the field interval; a delta frame under
    per-field priors is finite and the plate outside their union (up to
    the union's 256-alignment padding)."""
    sc = _Scene()
    full = make_composite_frame_renderer(sc.hcfg, sc.tcfg, sc.H, sc.W,
                                         sc.focal, NEAR, FAR, sc.rc,
                                         cx=sc.cx, cy=sc.cy)
    cond = {k: torch.from_numpy(v) for k, v in sc.cond.items()}
    with torch.no_grad():
        ref = full(sc.head, sc.torso, torch.from_numpy(_pose()),
                   torch.from_numpy(sc.pose0), torch.from_numpy(sc.bc),
                   **cond).numpy()
    frame, cache = sc.render(sc.renderer(s_delta=8), _pose())
    np.testing.assert_allclose(frame, ref, atol=2e-5)
    for f in ("head", "torso"):
        lo, hi = cache[f][0].numpy(), cache[f][1].numpy()
        assert (lo >= NEAR - 1e-6).all() and (hi <= FAR + 1e-6).all()
        assert (lo <= hi + 1e-6).all()
    ones = np.ones((sc.H, sc.W), bool)
    frame, _ = sc.render(sc.renderer(s_delta=8, prior_mask_head=ones,
                                     prior_mask_torso=ones), _pose())
    np.testing.assert_allclose(frame, ref, atol=2e-5)

    mh, mt = sc.masks()
    r = sc.renderer(s_delta=8, prior_mask_head=mh, prior_mask_torso=mt)
    _, c0 = sc.render(r, _pose())
    f1, _ = sc.render(r, _pose(), c0)
    assert np.isfinite(f1).all()
    union = mh | mt
    n_pad = min(sc.H * sc.W, -(-int(union.sum()) // 256) * 256) - union.sum()
    off = np.abs(f1[~union] - sc.bc[~union]).max(-1) >= 1e-6
    assert off.sum() <= n_pad


# ------------------------------------------------------- against the JAX

CASES = {
    "plain": dict(s_delta=8),
    "keep-torso-0.5": dict(s_delta=8, delta_keep_torso=0.5),
    "freeze-z-torso": dict(s_delta=8, freeze_z_torso=True),
    "s-delta-torso-12": dict(s_delta=8, s_delta_torso=12),
    "per-field-priors": dict(s_delta=8, priors=True),
    "roll-k-3": dict(s_delta=8, roll_k=3),
    "roll-k-torso-4": dict(s_delta=8, roll_k_torso=4),
}


def _to_torch(tree):
    """A JAX-side cache as the port holds it: arrays become tensors (index
    arrays int64), python ints stay."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    if isinstance(tree, int):
        return tree
    a = np.array(tree)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)


def _layout(tree):
    """Keys, tuple lengths and array shapes of a cache."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layout(v) for v in tree)
    return "scalar" if np.ndim(tree) == 0 else tuple(np.shape(tree))


@pytest.mark.parametrize("kw", CASES.values(), ids=CASES.keys())
def test_frames_match_jax(kw):
    """A keyframe and two delta frames at moved head poses against the
    JAX renderer, per frame 3e-2 and correlation > 0.999, with the cache
    layouts equal. Each delta frame starts from the JAX side's cache, so
    the comparison holds one frame's computation: on its own chain, the
    bf16 noise of both sides, fed back through two importance draws,
    moves a few pixels of these random fields past 3e-2 (0.032 at the
    second delta frame with delta_keep_torso 0.5). Per-field priors run
    the masked union maps; the rolling cases pad the field selections."""
    sc = _Scene()
    kw = dict(kw)
    if kw.pop("priors", False):
        kw.update(zip(("prior_mask_head", "prior_mask_torso"), sc.masks()))
    r, jr = sc.renderer(**kw), sc.jax_renderer(**kw)
    torso = r.stages["torso"]
    assert torso.uses_delta_kernel == (not kw.get("freeze_z_torso", False))
    jcache = None
    for n, pose in enumerate(POSES):
        frame, cache = sc.render(r, pose,
                                 None if jcache is None else _to_torch(jcache))
        want, jcache = sc.jax_render(jr, pose, jcache)
        assert frame.shape == (sc.H, sc.W, 3)
        _agree(frame, want)
        assert _layout(cache) == _layout(jcache)
        if n == 0 and "delta_keep_torso" in kw:
            # the keyframe ranks the same kept rays; tied plateaus of the
            # dilated mass grid may rank in either order
            np.testing.assert_array_equal(
                np.sort(cache["torso"]["keep"].numpy()),
                np.sort(np.asarray(jcache["torso"]["keep"])))
    if kw.get("roll_k_torso") or kw.get("roll_k"):
        assert cache["torso"]["phase"] == jcache["torso"]["phase"] == 2


@pytest.mark.parametrize("mode", ["per-field-priors", "roll-k-3"])
def test_own_chain_matches_jax(mode):
    """A keyframe and two delta frames with each side carrying its own
    cache, against the JAX renderer at 3e-2 and correlation > 0.999: the
    port's masked union maps and its rolling cache of both fields hold
    their state across frames. (On these random fields the modes whose
    delta frames cover the whole frame drift to 0.028-0.032 at the second
    delta frame on their own chains; PERF.md §7.)"""
    sc = _Scene()
    kw = dict(CASES[mode])
    if kw.pop("priors", False):
        kw.update(zip(("prior_mask_head", "prior_mask_torso"), sc.masks()))
    r, jr = sc.renderer(**kw), sc.jax_renderer(**kw)
    cache = jcache = None
    for pose in POSES:
        frame, cache = sc.render(r, pose, cache)
        want, jcache = sc.jax_render(jr, pose, jcache)
        _agree(frame, want)
    assert _layout(cache) == _layout(jcache)


def test_union_maps_resolve_padded_rows_to_their_pixel():
    """The composite stage over per-field priors with a roll-padded torso
    selection: on every union pixel a unit head (or plate) is scaled by
    the torso's last_weight at that pixel's last torso row (the JAX
    package's numpy last-write-wins), and by 1 off the torso prior."""
    H, W = 23, 25
    sc = _Scene(H=H, W=W)
    mh, mt = np.zeros((H, W), bool), np.zeros((H, W), bool)
    mh[2:12, 3:20] = True
    mt[10:, 1:24] = True
    sel_t = tm._pad_sel_for_roll(tm._prior_sel(mt, H * W), 3)
    sel_u = tm._prior_sel(mh | mt, H * W)
    assert sel_t[-1] == sel_t[-2] and sel_t[-1] in sel_u
    pos = np.full(H * W, -1)
    for row, pix in enumerate(sel_t):
        pos[pix] = row
    r = sc.renderer(s_delta=8, roll_k_torso=3, prior_mask_head=mh,
                    prior_mask_torso=mt)
    n_h = len(tm._prior_sel(mh, H * W))
    img = r.stages["composite"](
        torch.ones(n_h, 3), torch.arange(len(sel_t), dtype=torch.float32),
        torch.zeros(len(sel_t), 3), torch.ones(H, W, 3))
    want = np.where(pos[sel_u] >= 0, pos[sel_u], 1).astype(np.float32)
    np.testing.assert_array_equal(img.reshape(-1, 3)[sel_u, 0].numpy(), want)
    _, c0 = sc.render(r, _pose())
    f1, c1 = sc.render(r, _pose(), c0)
    assert np.isfinite(f1).all() and c1["torso"]["phase"] == 1


# ------------------------------------------------------- torso modes

def test_freeze_z_torso_is_exact_at_the_same_conditioning():
    """tests/test_temporal.py:267-300: a frozen torso delta frame at the
    keyframe's conditioning reproduces its last_weight and rgb_fg (1e-3)
    and passes the depth grid through bitwise; a changed signal moves
    rgb_fg on the same grid; the delta kernel is not used."""
    sc = _Scene()
    r = sc.renderer(s_delta=8, freeze_z_torso=True)
    torso = r.stages["torso"]
    assert not torso.uses_delta_kernel
    pose0, bc = torch.from_numpy(sc.pose0), torch.from_numpy(sc.bc)
    with torch.no_grad():
        _, lw0, fg0, band = torso(sc.torso, pose0, bc, sc.torso_cond(), None)
        _, lw1, fg1, band1 = torso(sc.torso, pose0, bc, sc.torso_cond(), band)
        np.testing.assert_allclose(lw1.numpy(), lw0.numpy(), atol=1e-3)
        np.testing.assert_allclose(fg1.numpy(), fg0.numpy(), atol=1e-3)
        assert band1[2] is band[2] or torch.equal(band1[2], band[2])
        assert band[2].shape[-1] == sc.rc.n_samples + sc.rc.n_importance
        _, _, fg2, _ = torso(sc.torso, pose0, bc,
                             sc.torso_cond(sc.cond["signal"] + 1.0), band)
    assert float((fg2 - fg0).abs().max()) > 1e-4
    f, c = sc.render(r, _pose())
    for pose in POSES[1:]:
        f, c = sc.render(r, pose, c)
        assert np.isfinite(f).all()


def test_roll_k_torso_refreshes_the_whole_comb():
    """tests/test_temporal.py:817-868: frame 0 is the plain keyframe
    (2e-5); the phase wraps every K frames; after one full comb at
    constant conditioning the torso cache holds the keyframe's values
    (rays re-rendered from identical inputs)."""
    sc = _Scene()
    K = 4
    ref0, _ = sc.render(sc.renderer(s_delta=8), _pose())
    r = sc.renderer(s_delta=8, delta_keep_head=0.75, roll_k_torso=K)
    f0, cache = sc.render(r, _pose())
    np.testing.assert_allclose(f0, ref0, atol=2e-5)
    rgb_kf = cache["torso"]["dev"]["rgb"].numpy()
    for i in range(K + 1):
        assert cache["torso"]["phase"] == i % K
        f, cache = sc.render(r, _pose(), cache)
        assert np.isfinite(f).all()
    d = np.abs(cache["torso"]["dev"]["rgb"].numpy() - rgb_kf)
    assert d.max() < 5e-3 and (d <= 2e-5).mean() > 0.9, d.max()


# ------------------------------------------------------------- the cycle

def test_cycle_equals_per_frame_calls():
    """tests/test_temporal.py:361-428: render.cycle gives the frames and
    the final cache of T per-frame calls, bitwise, on the richest cache
    (pruned + kf_blend) of the composite and on the head-only renderer."""
    sc = _Scene()
    T = 3
    rng = np.random.RandomState(7)
    poses = np.stack([_pose(0.02 * i, 0.01 * i, 0.9) for i in range(T)])
    conds = dict(aud=rng.randn(T, 16), expr=rng.randn(T, 8),
                 signal=rng.randn(T, sc.tcfg.dim_aud),
                 latent=np.ones((T, 4)))
    conds = {k: v.astype(np.float32) for k, v in conds.items()}
    r = sc.renderer(s_delta=8, delta_keep_head=0.5, delta_keep_torso=0.5,
                    kf_blend=0.5)
    _, cache = sc.render(r, _pose())
    _, cache = sc.render(r, _pose(), cache)
    ref, c_ref = [], cache
    for t in range(T):
        f, c_ref = sc.render(r, poses[t], c_ref,
                             **{k: v[t] for k, v in conds.items()})
        ref.append(f)
    t_ = {k: torch.from_numpy(v) for k, v in conds.items()}
    frames, c_cyc = r.cycle(sc.head, sc.torso, torch.from_numpy(poses),
                            torch.from_numpy(sc.pose0),
                            torch.from_numpy(sc.bc), cache, auds=t_["aud"],
                            signals=t_["signal"], exprs=t_["expr"],
                            latents=t_["latent"])
    np.testing.assert_array_equal(frames.numpy(), np.stack(ref))
    assert isinstance(c_ref["head"], dict) and "kz" in c_ref["head"]
    _assert_same(c_cyc, c_ref)

    rh = tm.make_temporal_frame_renderer(sc.hcfg, sc.H, sc.W, sc.focal, NEAR,
                                         FAR, sc.rc, cx=sc.cx, cy=sc.cy,
                                         s_delta=8)
    hcond = {k: torch.from_numpy(sc.cond[k]) for k in ("aud", "expr",
                                                       "latent")}
    pose, bc = torch.from_numpy(_pose()), torch.from_numpy(sc.bc)
    _, hc = rh(sc.head, pose, bc, cache=None, **hcond)
    _, hc = rh(sc.head, pose, bc, cache=hc, **hcond)
    ref, c_ref = [], hc
    for t in range(T):
        f, c_ref = rh(sc.head, torch.from_numpy(poses[t]), bc, cache=c_ref,
                      aud=t_["aud"][t], expr=t_["expr"][t],
                      latent=t_["latent"][t])
        ref.append(f)
    frames, c_cyc = rh.cycle(sc.head, torch.from_numpy(poses), bc, hc,
                             auds=t_["aud"], exprs=t_["expr"],
                             latents=t_["latent"])
    assert torch.equal(frames, torch.stack(ref))
    _assert_same(c_cyc, c_ref)


def _assert_same(a, b):
    """Two caches bitwise equal, leaf by leaf."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


# ------------------------------------------------------------- refusals

REFUSED = {
    "roll-k-with-roll-k-torso": (dict(roll_k=4, roll_k_torso=4), ValueError,
                                 "exclusive"),
    "roll-k-torso-1": (dict(roll_k_torso=1), ValueError, "roll_k_torso"),
    "roll-k-1": (dict(roll_k=1), ValueError, "roll_k"),
    "cycle-under-roll-k-torso": (dict(roll_k_torso=4), RuntimeError,
                                 "render.cycle"),
}


@pytest.mark.parametrize("kw,err,match", REFUSED.values(), ids=REFUSED.keys())
def test_refusals(kw, err, match):
    """roll_k and roll_k_torso are exclusive; a period of 1 is refused at
    construction (the JAX package accepts roll_k_torso=1 and then fails
    in the refresh roll, ROADMAP.md C); render.cycle under roll_k_torso
    raises."""
    sc = _Scene(H=8, W=8)
    with pytest.raises(err, match=match):
        r = sc.renderer(s_delta=8, **kw)
        _, cache = sc.render(r, _pose())
        r.cycle(sc.head, sc.torso, torch.from_numpy(_pose())[None],
                torch.from_numpy(sc.pose0), torch.from_numpy(sc.bc), cache)
