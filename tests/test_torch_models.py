"""Config, weight bridge, models and data of the PyTorch port against the
JAX package. Parameters move through idealnerf_tpu_torch.bridge; inputs
come from numpy with a fixed seed. Float32 tolerance 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.core.render import RenderConfig as JaxRenderConfig
from idealnerf_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic,
)
from idealnerf_tpu.models import audio_net as jax_audio
from idealnerf_tpu.models import face_nerf as jax_fn
from idealnerf_tpu.train.head import compute_aud_feature as jax_aud_feature
from idealnerf_tpu.train.state import init_train_state
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.core.render import RenderConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.models.audio_net import (
    AudioAttNet, AudioNet, DeepSpeechAudNet,
)
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, apply_face_nerf, apply_folded,
    fold_conditioning,
)
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.head import compute_aud_feature
from idealnerf_tpu_torch.train.state import init_params

TOL = 1e-5
SMALL = dict(dim_aud=16, dim_expr=8, dim_latent=4, netdepth=6, netwidth=64)
DROPPED = {"flat_optimizer", "sampler_approx"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               atol=atol, rtol=TOL)


def _fields(cls):
    return {f.name: (f.type, f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("pair", [
    (ExperimentConfig, JaxConfig, DROPPED),
    (RenderConfig, JaxRenderConfig, set()),
    (FaceNeRFConfig, jax_fn.FaceNeRFConfig, set()),
], ids=["experiment", "render", "face_nerf"])
def test_config_fields_and_defaults_match_jax(pair):
    port, ref, dropped = pair
    want = {k: v for k, v in _fields(ref).items() if k not in dropped}
    assert _fields(port) == want


def test_config_derived_views_match_jax(tmp_path):
    path = tmp_path / "cfg.txt"
    path.write_text("dim_expr = 76\nN_sample = 32\nflat_optimizer = 0\n"
                    "netwidth = 128  # comment\nwhite_bkgd = 1\n")
    port = ExperimentConfig.from_file(str(path), dim_aud=29)
    ref = JaxConfig.from_file(str(path), dim_aud=29)
    assert dataclasses.asdict(port) == {
        k: v for k, v in dataclasses.asdict(ref).items() if k not in DROPPED}
    assert (dataclasses.asdict(port.render_config())
            == dataclasses.asdict(ref.render_config()))
    assert (dataclasses.asdict(port.face_nerf_config())
            == dataclasses.asdict(ref.face_nerf_config()))


def _jax_state(**kw):
    cfg = JaxConfig(**{**SMALL, **kw})
    return cfg, init_train_state(jax.random.PRNGKey(0), cfg, 3)


def _assert_tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_bridge_round_trip_is_exact():
    jcfg, state = _jax_state()
    tree = _np_tree(state.params)
    port_cfg = ExperimentConfig(**SMALL)
    params = bridge.params_from_jax(tree, port_cfg)
    back = bridge.params_to_jax(params)
    _assert_tree_equal(back, {k: tree[k] for k in back})
    # and port -> JAX layout -> port
    fresh = init_params(port_cfg, 2, torch.Generator().manual_seed(5)).params
    again = bridge.params_from_jax(bridge.params_to_jax(fresh), port_cfg)
    for (n1, p1), (n2, p2) in zip(fresh.named_parameters(),
                                  again.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2)


def test_init_params_shapes_and_init_rule():
    cfg = ExperimentConfig(**SMALL)
    st = init_params(cfg, 3, torch.Generator().manual_seed(0))
    assert st.latent_codes.shape == (3, 4) and torch.all(st.latent_codes == 1)
    _, jstate = _jax_state()
    jtree = _np_tree(jstate.params)
    port_tree = bridge.params_to_jax(st.params)
    la, ta = jax.tree.flatten(port_tree)
    lb, tb = jax.tree.flatten({k: jtree[k] for k in port_tree})
    assert ta == tb
    assert [x.shape for x in la] == [x.shape for x in lb]
    lin = st.params["coarse"].pts_linears[0]
    limit = (6.0 / (lin.in_features + lin.out_features)) ** 0.5
    assert float(lin.weight.abs().max()) <= limit
    assert torch.all(lin.bias == 0.01)


def _concat_forward(model, cfg, pe, ped, aud, expr, latent):
    """The reference's formulation: conditioning concatenated onto every
    point (trunk entry and skip), expr/3 onto the view branch's input."""
    n = pe.shape[0]
    cond = torch.cat([aud, expr / 3.0, latent]).expand(n, -1)
    initial = torch.cat([pe, cond], -1)
    h = initial
    for i, layer in enumerate(model.pts_linears):
        h = torch.relu(layer(h))
        if i in cfg.skips:
            h = torch.cat([initial, h], -1)
    alpha = model.alpha_linear(h)
    hv = torch.cat([h, ped, (expr / 3.0).expand(n, -1)], -1)
    for layer in model.views_linears:
        hv = torch.relu(layer(hv))
    return torch.cat([model.rgb_linear(hv), alpha], -1)


def _cond(rng, ncfg):
    aud = rng.randn(ncfg.dim_aud).astype(np.float32)
    expr = rng.randn(ncfg.dim_expr).astype(np.float32)
    lat = (rng.randn(ncfg.dim_latent) * 0.1).astype(np.float32)
    return aud, expr, lat


def test_fold_and_apply_folded_match_jax():
    jcfg = JaxConfig(**SMALL)
    ncfg_j = jcfg.face_nerf_config()
    ncfg = ExperimentConfig(**SMALL).face_nerf_config()
    jparams = jax_fn.init_face_nerf(jax.random.PRNGKey(1), ncfg_j)
    model = bridge.load_module_(FaceNeRF(ncfg), _np_tree(jparams))
    rng = np.random.RandomState(0)
    aud, expr, lat = _cond(rng, ncfg)
    folded = fold_conditioning(model, ncfg, _t(aud), _t(expr), _t(lat))
    jfold = jax_fn.fold_conditioning(jparams, ncfg_j, jnp.asarray(aud),
                                     jnp.asarray(expr), jnp.asarray(lat))
    for b, jb in zip(folded["b_pts"], jfold["b_pts"]):
        _close(b, jb)
    _close(folded["b_view0"], jfold["b_view0"])

    pe = rng.uniform(-1, 1, (300, ncfg.input_ch)).astype(np.float32)
    ped = rng.uniform(-1, 1, (300, ncfg.input_ch_views)).astype(np.float32)
    with torch.no_grad():
        raw = apply_folded(model, folded, ncfg, _t(pe), _t(ped))
        concat = _concat_forward(model, ncfg, _t(pe), _t(ped), _t(aud),
                                 _t(expr), _t(lat))
        full = apply_face_nerf(model, ncfg, _t(pe), _t(ped), _t(aud),
                               _t(expr), _t(lat))
        fwd = model(_t(pe), _t(ped), _t(aud), _t(expr), _t(lat))
    _close(raw, jax_fn.apply_folded(jparams, jfold, ncfg_j, jnp.asarray(pe),
                                    jnp.asarray(ped)))
    _close(full, jax_fn.apply_face_nerf(
        jparams, ncfg_j, jnp.asarray(pe), jnp.asarray(ped), jnp.asarray(aud),
        jnp.asarray(expr), jnp.asarray(lat)))
    # folded biases are the concatenated conditioning, rearranged
    _close(raw, concat.numpy())
    _close(fwd, concat.numpy())


def test_audio_nets_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(5, 16, 29).astype(np.float32)
    ks = jax.random.split(jax.random.PRNGKey(2), 3)

    jp = jax_audio.init_audio_net(ks[0], dim_aud=32)
    net = bridge.load_module_(AudioNet(32), _np_tree(jp))
    with torch.no_grad():
        _close(net(_t(x)), jax_audio.apply_audio_net(jp, jnp.asarray(x)))

    feats = rng.randn(8, 32).astype(np.float32)
    jp = jax_audio.init_audio_att_net(ks[1], dim_aud=32, seq_len=8)
    att = bridge.load_module_(AudioAttNet(32, 8), _np_tree(jp))
    with torch.no_grad():
        _close(att(_t(feats)), jax_audio.apply_audio_att_net(
            jp, jnp.asarray(feats)))

    jp = jax_audio.init_ds_aud_net(ks[2])
    ds = bridge.load_module_(DeepSpeechAudNet(), _np_tree(jp))
    with torch.no_grad():
        _close(ds(_t(x)), jax_audio.apply_ds_aud_net(jp, jnp.asarray(x)))


@pytest.mark.parametrize("dim_aud,smooth,index", [
    (32, False, 2), (32, True, 0), (32, True, 5), (29, False, 3)])
def test_compute_aud_feature_matches_jax(dim_aud, smooth, index):
    kw = {**SMALL, "dim_aud": dim_aud}
    _, state = _jax_state(**kw)
    tree = _np_tree(state.params)
    cfg = ExperimentConfig(**kw)
    params = bridge.params_from_jax(tree, cfg)
    rng = np.random.RandomState(3)
    auds = rng.randn(9, 16, 29).astype(np.float32)
    ids = rng.permutation(9)[:7].astype(np.int32)
    with torch.no_grad():
        out = compute_aud_feature(params, _t(auds), _t(ids).long(), index,
                                  cfg, smooth)
    ref = jax_aud_feature(state.params, jnp.asarray(auds), jnp.asarray(ids),
                          index, JaxConfig(**kw), smooth)
    _close(out, ref)


def test_variants_face_nerf_only():
    cfg = ExperimentConfig(**SMALL)
    assert variant_nerf_config(cfg) == cfg.face_nerf_config()
    a, e = torch.ones(16), torch.ones(8)
    assert variant_conditioning(None, cfg, a, e) == (a, e)
    for v in ("face_nerf_agg", "attention_nerf"):
        with pytest.raises(NotImplementedError, match="A10"):
            variant_nerf_config(dataclasses.replace(cfg, model_variant=v))
    with pytest.raises(ValueError):
        variant_nerf_config(dataclasses.replace(cfg, model_variant="x"))


@pytest.mark.parametrize("kw", [
    dict(n_frames=3, H=20, W=24, dim_expr=5),
    dict(n_frames=2, H=16, W=16, dim_expr=76, with_torso=True, seed=4,
         motion_scale=1.5),
])
def test_synthetic_dataset_is_byte_identical(kw):
    port, ref = make_synthetic_dataset(**kw), jax_make_synthetic(**kw)
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    dev = port.to_device("cpu")
    assert dev["images"].dtype == torch.uint8
    assert torch.equal(dev["poses"], _t(ref.poses))
