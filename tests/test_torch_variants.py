"""The model variants of the PyTorch port against the JAX package: the
attention modules, ``apply_point_conditioned``, the UNet, the point
projection, each variant's field functions and one head step of each
(with the gradients of its extras), the bridge and ``orbax_to_torch`` on
a variant head, and the variants through the port's CLIs on the CPU.

Inputs come from numpy with a fixed seed; weights go across through the
bridge. Tolerances: modules and field functions 1e-5 (float32 in other
orders); ``project_points`` bitwise; a step as
tests/test_torch_train.py::test_train_steps_match_jax (softplus density,
multires 6; loss 1e-5 relative, gradients 1e-4 norm-relative per leaf)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.models import attention as jatt
from idealnerf_tpu.models.face_nerf import (
    apply_point_conditioned as jax_point_conditioned,
)
from idealnerf_tpu.models.face_unet import apply_face_unet as jax_unet
from idealnerf_tpu.models.projection import (
    gather_image_features as jax_gather, project_points as jax_project,
)
from idealnerf_tpu.models.variants import build_field_fns as jax_field_fns
from idealnerf_tpu.models.variants import init_variant_extras as jax_extras
from idealnerf_tpu.models.variants import variant_nerf_config as jax_ncfg
from idealnerf_tpu.train.head import make_frame_loss as jax_frame_loss
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.cli import common as cli_common
from idealnerf_tpu_torch.cli import render_val, serve, train_head
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.models.attention import (
    AttentionSets, SelfAttention, SlotAttention,
)
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, apply_point_conditioned,
)
from idealnerf_tpu_torch.models.face_unet import FaceUNet
from idealnerf_tpu_torch.models.projection import (
    gather_image_features, project_points,
)
from idealnerf_tpu_torch.models.variants import (
    build_field_fns, variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.head import make_frame_loss
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.utils.summary import SummaryWriter

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=4, netwidth=64,
             N_rand=48, mouth_rays=8, torso_rays=8, N_samples=6,
             N_importance=6, lrate=5e-4, smo_size=4, dim_agg=16,
             attn_output_ch=32, nosmo_iters=10 ** 9)
CLI = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
       "--netdepth", "4", "--netwidth", "64", "--N_rand", "48",
       "--N_samples", "6", "--N_importance", "6", "--dim_agg", "16",
       "--attn_output_ch", "32"]
VARIANTS = ["face_nerf_agg", "attention_nerf"]
EXTRA = {"face_nerf_agg": "agg", "attention_nerf": "self_att"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The CLIs' metrics stream without TensorBoard, whose import takes
    seconds here (metrics.jsonl is still written)."""
    monkeypatch.setattr(cli_common, "SummaryWriter", functools.partial(
        SummaryWriter, use_tensorboard=False))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jtree(module):
    return jax.tree.map(jnp.asarray, bridge.module_to_tree(module))


def _close(got, want, tol=1e-5):
    got, want = (x.detach().numpy() if isinstance(x, torch.Tensor) else
                 np.asarray(x) for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ----------------------------------------------------------- modules

def test_self_attention_matches_jax():
    """Against apply_self_attention (post-softmax 1/sqrt(d)); identical rows
    give identical outputs, the property the variant folds on."""
    m = SelfAttention(143, generator=_gen())
    x = np.random.RandomState(1).randn(7, 143).astype(np.float32)
    y = m(torch.from_numpy(x))
    _close(y, jatt.apply_self_attention(_jtree(m), jnp.asarray(x)))
    rows = m(torch.from_numpy(np.tile(x[:1], (5, 1))))
    _close(rows - rows[0], np.zeros_like(rows.detach().numpy()))
    _close(rows[0], m(torch.from_numpy(x[:1]))[0])


def test_attention_sets_match_jax():
    """Against apply_attsets, and invariant to the order of the views."""
    m = AttentionSets(57, attention_output_length=512, generator=_gen())
    x = np.random.RandomState(1).randn(4, 12, 57).astype(np.float32)
    out = m(torch.from_numpy(x))
    assert out.shape == (4, 512)
    _close(out, jatt.apply_attsets(_jtree(m), jnp.asarray(x)))
    _close(m(torch.from_numpy(x[:, ::-1].copy())), out.detach().numpy(),
           tol=1e-4)


def test_slot_attention_matches_jax():
    """Against apply_slot_attention with JAX's own slot draw passed in;
    from a torch.Generator the slots are drawn the same way (same shape,
    finite, one seed one draw)."""
    m = SlotAttention(64, 57, 91, generator=_gen())
    rng = np.random.RandomState(1)
    x = rng.randn(5, 12, 57).astype(np.float32)
    e = rng.randn(5, 12, 91).astype(np.float32)
    tree, key = _jtree(m), jax.random.PRNGKey(2)
    slots = (jnp.mean(tree["slots_mu"]) + jnp.std(tree["slots_sigma"])
             * jax.random.normal(key, (5, 4, 64), jnp.float32))
    want = jatt.apply_slot_attention(tree, jnp.asarray(x), jnp.asarray(e),
                                     num_slots=4, key=key)
    got = m(torch.from_numpy(x), torch.from_numpy(e), 4,
            slots=torch.from_numpy(np.array(slots)))
    assert got.shape == (5, 4 * 64)
    _close(got, want, tol=1e-4)
    a = m(torch.from_numpy(x), torch.from_numpy(e), 4, generator=_gen(3))
    b = m(torch.from_numpy(x), torch.from_numpy(e), 4, generator=_gen(3))
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_apply_point_conditioned_matches_jax():
    """Per-point conditioning in the aud slot, unfolded."""
    ncfg = ExperimentConfig(**SMALL).face_nerf_config(dim_aud=24,
                                                      dim_expr=0,
                                                      dim_latent=0)
    m = FaceNeRF(ncfg, _gen())
    rng = np.random.RandomState(1)
    pe = rng.randn(33, ncfg.input_ch).astype(np.float32)
    pd = rng.randn(33, ncfg.input_ch_views).astype(np.float32)
    cond = rng.randn(33, 24).astype(np.float32)
    got = apply_point_conditioned(m, ncfg, *map(torch.from_numpy,
                                                (pe, pd, cond)))
    jcfg = JaxConfig(**SMALL).face_nerf_config(dim_aud=24, dim_expr=0,
                                               dim_latent=0)
    _close(got, jax_point_conditioned(_jtree(m), jcfg, *map(jnp.asarray,
                                                            (pe, pd, cond))))


@pytest.mark.parametrize("hw", [34, 40])
def test_face_unet_matches_jax(hw):
    """34 = 16·2 + 2 runs as it is; 40 is edge-padded to 50 and cropped
    back. 128 decoder channels + the embedded RGB."""
    m = FaceUNet(33, _gen())
    x = np.random.RandomState(1).uniform(
        -1, 1, (1, hw, hw, 33)).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), embed_ln=33)
    assert got.shape == (1, 128 + 33, hw, hw)
    _close(got, jax_unet(_jtree(m), jnp.asarray(x), embed_ln=33))


def test_project_points_matches_jax_bitwise():
    """Indices equal bitwise, clamping included, and the gathered features
    with them; a point straight ahead lands near the principal point."""
    rng = np.random.RandomState(1)
    q = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    pose = np.concatenate([q, rng.randn(3, 1).astype(np.float32)], 1)
    cam = rng.uniform(-0.6, 0.6, (500, 3)).astype(np.float32)
    cam[:, 2] = rng.uniform(-2.0, -0.3, 500)
    pts = ((cam - pose[:, 3]) @ q).astype(np.float32)
    intr = np.array([[40.0, 0, 17.0], [0, 40.0, 15.0], [0, 0, 1.0]],
                    np.float32)
    got = project_points(*map(torch.from_numpy, (pts, pose, intr)), 30, 34)
    want = jax_project(*map(jnp.asarray, (pts, pose, intr)), 30, 34)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and (got[:, 0] == 29).any()
    fmap = rng.randn(6, 30, 34).astype(np.float32)
    g = gather_image_features(*map(torch.from_numpy, (pts, pose, intr,
                                                      fmap)),
                              channels_first=True)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax_gather(
        *map(jnp.asarray, (pts, pose, intr, fmap)), channels_first=True)))
    ahead = np.array([[0.0, 0.0, 0.5]], np.float32)
    eye = np.concatenate([np.eye(3), [[0.0], [0.0], [1.0]]], 1).astype(
        np.float32)
    idx = project_points(*map(torch.from_numpy, (ahead, eye, intr)), 30, 34)
    assert 0 <= int(idx[0, 0]) < 30 and 0 <= int(idx[0, 1]) < 34


# ----------------------------------------------------------- variants

@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_params_and_config(variant):
    """The variant's net config and extras, as the JAX package builds
    them; init_params carries the extras."""
    cfg = ExperimentConfig(**SMALL, model_variant=variant)
    jcfg = JaxConfig(**SMALL, model_variant=variant)
    assert variant_nerf_config(cfg).__dict__ == jax_ncfg(jcfg).__dict__
    params = init_params(cfg, 1, _gen()).params
    assert set(jax_extras(jax.random.PRNGKey(0), jcfg)) == {EXTRA[variant]}
    assert EXTRA[variant] in params
    tree = bridge.params_to_jax(params)
    want = jax.tree.map(np.shape, jax_extras(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.map(np.shape, {EXTRA[variant]: tree[EXTRA[variant]]}) \
        == want


@pytest.mark.parametrize("variant", ["face_nerf"] + VARIANTS)
def test_variant_field_fns_match_jax(variant):
    """Coarse and fine field functions of each variant from bridged
    weights (1e-5), and the variants change the field."""
    cfg = ExperimentConfig(**SMALL, model_variant=variant)
    jcfg = JaxConfig(**SMALL, model_variant=variant)
    tree = bridge.seeded_tree(cfg, 3)
    params = bridge.params_from_jax(tree, cfg)
    rng = np.random.RandomState(0)
    pts = rng.randn(4, 3, 3).astype(np.float32)
    dirs = rng.randn(4, 3).astype(np.float32)
    cond = [rng.randn(n).astype(np.float32) for n in (32, 8, 4)]
    with torch.no_grad():
        fns = build_field_fns(params, cfg, *map(torch.from_numpy, cond))
        got = [f(torch.from_numpy(pts), torch.from_numpy(dirs)) for f in fns]
    jfns = jax_field_fns(jax.tree.map(jnp.asarray, tree), jcfg,
                         *map(jnp.asarray, cond))
    for g, f in zip(got, jfns):
        _close(g, f(jnp.asarray(pts), jnp.asarray(dirs)))
    if variant != "face_nerf":
        plain = ExperimentConfig(**SMALL)
        with torch.no_grad():
            base = build_field_fns(bridge.params_from_jax(
                bridge.seeded_tree(plain, 3), plain), plain,
                *map(torch.from_numpy, cond))[0](torch.from_numpy(pts),
                                                 torch.from_numpy(dirs))
        assert not torch.allclose(got[0], base)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_step_matches_jax(variant):
    """Loss and gradients of one head step on the same coords with no
    random draws, from bridged weights, against the JAX package's frame
    loss of the variant: every leaf, the extras' among them, whose only
    gradient is the one the folded biases hand back."""
    kw = {**SMALL, "model_variant": variant,
          "density_activation": "softplus", "multires": 6}
    cfg, jcfg = ExperimentConfig(**kw), JaxConfig(**kw, flat_optimizer=False)
    ds = make_synthetic_dataset(n_frames=2, H=16, W=16, dim_expr=8)
    jds = jax_synthetic(n_frames=2, H=16, W=16, dim_expr=8)
    tree = bridge.seeded_tree(cfg, 5)
    params = bridge.params_from_jax(tree, cfg)
    latent = torch.nn.Parameter(torch.ones(2, 4))
    coords = np.stack(np.meshgrid(np.arange(2, 14, 2), np.arange(1, 15, 2),
                                  indexing="ij"), -1).reshape(-1, 2)
    loss, _ = make_frame_loss(cfg, ds, False)(
        params, latent, ds.to_device("cpu"), 1, torch.from_numpy(coords),
        None)
    loss.backward()
    with jax.default_matmul_precision("highest"):
        (jl, _), jg = jax.jit(jax.value_and_grad(
            jax_frame_loss(jcfg, jds, False), has_aux=True),
            static_argnums=(4,))(
            (jax.tree.map(jnp.asarray, tree), jnp.ones((2, 4))),
            jds.to_device(), 1, jnp.asarray(coords, jnp.int32), None)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    holder = bridge.params_from_jax(tree, cfg)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), params.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    got = bridge.module_to_tree(holder)
    ref = {k: jg[0][k] for k in got}
    floor = 1e-6 * max(np.linalg.norm(np.asarray(r))
                       for r in jax.tree.leaves(ref))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        r = np.asarray(r)
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), floor)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)
    # a single row's softmax is 1: q and k get no gradient, v and out do
    last = jax.tree.leaves(got[EXTRA[variant]])[-1]
    assert np.linalg.norm(last) > 0
    np.testing.assert_allclose(latent.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("variant", VARIANTS)
def test_extras_learn_through_the_fused_paths_folded_biases(variant):
    """The extras reach the loss only through the folded biases: through
    the fused path's autograd function (its plain versions on the CPU,
    f32 and bf16 backward) their gradients are those of plain autograd,
    norm-relative within 1e-2 (f32 backward; the fused forward is bf16 on
    both paths, ROADMAP.md C) and 0.15 (bf16 backward, the bound
    chip_smoke.py holds the torso's bf16 gradients to), and zero exactly
    where plain autograd's are (q and k of a one-row attention)."""
    cfg = ExperimentConfig(**SMALL, model_variant=variant)
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.randn(6, 5, 3).astype(np.float32) * 0.5)
    dirs = torch.from_numpy(rng.randn(6, 3).astype(np.float32))
    cond = [torch.from_numpy(rng.randn(n).astype(np.float32))
            for n in (32, 8, 4)]
    grads = {}
    for path in (False, "train", "train_bf16"):
        params = bridge.params_from_jax(bridge.seeded_tree(cfg, 7), cfg)
        coarse, _ = build_field_fns(params, cfg, *cond, use_pallas=path)
        coarse(pts, dirs).square().sum().backward()
        grads[path] = dict((n, p.grad.clone()) for n, p in
                           params[EXTRA[variant]].named_parameters())
    for path, tol in (("train", 1e-2), ("train_bf16", 0.15)):
        for name, r in grads[False].items():
            g = grads[path][name]
            if float(r.norm()) == 0.0:
                assert float(g.norm()) == 0.0, (path, name)
            else:
                assert float((g - r).norm() / r.norm()) < tol, (path, name)
    assert any(float(g.norm()) > 0 for g in grads["train_bf16"].values())


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_round_trip_of_the_extras(variant):
    """The variant's tree goes to the port and back unchanged, and its
    extras give the JAX conditioning."""
    cfg = ExperimentConfig(**SMALL, model_variant=variant)
    jcfg = JaxConfig(**SMALL, model_variant=variant)
    tree = bridge.seeded_tree(cfg, 2)
    back = bridge.params_to_jax(bridge.params_from_jax(tree, cfg))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back),
                    strict=True):
        assert np.array_equal(a, b)
    from idealnerf_tpu.models.variants import variant_conditioning as jvc

    aud, expr = (np.random.RandomState(1).randn(n).astype(np.float32)
                 for n in (32, 8))
    with torch.no_grad():
        got = variant_conditioning(bridge.params_from_jax(tree, cfg), cfg,
                                   torch.from_numpy(aud),
                                   torch.from_numpy(expr))
    want = jvc(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(aud),
               jnp.asarray(expr))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)


def test_orbax_to_torch_converts_an_agg_head():
    """A face_nerf_agg head TrainState as orbax restores the one the JAX
    HeadTrainer.save writes (the layout of init_train_state, NamedTuples
    as dicts; seeded numpy values, moments at step 3) through
    orbax_to_torch.convert_raw: every parameter, the agg layers among
    them, and every Adam moment restore bitwise. (Reading the orbax files
    themselves: tests/test_torch_ckpt_convert.py.)"""
    import orbax_to_torch
    from idealnerf_tpu.train.state import init_train_state

    kw = {**SMALL, "model_variant": "face_nerf_agg"}
    cfg = ExperimentConfig(**kw)
    shapes = jax.eval_shape(lambda k: init_train_state(
        k, JaxConfig(**kw, flat_optimizer=False), 2), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    draw = lambda t: jax.tree.map(  # noqa: E731
        lambda x: rng.randn(*x.shape).astype(np.float32), t)
    diff = (draw(shapes.params), draw(shapes.latent_codes))
    raw = {"step": np.int32(3), "params": diff[0], "latent_codes": diff[1],
           "opt_state": [{"count": np.int32(3), "mu": draw(diff),
                          "nu": draw(diff)}, {"count": np.int32(3)}]}
    ck = orbax_to_torch.convert_raw(raw, cfg)
    assert ck["step"] == 3
    port = init_params(cfg, 2).params
    port.load_state_dict(ck["params"])
    got = bridge.params_to_jax(port)
    assert set(got) == set(raw["params"]) and "agg" in got
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(raw["params"]),
                    strict=True):
        assert np.array_equal(a, b)
    state = ck["optimizer"]["state"]
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree, lat = raw["opt_state"][0][name]
        want = [*bridge.params_from_jax(tree, cfg).parameters(),
                torch.from_numpy(lat)]
        assert len(state) == len(want)
        for i, w in enumerate(want):
            assert torch.equal(state[i][key], w.detach()), (name, i)


def test_unknown_variant_raises():
    cfg = ExperimentConfig(**SMALL, model_variant="bogus")
    for fn in (variant_nerf_config, lambda c: init_params(c, 1)):
        with pytest.raises(ValueError, match="bogus"):
            fn(cfg)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_trains_renders_and_serves_from_the_clis(variant, tmp_path):
    """train_head --model_variant, then render_val and serve from its
    checkpoint, on the CPU."""
    flags = ["--device", "cpu", "--synthetic", "2", "--synthetic_hw", "12",
             *CLI, "--model_variant", variant]
    res = train_head.main([*flags, "--epochs", "2", "--i_print", "2",
                           "--basedir", str(tmp_path)])
    assert res["step"] == 4
    assert all(math.isfinite(m["loss"]) for _, m in res["history"])
    ck = CheckpointManager(res["ckpt_dir"]).restore()
    assert any(k.startswith(EXTRA[variant] + ".") for k in ck["params"])
    out = render_val.main([*flags, "--head_ckpt", res["ckpt_dir"],
                           "--save_path", str(tmp_path / "frames")])
    assert math.isfinite(out["psnr"])
    stats = serve.main(["--device", "cpu", "--synthetic", "4",
                        "--synthetic_hw", "12", *CLI, "--model_variant",
                        variant, "--N_samples", "6", "--N_importance", "6",
                        "--refresh", "2", "--s_delta", "6", "--head_ckpt",
                        res["ckpt_dir"]])
    assert stats["frames"] == 4
