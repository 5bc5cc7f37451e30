"""``orbax_to_torch.py``: checkpoints the JAX trainers write through their
own ``save`` calls, converted into the port's files. The port restores
every leaf bitwise (parameters, latent table, Adam moments and step, in
both optimizer layouts of the JAX package), a frame rendered from the
converted head agrees with the JAX frame at the render tests' bound
(3e-2 and a correlation above 0.999, ``test_torch_render_val.py``), and a
resumed head step agrees with the JAX step at the step test's bounds
(``test_torch_train.py``: loss 1e-5 relative, gradients 1e-4
norm-relative, parameters after the same gradients' Adam update 1e-6). A
leaf with no counterpart raises, naming its path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import orbax_to_torch
from idealnerf_tpu.ckpt import CheckpointManager as JaxManager
from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.eval.renderer import make_frame_renderer as jax_renderer
from idealnerf_tpu.train.head import HeadTrainer as JaxHeadTrainer
from idealnerf_tpu.train.head import make_frame_loss as jax_frame_loss
from idealnerf_tpu.train.schedule import exponential_lr as jax_lr
from idealnerf_tpu.train.state import TrainState as JaxTrainState
from idealnerf_tpu.train.state import make_optimizer as jax_optimizer
from idealnerf_tpu.train.torso import TorsoTrainer as JaxTorsoTrainer
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval.renderer import make_frame_renderer
from idealnerf_tpu_torch.train.head import (
    HeadTrainer, apply_update, make_frame_loss,
)
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.train.torso import TorsoTrainer

# softplus density and multires 6 keep the step comparison on the
# training math, as in test_torch_train.py::test_train_steps_match_jax
SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=4, netwidth=64,
             N_rand=48, mouth_rays=8, torso_rays=8, N_samples=6,
             N_importance=6, lrate=5e-4, smo_size=4, nosmo_iters=10 ** 9,
             density_activation="softplus", multires=6)
CLI = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
       "--netdepth", "4", "--netwidth", "64", "--smo_size", "4",
       "--density_activation", "softplus", "--multires", "6"]
STEPS = 2


def _moved(rng, opt, diff, opt_state, steps: int = STEPS):
    """``steps`` Adam updates of ``diff`` by random gradients: moments,
    counts and parameters away from their initial values."""
    for _ in range(steps):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32)
                                  * 1e-2), diff)
        updates, opt_state = opt.update(grads, opt_state, diff)
        diff = optax.apply_updates(diff, updates)
    return diff, opt_state


@pytest.fixture(scope="module", params=[True, False], ids=["flat", "per_leaf"])
def converted(request, tmp_path_factory):
    """A JAX head checkpoint and a torso checkpoint (``HeadTrainer.save``
    and ``TorsoTrainer.save`` after STEPS updates), each converted."""
    flat = request.param
    root = tmp_path_factory.mktemp("ckpt")
    jcfg = JaxConfig(**SMALL, flat_optimizer=flat)
    jds = jax_synthetic(n_frames=3, H=16, W=16, dim_expr=8, with_torso=True)
    rng = np.random.RandomState(0)
    head = JaxHeadTrainer(jcfg, jds, seed=0, ckpt_dir=str(root / "jax_head"))
    st = head.state
    (params, latent), opt_state = _moved(
        rng, jax_optimizer(jcfg), (st.params, st.latent_codes), st.opt_state)
    head.state = JaxTrainState(jnp.asarray(STEPS, jnp.int32), params, latent,
                               opt_state)
    head.save()
    torso = JaxTorsoTrainer(jcfg, jds, params, latent, seed=1,
                            ckpt_dir=str(root / "jax_torso"))
    torso.torso_params, torso.opt_state = _moved(
        rng, torso.optimizer, torso.torso_params, torso.opt_state)
    torso.step = STEPS
    torso.save()
    cfg = ExperimentConfig(**SMALL)
    steps = {
        "head": orbax_to_torch.main(["--src", str(root / "jax_head"),
                                     "--dst", str(root / "head"), *CLI]),
        "torso": orbax_to_torch.convert_dir(str(root / "jax_torso"),
                                            str(root / "torso"), cfg)}
    return dict(root=root, flat=flat, jcfg=jcfg, cfg=cfg, steps=steps,
                head=JaxManager(str(root / "jax_head")).restore_raw(),
                torso=JaxManager(str(root / "jax_torso")).restore_raw())


def _equal_trees(got, want):
    g, w = orbax_to_torch._leaves(got), orbax_to_torch._leaves(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


def _unravel(m, diff):
    """A moment in the per-leaf layout, whichever layout it was saved in."""
    from jax.flatten_util import ravel_pytree

    if isinstance(m, (dict, list, tuple)):
        return m
    return ravel_pytree(diff)[1](jnp.asarray(m))


def test_head_checkpoint_restores_bitwise(converted):
    raw, cfg = converted["head"], converted["cfg"]
    assert converted["steps"]["head"] == [STEPS]
    ck = CheckpointManager(str(converted["root"] / "head")).restore()
    assert set(ck) == {"step", "params", "latent_codes", "optimizer"}
    assert ck["step"] == STEPS
    tr = HeadTrainer(cfg, make_synthetic_dataset(n_frames=3, H=16, W=16,
                                                 dim_expr=8),
                     ckpt_dir=str(converted["root"] / "head"))
    assert tr.global_step == STEPS
    _equal_trees(bridge.params_to_jax(tr.state.params), raw["params"])
    assert np.array_equal(tr.state.latent_codes.detach().numpy(),
                          np.asarray(raw["latent_codes"]))
    diff = (raw["params"], raw["latent_codes"])
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree, lat = _unravel(raw["opt_state"][0][name], diff)
        mine = [tr.state.optimizer.state[p][key]
                for p in tr.state.trainable()]
        holder = bridge.params_from_jax(jax.tree.map(np.asarray, tree), cfg)
        for a, b in zip(mine[:-1], holder.parameters(), strict=True):
            assert torch.equal(a, b.detach())
        assert torch.equal(mine[-1], torch.from_numpy(np.array(lat)))
    assert {float(tr.state.optimizer.state[p]["step"])
            for p in tr.state.trainable()} == {float(STEPS)}
    assert int(raw["opt_state"][0]["count"]) == STEPS


def test_torso_checkpoint_restores_bitwise(converted):
    raw, cfg = converted["torso"], converted["cfg"]
    assert converted["steps"]["torso"] == [STEPS]
    ds = make_synthetic_dataset(n_frames=3, H=16, W=16, dim_expr=8,
                                with_torso=True)
    head = bridge.params_from_jax(jax.tree.map(np.asarray,
                                               converted["head"]["params"]),
                                  cfg)
    tr = TorsoTrainer(cfg, ds, head, ckpt_dir=str(converted["root"] / "torso"))
    assert tr.step == STEPS
    _equal_trees(bridge.torso_params_to_jax(tr.torso_params),
                 raw["torso_params"])
    opt = tr.state.optimizer
    assert {float(opt.state[p]["step"]) for p in
            tr.torso_params.parameters()} == {float(STEPS)}
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        holder = bridge.torso_params_from_jax(
            jax.tree.map(np.asarray, raw["opt_state"][0][name]), cfg)
        for p, b in zip(tr.torso_params.parameters(), holder.parameters(),
                        strict=True):
            assert torch.equal(opt.state[p][key], b.detach())


def test_converted_head_renders_the_jax_frame(converted):
    raw, jcfg, cfg = converted["head"], converted["jcfg"], converted["cfg"]
    ds = make_synthetic_dataset(n_frames=2, H=16, W=16, dim_expr=8)
    ck = CheckpointManager(str(converted["root"] / "head")).restore()
    params = init_params(cfg, 1).params
    params.load_state_dict(ck["params"])
    rng = np.random.RandomState(0)
    aud = rng.randn(32).astype(np.float32)
    expr, latent = ds.exprs[1], np.asarray(raw["latent_codes"])[1]
    bc = ds.bc_img.astype(np.float32) / 255.0
    ref = jax_renderer(jcfg.face_nerf_config(), 16, 16, ds.focal, ds.near,
                       ds.far, jcfg.render_config(), cx=ds.cx, cy=ds.cy,
                       use_pallas="ray")(
        raw["params"], jnp.asarray(ds.poses[1]), jnp.asarray(bc),
        aud=jnp.asarray(aud), expr=jnp.asarray(expr),
        latent=jnp.asarray(latent))
    out = make_frame_renderer(cfg.face_nerf_config(), 16, 16, ds.focal,
                              ds.near, ds.far, cfg.render_config(),
                              cx=ds.cx, cy=ds.cy)(
        params, torch.from_numpy(ds.poses[1]), torch.from_numpy(bc),
        aud=torch.from_numpy(aud), expr=torch.from_numpy(expr),
        latent=ck["latent_codes"][1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-2)
    c = np.corrcoef(out.numpy().ravel(), np.asarray(ref).ravel())[0, 1]
    assert c > 0.999, c


def test_resumed_head_step_matches_jax(converted):
    """Both trainers resume from their checkpoint (the JAX one from its
    orbax directory, the port's from the converted file) and take one
    step on the same coordinates with no random draws."""
    jcfg, cfg, root = converted["jcfg"], converted["cfg"], converted["root"]
    jds = jax_synthetic(n_frames=3, H=16, W=16, dim_expr=8)
    ds = make_synthetic_dataset(n_frames=3, H=16, W=16, dim_expr=8)
    jtr = JaxHeadTrainer(jcfg, jds, seed=0, ckpt_dir=str(root / "jax_head"))
    tr = HeadTrainer(cfg, ds, ckpt_dir=str(root / "head"))
    assert jtr.global_step == tr.global_step == STEPS
    index = STEPS % ds.size
    coords = np.stack(np.meshgrid(np.arange(2, 14, 2), np.arange(1, 15, 2),
                                  indexing="ij"), -1).reshape(-1, 2)
    st = jtr.state
    diff = (st.params, st.latent_codes)
    with jax.default_matmul_precision("highest"):
        (jl, _), jg = jax.value_and_grad(jax_frame_loss(jcfg, jds, False),
                                         has_aux=True)(
            diff, jds.to_device(), index, jnp.asarray(coords, jnp.int32),
            None)
    loss, _ = make_frame_loss(cfg, ds, False)(
        tr.state.params, tr.state.latent_codes, tr.data, index,
        torch.from_numpy(coords), None)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    holder = bridge.params_from_jax(jax.tree.map(np.asarray, st.params), cfg)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), tr.state.params.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    got = jax.tree.map(np.asarray, bridge.module_to_tree(holder))
    floor = 1e-6 * max(np.linalg.norm(np.asarray(r))
                       for r in jax.tree.leaves(jg[0]))
    for (path, r), g in zip(
            jax.tree_util.tree_leaves_with_path({k: jg[0][k] for k in got}),
            jax.tree.leaves(got)):
        r = np.asarray(r)
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), floor)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)
    # the port's gradients through both updates: the restored moments
    # and step count decide the parameters after it
    lat_g = tr.state.latent_codes.grad.numpy()
    grads = (jax.tree.map(jnp.asarray, got), jnp.asarray(lat_g))
    updates, _ = jax_optimizer(jcfg).update(grads, st.opt_state, diff)
    after = optax.apply_updates(diff, updates)
    lr = exponential_lr(cfg.lrate, cfg.lrate_decay)(tr.state.step)
    assert np.isclose(lr, float(jax_lr(jcfg.lrate, jcfg.lrate_decay)(STEPS)),
                      rtol=1e-6)
    apply_update(tr.state, lr)
    mine = jax.tree.map(np.asarray, bridge.params_to_jax(tr.state.params))
    for a, b in zip(jax.tree.leaves(mine),
                    jax.tree.leaves({k: after[0][k] for k in mine})):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.state.latent_codes.detach().numpy(),
                               np.asarray(after[1]), rtol=0, atol=1e-6)


def test_a_leaf_without_counterpart_raises_naming_it(converted):
    cfg = converted["cfg"]
    raw = JaxManager(str(converted["root"] / "jax_head")).restore_raw()
    extra = dict(raw, params=dict(raw["params"], coarse=dict(
        raw["params"]["coarse"], extra={"w": np.zeros((2, 2), np.float32)})))
    with pytest.raises(ValueError, match="head/params/coarse/extra/w"):
        orbax_to_torch.convert_raw(extra, cfg)
    with pytest.raises(ValueError, match="head/ema"):
        orbax_to_torch.convert_raw(dict(raw, ema=raw["step"]), cfg)
    wider = ExperimentConfig(**{**SMALL, "netwidth": 32})
    with pytest.raises(ValueError, match="head/params/coarse/alpha/w: shape"):
        orbax_to_torch.convert_raw(raw, wider)
    traw = JaxManager(str(converted["root"] / "jax_torso")).restore_raw()
    with pytest.raises(ValueError, match="torso/opt_state/0/mu/fine"):
        orbax_to_torch.convert_raw(dict(traw, opt_state=[
            dict(traw["opt_state"][0], mu={"coarse": traw["opt_state"][0][
                "mu"]["coarse"]}), traw["opt_state"][1]]), cfg)
    with pytest.raises(ValueError, match="neither"):
        orbax_to_torch.convert_raw({"step": 1}, cfg)


def test_the_port_refuses_an_orbax_dir_naming_the_converter(converted):
    src = str(converted["root"] / "jax_head")
    assert any(n.startswith("step_") and os.path.isdir(os.path.join(src, n))
               for n in os.listdir(src))
    with pytest.raises(NotImplementedError, match="orbax_to_torch.py"):
        CheckpointManager(src).restore()
