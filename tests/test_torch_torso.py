"""The torso slice of the PyTorch port against the JAX package: the pose
signal and the layered composite, one and two torso train steps from
bridged weights, and the port's own torso trainer, checkpoints and
resume on the CPU.

Tolerances: the signal and the composite 1e-6; the loss 1e-5 relative;
torso gradients 1e-4 norm-relative per leaf (f32 on both sides, summed in
other orders); torso parameters after an Adam update 1e-6 absolute."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.core.composite import layered_composite as jax_composite
from idealnerf_tpu.core.rays import pose_to_euler_trans as jax_euler_trans
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.train.schedule import exponential_lr as jax_lr
from idealnerf_tpu.train.torso import make_torso_frame_loss as jax_torso_loss
from idealnerf_tpu.train.torso import torso_signal as jax_torso_signal
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.core.composite import layered_composite
from idealnerf_tpu_torch.core.rays import pose_to_euler_trans
from idealnerf_tpu_torch.data.sampler import sample_ray_coords
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.train.head import HeadTrainer, apply_update
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.train.torso import (
    TORSO_POSE_PE, TorsoState, TorsoTrainer, init_torso_params,
    make_torso_frame_loss, make_torso_optimizer, torso_nerf_config,
    torso_ray_budget, torso_signal,
)

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, dim_aud_body=32,
             netdepth=4, netwidth=64, N_rand=48, N_samples=6,
             N_importance=6, lrate=5e-4, smo_size=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of tiny ops run faster on one thread beside the other test
    processes than on torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poses(n, seed=0):
    rng = np.random.RandomState(seed)
    q = np.linalg.qr(rng.randn(n, 3, 3))[0].astype(np.float32)
    return np.concatenate([q, rng.randn(n, 3, 1).astype(np.float32)], -1)


def test_pose_to_euler_trans_and_signal_match_jax():
    poses = _poses(5)
    got = pose_to_euler_trans(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_euler_trans(
        jnp.asarray(poses))), rtol=0, atol=1e-6)

    cfg = ExperimentConfig(dim_aud=64, dim_aud_body=32)
    aud = np.random.RandomState(1).randn(64).astype(np.float32)
    for pose in (poses[2], np.eye(4, dtype=np.float32)[:3]):
        sig = torso_signal(torch.from_numpy(aud), torch.from_numpy(pose),
                           cfg.dim_aud_body)
        assert sig.shape == (32 + TORSO_POSE_PE,)
        np.testing.assert_allclose(sig.numpy(), np.asarray(jax_torso_signal(
            jnp.asarray(aud), jnp.asarray(pose), 32)), rtol=0, atol=1e-6)
    assert TORSO_POSE_PE == 42
    tcfg = torso_nerf_config(cfg)
    assert (tcfg.dim_aud, tcfg.dim_expr, tcfg.dim_latent) == (32 + 42, 0, 0)
    assert tcfg.width == cfg.netwidth and tcfg.depth == cfg.netdepth


def test_layered_composite_limits_and_matches_jax():
    head = torch.full((5, 3), 0.8)
    # transparent torso (plate weight 1, no foreground): the head alone
    out = layered_composite(head, torch.ones(5), torch.zeros(5, 3))
    np.testing.assert_allclose(out.numpy(), 0.8, atol=1e-6)
    # opaque torso: its foreground alone
    out = layered_composite(head, torch.zeros(5), torch.full((5, 3), 0.3))
    np.testing.assert_allclose(out.numpy(), 0.3, atol=1e-6)
    rng = np.random.RandomState(0)
    h, lw, fg = (rng.rand(7, 3), rng.rand(7), rng.rand(7, 3))
    h, lw, fg = (x.astype(np.float32) for x in (h, lw, fg))
    got = layered_composite(*(torch.from_numpy(x) for x in (h, lw, fg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_composite(
        *(jnp.asarray(x) for x in (h, lw, fg)))), rtol=0, atol=1e-6)


def test_torso_ray_budget_draws_half_in_the_bottom_rect():
    cfg = ExperimentConfig(N_rand=64)
    budget, rect, box = torso_ray_budget(cfg, 12, 10)
    assert (budget.face, budget.background, budget.total) == (32, 32, 64)
    assert rect.tolist() == [0, 6, 9, 5]
    coords = sample_ray_coords(torch.Generator().manual_seed(0), 12, 10,
                               rect, box, torch.zeros((12, 10),
                                                      dtype=torch.uint8),
                               budget)
    assert (coords[:32, 0] >= 6).all() and (coords[32:, 0] < 6).all()
    assert len({tuple(c) for c in coords.tolist()}) == 64


def _tree_of(module):
    return jax.tree.map(np.asarray, bridge.module_to_tree(module))


@pytest.mark.parametrize("steps", [1, 2])
def test_torso_steps_match_jax(steps):
    """Loss and torso gradients of a step on the same coords with no random
    draws (generator=None / key=None) from bridged weights, then the Adam
    update against optax fed the same gradients; the head gets no
    gradient and stays as it was. Softplus density and multires=6 for the
    reasons test_torch_train.py::test_train_steps_match_jax gives."""
    kw = {**SMALL, "density_activation": "softplus", "multires": 6}
    jcfg, cfg = JaxConfig(**kw, flat_optimizer=False), ExperimentConfig(**kw)
    ds = make_synthetic_dataset(n_frames=3, H=16, W=16, dim_expr=8,
                                with_torso=True)
    # the port draws both nets; the bridge carries them to JAX trees and
    # back into fresh port modules
    head = init_params(cfg, ds.size, torch.Generator().manual_seed(0)).params
    torso0 = init_torso_params(cfg, torch.Generator().manual_seed(1))
    jhead = jax.tree.map(jnp.asarray, bridge.params_to_jax(head))
    jtorso = jax.tree.map(jnp.asarray, bridge.torso_params_to_jax(torso0))
    latent = torch.ones(ds.size, cfg.dim_latent)
    head = bridge.params_from_jax(jax.tree.map(np.asarray, jhead), cfg)
    before = {k: v.clone() for k, v in head.state_dict().items()}
    torso = bridge.torso_params_from_jax(jax.tree.map(np.asarray, jtorso),
                                         cfg)
    state = TorsoState(step=0, params=torso,
                       optimizer=make_torso_optimizer(cfg, torso))
    jds = jax_synthetic(n_frames=3, H=16, W=16, dim_expr=8, with_torso=True)
    jdata = jds.to_device()
    data = ds.to_device("cpu")
    coords = np.stack(np.meshgrid(np.arange(1, 16, 2), np.arange(0, 16, 3),
                                  indexing="ij"), -1).reshape(-1, 2)
    jhp = {**jhead, "latent_codes": jnp.asarray(latent.numpy())}
    jgrad = jax.jit(jax.value_and_grad(jax_torso_loss(jcfg, jds),
                                       has_aux=True), static_argnums=(3,))
    opt = optax.adam(jax_lr(jcfg.lrate, jcfg.lrate_decay), b1=0.9, b2=0.999)
    opt_state = opt.init(jtorso)
    loss_fn = make_torso_frame_loss(cfg, ds)
    for step in range(steps):
        index = step + 1
        with jax.default_matmul_precision("highest"):
            (jl, _), jg = jgrad(jtorso, jhp, jdata, index,
                                jnp.asarray(coords, jnp.int32), None)
        loss, _ = loss_fn(state.params, head, latent, data, index,
                          torch.from_numpy(coords), None)
        loss.backward()
        assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
        assert all(p.grad is None for p in head.parameters())

        holder = init_torso_params(cfg)
        with torch.no_grad():
            for p, q in zip(holder.parameters(), state.params.parameters()):
                p.copy_(q.grad)
        got = _tree_of(holder)
        for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(jg),
                                jax.tree.leaves(got)):
            r = np.asarray(r)
            err = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert err < 1e-4, (step, jax.tree_util.keystr(path), err)

        updates, opt_state = opt.update(
            jax.tree.map(jnp.asarray, got), opt_state, jtorso)
        jtorso = optax.apply_updates(jtorso, updates)
        apply_update(state, exponential_lr(cfg.lrate, cfg.lrate_decay)(
            state.step))
        for a, b in zip(jax.tree.leaves(_tree_of(state.params)),
                        jax.tree.leaves(jtorso)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert state.step == steps
    for k, v in head.state_dict().items():
        assert torch.equal(v, before[k]), k


def _tiny_cfg(**kw):
    return ExperimentConfig(**{**SMALL, "N_rand": 128, "N_samples": 8,
                               "N_importance": 8, "lrate": 2e-3,
                               "nosmo_iters": 10 ** 9,
                               "density_activation": "softplus", **kw})


def test_torso_trainer_learns_the_composite_with_a_frozen_head():
    cfg = _tiny_cfg()
    ds_head = make_synthetic_dataset(n_frames=2, H=16, W=16, dim_expr=8)
    ds_com = make_synthetic_dataset(n_frames=2, H=16, W=16, dim_expr=8,
                                    with_torso=True)
    assert np.abs(ds_com.images[0].astype(int)
                  - ds_head.images[0].astype(int)).max() > 30
    head = HeadTrainer(cfg, ds_head, seed=0)
    head.run(n_epochs=10, log_every=100, on_metrics=lambda s, m: None)
    before = {k: v.clone() for k, v in head.state.params.state_dict().items()}
    head.state.optimizer.zero_grad(set_to_none=True)
    torso = TorsoTrainer(cfg, ds_com, head.state.params,
                         latent_codes=head.state.latent_codes, seed=1,
                         smooth_audio=False)
    hist = []
    torso.run(n_steps=61, log_every=20, on_metrics=lambda s, m: hist.append(m))
    assert len(hist) == 4 and torso.step == 61
    assert all(math.isfinite(m["loss"]) for m in hist)
    assert hist[-1]["psnr"] > hist[0]["psnr"] + 1.5, (hist[0], hist[-1])
    assert hist[-1]["lr"] < hist[0]["lr"]
    for k, v in head.state.params.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in head.state.params.parameters())


def test_torso_resume_continues_like_an_uninterrupted_run(tmp_path):
    cfg = _tiny_cfg(N_rand=32, N_samples=4, N_importance=4)
    ds = make_synthetic_dataset(n_frames=2, H=12, W=12, dim_expr=8,
                                with_torso=True)
    head = init_params(cfg, ds.size, torch.Generator().manual_seed(0))
    quiet = dict(log_every=100, on_metrics=lambda s, m: None)
    whole = TorsoTrainer(cfg, ds, head.params, head.latent_codes, seed=3)
    whole.run(4, **quiet)
    first = TorsoTrainer(cfg, ds, head.params, head.latent_codes, seed=3,
                         ckpt_dir=str(tmp_path))
    first.run(2, **quiet)
    first.save()
    resumed = TorsoTrainer(cfg, ds, head.params, head.latent_codes, seed=3,
                           ckpt_dir=str(tmp_path))
    assert resumed.step == 2
    resumed.run(2, **quiet)
    assert resumed.step == whole.step == 4
    for (n, a), (_, b) in zip(whole.torso_params.named_parameters(),
                              resumed.torso_params.named_parameters()):
        assert torch.equal(a, b), n


def test_torso_bridge_round_trips_and_refuses_a_head_tree():
    cfg = ExperimentConfig(**SMALL)
    torso = init_torso_params(cfg, torch.Generator().manual_seed(0))
    tree = bridge.torso_params_to_jax(torso)
    back = bridge.torso_params_from_jax(tree, cfg)
    for (n, a), (_, b) in zip(torso.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n
    head = bridge.params_to_jax(init_params(cfg, 1).params)
    with pytest.raises(ValueError, match="shape"):
        bridge.torso_params_from_jax(head, cfg)
