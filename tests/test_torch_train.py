"""The head-training slice of the PyTorch port against the JAX package:
ray budget and sampler, rays at coords, the LR schedule, one train step
from bridged parameters (loss, gradients and the Adam update, before and
after the AudioNet -> AudioAttNet switch), and the port's own trainer,
checkpoints, resume and CLI on the CPU.

Tolerances: rays 1e-6; loss 1e-5 relative; gradients 1e-4 norm-relative
per leaf (f32 on both sides, summed in other orders); parameters after an
Adam update 1e-6 absolute."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.sampler import rays_at_coords as jax_rays_at_coords
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.train.head import make_frame_loss as jax_frame_loss
from idealnerf_tpu.train.schedule import exponential_lr as jax_lr
from idealnerf_tpu.train.state import make_optimizer as jax_optimizer
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.ckpt import CheckpointManager, partial_restore
from idealnerf_tpu_torch.cli import render_val, train_head
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.sampler import (
    RayBudget, rays_at_coords, sample_ray_coords,
)
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.train.head import (
    HeadTrainer, apply_update, make_frame_loss, train_use_pallas,
)
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.state import init_train_state

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=4, netwidth=64,
             N_rand=48, mouth_rays=8, torso_rays=8, N_samples=6,
             N_importance=6, lrate=5e-4, smo_size=4)
CLI_SMALL = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
             "--netdepth", "4", "--netwidth", "64", "--N_rand", "48",
             "--N_samples", "6", "--N_importance", "6"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The trainer tests run hundreds of tiny ops; beside other test
    processes on the same cores, torch's intra-op thread pool makes them
    many times slower than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ray_budget_split():
    b = RayBudget.from_config(3072, 512, 512, 0.95)
    assert b.mouth == 512 and b.torso == 512
    assert b.face == int(2048 * 0.95) and b.background == 2048 - b.face
    assert b.total == 3072


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_ray_coords_regions(seed):
    H = W = 40
    face_rect = torch.tensor([10, 8, 16, 20])          # x, y, w, h
    mouth_box = torch.tensor([14.0, 20.0, 18.0, 24.0])
    torso = torch.zeros((H, W), dtype=torch.uint8)
    torso[36:, :] = 1
    b = RayBudget(face=64, background=32, mouth=16, torso=8)
    coords = sample_ray_coords(torch.Generator().manual_seed(seed), H, W,
                               face_rect, mouth_box, torso, b).numpy()
    assert coords.shape == (120, 2)
    face_c = coords[:64]
    assert (face_c[:, 1] >= 10).all() and (face_c[:, 1] <= 26).all()
    assert (face_c[:, 0] >= 8).all() and (face_c[:, 0] <= 28).all()
    in_mouth = ((face_c[:, 1] >= 14) & (face_c[:, 1] <= 20)
                & (face_c[:, 0] >= 18) & (face_c[:, 0] <= 24))
    assert not in_mouth.any()
    bg_c = coords[64:96]
    in_rect = ((bg_c[:, 1] >= 10) & (bg_c[:, 1] <= 26)
               & (bg_c[:, 0] >= 8) & (bg_c[:, 0] <= 28))
    assert not in_rect.any()
    mouth_c = coords[96:112]
    assert (mouth_c[:, 1] >= 14).all() and (mouth_c[:, 1] <= 20).all()
    assert (mouth_c[:, 0] >= 18).all() and (mouth_c[:, 0] <= 24).all()
    assert (coords[112:, 0] >= 36).all()
    # without replacement within each region
    for lo, hi in ((0, 64), (64, 96), (96, 112), (112, 120)):
        ids = coords[lo:hi, 0] * W + coords[lo:hi, 1]
        assert len(np.unique(ids)) == hi - lo
    # the same generator state draws the same rays
    again = sample_ray_coords(torch.Generator().manual_seed(seed), H, W,
                              face_rect, mouth_box, torso, b).numpy()
    np.testing.assert_array_equal(coords, again)


def test_rays_at_coords_matches_jax():
    rng = np.random.RandomState(0)
    q = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    c2w = np.concatenate([q, rng.randn(3, 1).astype(np.float32)], -1)
    coords = np.stack([rng.randint(0, 24, 50), rng.randint(0, 30, 50)], -1)
    o, d = rays_at_coords(torch.from_numpy(coords), 50.0,
                          torch.from_numpy(c2w), 14.0, 11.0)
    jo, jd = jax_rays_at_coords(jnp.asarray(coords, jnp.int32), 50.0,
                                jnp.asarray(c2w), 14.0, 11.0)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_schedule_matches_optax():
    lr, ref = exponential_lr(8e-4, 500), jax_lr(8e-4, 500)
    for step in (0, 1, 17, 1000, 250_000, 750_000):
        np.testing.assert_allclose(lr(step), float(ref(step)), rtol=1e-6)


def test_train_use_pallas_follows_train_fused_on_cuda_only():
    cfg = ExperimentConfig()
    assert train_use_pallas(cfg, "cpu") is False
    assert train_use_pallas(cfg, "cuda") == "train_bf16"
    assert train_use_pallas(dataclasses.replace(cfg, train_fused=1),
                            "cuda") == "train"
    assert train_use_pallas(dataclasses.replace(cfg, train_fused=0),
                            "cuda") is False


def _tree_of(module_grads_holder):
    return jax.tree.map(np.asarray,
                        bridge.module_to_tree(module_grads_holder))


@pytest.mark.parametrize("nosmo_iters,steps", [(10 ** 9, 2), (2, 3)],
                         ids=["before_switch", "across_switch"])
def test_train_steps_match_jax(nosmo_iters, steps):
    """Loss and gradients of a step on the same coords with no random draws
    (generator=None / key=None) from bridged parameters, and the Adam
    update against optax fed the same gradients, step after step. The
    second case crosses the AudioNet -> AudioAttNet switch, where aud_att
    first gets a gradient after steps of zeros: torch's Adam must then use
    the shared step count, as optax does.

    Two settings keep the comparison on the training math. Softplus
    density keeps every coarse weight above sample_pdf's 1e-5 floor: where
    a ray's mass ends before the last bin the port pins the CDF's end to 1
    and the JAX package does not (ROADMAP.md C), which moves fine depths.
    multires=6 keeps the PE phases under ~20 rad: at multires=10 the two
    frameworks' f32 sin of ~300 rad phases differ by up to ~1e-4, enough
    to flip a few relu masks of the first layer and move its gradient by
    ~1e-3."""
    kw = {**SMALL, "nosmo_iters": nosmo_iters,
          "density_activation": "softplus", "multires": 6}
    jcfg, cfg = JaxConfig(**kw, flat_optimizer=False), ExperimentConfig(**kw)
    ds = make_synthetic_dataset(n_frames=3, H=16, W=16, dim_expr=8)
    # the port draws the weights; the bridge carries them to the JAX tree
    # and back into a fresh port TrainState
    init = init_train_state(cfg, ds.size, torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_jax(init.params))
    jlatent = jnp.ones((ds.size, cfg.dim_latent), jnp.float32)
    jtree = jax.tree.map(np.asarray, jparams)
    state = bridge.train_state_from_jax(jtree, np.asarray(jlatent), cfg)
    jds = jax_synthetic(n_frames=3, H=16, W=16, dim_expr=8)
    jdata = jds.to_device()
    data = ds.to_device("cpu")
    coords = np.stack(np.meshgrid(np.arange(2, 14, 2), np.arange(1, 15, 2),
                                  indexing="ij"), -1).reshape(-1, 2)
    opt = jax_optimizer(jcfg)
    diff = (jparams, jlatent)
    opt_state = opt.init(diff)
    sched = jax_lr(jcfg.lrate, jcfg.lrate_decay)
    jgrad = {}
    for step in range(steps):
        smooth = step >= nosmo_iters
        index = step % ds.size
        if smooth not in jgrad:
            jgrad[smooth] = jax.jit(jax.value_and_grad(
                jax_frame_loss(jcfg, jds, smooth), has_aux=True),
                static_argnums=(4,))
        with jax.default_matmul_precision("highest"):
            (jl, _), jg = jgrad[smooth](diff, jdata, index,
                                        jnp.asarray(coords, jnp.int32), None)
        loss, _ = make_frame_loss(cfg, ds, smooth)(
            state.params, state.latent_codes, data, index,
            torch.from_numpy(coords), None)
        loss.backward()
        assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))

        holder = bridge.params_from_jax(jtree, cfg)
        with torch.no_grad():
            for p, q in zip(holder.parameters(), state.params.parameters()):
                p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
        got = _tree_of(holder)
        ref = {k: jg[0][k] for k in got}
        # leaves the loss does not reach (aud_att before the switch,
        # ds_aud) have zero gradients: held to 1e-4 of a floor instead
        floor = 1e-6 * max(np.linalg.norm(np.asarray(r))
                           for r in jax.tree.leaves(ref))
        for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree.leaves(got)):
            r = np.asarray(r)
            err = np.linalg.norm(g - r) / max(np.linalg.norm(r), floor)
            assert err < 1e-4, (step, jax.tree_util.keystr(path), err)
        lat_g = state.latent_codes.grad.numpy()
        np.testing.assert_allclose(lat_g, np.asarray(jg[1]), rtol=1e-4,
                                   atol=1e-9)

        # the same gradients into optax, then one update on each side
        port_grads = ({**jax.tree.map(jnp.asarray, got),
                       **{k: jax.tree.map(jnp.zeros_like, v)
                          for k, v in diff[0].items() if k not in got}},
                      jnp.asarray(lat_g))
        updates, opt_state = opt.update(port_grads, opt_state, diff)
        diff = optax.apply_updates(diff, updates)
        assert np.isclose(float(sched(step)), exponential_lr(
            cfg.lrate, cfg.lrate_decay)(state.step), rtol=1e-6)
        apply_update(state, exponential_lr(cfg.lrate, cfg.lrate_decay)(
            state.step))
        after = _tree_of(state.params)
        for a, b in zip(jax.tree.leaves(after),
                        jax.tree.leaves({k: diff[0][k] for k in after})):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.latent_codes.detach().numpy(),
                                   np.asarray(diff[1]), rtol=0, atol=1e-6)
        jtree = jax.tree.map(np.asarray, diff[0])
    if nosmo_iters < steps:
        # aud_att moved only after the switch
        assert not np.allclose(_tree_of(state.params)["aud_att"]["att"]["w"],
                               np.asarray(jparams["aud_att"]["att"]["w"]))


def test_trainer_overfits_synthetic():
    cfg = ExperimentConfig(**{**SMALL, "N_rand": 128, "N_samples": 8,
                              "N_importance": 8, "lrate": 2e-3,
                              "nosmo_iters": 10 ** 9})
    ds = make_synthetic_dataset(n_frames=2, H=16, W=16, dim_expr=8)
    tr = HeadTrainer(cfg, ds, seed=0)
    hist = []
    tr.run(n_epochs=30, log_every=10, on_metrics=lambda s, m: hist.append(m))
    first, last = hist[0], hist[-1]
    assert all(math.isfinite(m["loss"]) for m in hist)
    assert last["loss"] < first["loss"], (first, last)
    assert last["psnr"] > first["psnr"] + 2.0, (first, last)
    assert last["lr"] < first["lr"]


def test_resume_continues_like_an_uninterrupted_run(tmp_path):
    cfg = ExperimentConfig(**{**SMALL, "nosmo_iters": 3})
    ds = make_synthetic_dataset(n_frames=2, H=12, W=12, dim_expr=8)
    quiet = dict(log_every=100, on_metrics=lambda s, m: None)
    whole = HeadTrainer(cfg, ds, seed=3)
    whole.run(n_epochs=3, **quiet)

    first = HeadTrainer(cfg, ds, seed=3, ckpt_dir=str(tmp_path))
    first.run(n_epochs=1, **quiet)
    first.save()
    resumed = HeadTrainer(cfg, ds, seed=3, ckpt_dir=str(tmp_path))
    assert resumed.global_step == 2
    resumed.run(n_epochs=2, **quiet)
    assert resumed.global_step == whole.global_step == 6
    for (n, a), (_, b) in zip(whole.state.params.named_parameters(),
                              resumed.state.params.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(whole.state.latent_codes, resumed.state.latent_codes)


def test_finetune_surgery_keeps_fresh_conditioned_layers(tmp_path):
    src = HeadTrainer(ExperimentConfig(**SMALL), make_synthetic_dataset(
        n_frames=2, H=12, W=12, dim_expr=8), seed=0,
        ckpt_dir=str(tmp_path / "src"))
    src.save()
    cfg = ExperimentConfig(**{**SMALL, "dim_aud": 40,
                              "ft_path": str(tmp_path / "src")})
    fresh = HeadTrainer(cfg, make_synthetic_dataset(
        n_frames=2, H=12, W=12, dim_expr=8), seed=1)
    ft = HeadTrainer(cfg, make_synthetic_dataset(
        n_frames=2, H=12, W=12, dim_expr=8), seed=1,
        ckpt_dir=str(tmp_path / "ft"))
    sp, fp, tp = (t.state.params["coarse"].pts_linears
                  for t in (src, fresh, ft))
    assert torch.equal(tp[1].weight, sp[1].weight)      # restored
    assert torch.equal(tp[0].weight, fp[0].weight)      # shape changed
    assert not torch.equal(tp[1].weight, fp[1].weight)


def test_checkpoint_manager_keeps_newest_and_refuses_orbax(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (5, 10, 15):
        mgr.save(s, {"x": torch.full((3,), float(s)), "step": s})
    assert mgr.all_steps() == [10, 15] and mgr.latest_step() == 15
    assert float(mgr.restore()["x"][0]) == 15.0
    assert float(mgr.restore(10)["x"][0]) == 10.0
    merged, dropped = partial_restore(
        mgr.restore(), {"x": torch.zeros(3, dtype=torch.float64),
                        "w": torch.zeros(2), "step": 0})
    assert merged["x"].dtype == torch.float64 and merged["x"][0] == 15.0
    assert merged["step"] == 15 and torch.equal(merged["w"], torch.zeros(2))
    assert dropped == ["w (missing in ckpt)"]
    merged, dropped = partial_restore({"x": torch.ones(4)},
                                      {"x": torch.zeros(3)})
    assert torch.equal(merged["x"], torch.zeros(3)) and len(dropped) == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    os.makedirs(tmp_path / "orbax" / "step_0000000100")
    with pytest.raises(NotImplementedError, match="orbax"):
        CheckpointManager(str(tmp_path / "orbax")).restore()


def test_train_head_cli_then_render_val_from_its_checkpoint(tmp_path):
    res = train_head.main(["--device", "cpu", "--synthetic", "2",
                           "--synthetic_hw", "12", *CLI_SMALL, "--epochs",
                           "2", "--i_print", "2", "--i_weights", "3",
                           "--basedir", str(tmp_path)])
    assert res["step"] == 4 and len(res["history"]) == 2
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["psnr"])
               for _, m in res["history"])
    assert CheckpointManager(res["ckpt_dir"]).all_steps() == [3, 4]
    out = render_val.main(["--device", "cpu", "--synthetic", "2",
                           "--synthetic_hw", "12", *CLI_SMALL, "--head_ckpt",
                           res["ckpt_dir"], "--save_path",
                           str(tmp_path / "frames")])
    assert math.isfinite(out["psnr"])


def test_train_head_cli_on_a_mesh(tmp_path):
    """train_head --data_devices 2 on two gloo ranks of the CPU: two frames
    a step, the single-device checkpoint layout written by rank 0, which
    render_val then reads; the metrics of rank 0 only."""
    res = train_head.main(["--device", "cpu", "--synthetic", "4",
                           "--synthetic_hw", "12", *CLI_SMALL, "--epochs",
                           "2", "--i_print", "2", "--i_weights", "3",
                           "--basedir", str(tmp_path), "--data_devices",
                           "2"])
    assert res["step"] == 4 and [s for s, _ in res["history"]] == [2, 4]
    assert all(m["frames_per_step"] == 2.0 and math.isfinite(m["loss"])
               for _, m in res["history"])
    assert CheckpointManager(res["ckpt_dir"]).all_steps() == [3, 4]
    ck = CheckpointManager(res["ckpt_dir"]).restore()
    assert ck["step"] == 4 and set(ck) >= {"params", "latent_codes",
                                           "optimizer", "rng"}
    rows = [json.loads(r) for r in open(tmp_path / "exp" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4]
    out = render_val.main(["--device", "cpu", "--synthetic", "2",
                           "--synthetic_hw", "12", *CLI_SMALL, "--head_ckpt",
                           res["ckpt_dir"], "--save_path",
                           str(tmp_path / "frames")])
    assert math.isfinite(out["psnr"])
