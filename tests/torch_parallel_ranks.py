"""Rank functions of tests/test_torch_parallel.py: what each gloo rank
of a CPU mesh computes. Kept apart from the test file so that a spawned
rank imports torch and the port only, not jax.

Every rank builds the same inputs from seeds (the weights drawn on the
host, as the trainers draw them) and returns CPU tensors; the test file
builds the same inputs in its own process for the references.
"""

import numpy as np
import torch

from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.train.state import init_train_state
from idealnerf_tpu_torch.train.torso import init_torso_params

# the head step of test_torch_train.py::test_train_steps_match_jax
# (softplus density and multires 6 keep the JAX comparison on the
# training math, see there)
STEP = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=4, netwidth=64,
            N_rand=48, mouth_rays=8, torso_rays=8, N_samples=6,
            N_importance=6, lrate=5e-4, smo_size=4, nosmo_iters=10**9,
            density_activation="softplus", multires=6, dim_aud_body=16)
# the renders of test_torch_render_val.py / test_torch_reenact.py
RENDER = dict(dim_aud=16, dim_expr=8, dim_latent=4, netdepth=6, netwidth=64,
              dim_aud_body=8)
HW = 16
N_FRAMES = 4
TILE = 96  # 256 rays: two whole tiles and a padded third


def dataset(with_torso=False):
    return make_synthetic_dataset(n_frames=N_FRAMES, H=HW, W=HW, dim_expr=8,
                                  with_torso=with_torso)


def head_state(cfg, device="cpu"):
    return init_train_state(cfg, N_FRAMES, torch.Generator().manual_seed(0),
                            device)


def torso_params(cfg):
    return init_torso_params(cfg, torch.Generator().manual_seed(1))


def fixed_coords(n_frames, n_rand):
    """(n_frames, n_rand, 2) distinct pixels of each frame, no draws."""
    rng = np.random.RandomState(5)
    return torch.from_numpy(np.stack([
        np.stack(np.unravel_index(rng.choice(HW * HW, n_rand, replace=False),
                                  (HW, HW)), -1) for _ in range(n_frames)]))


def conditioning(cfg, n):
    rng = np.random.RandomState(3)
    return (torch.from_numpy(rng.randn(n, cfg.dim_aud).astype(np.float32)),
            torch.from_numpy(rng.randn(n, cfg.dim_expr).astype(np.float32)),
            torch.ones(n, cfg.dim_latent))


def crop_aux(pred, target):
    """An aux term that mixes the whole crop: its rows on other ranks
    reach every rank's gradient."""
    return (10.0 * (pred.mean(dim=(0, 1)) - target.mean(dim=(0, 1))) ** 2
            ).sum() + (pred[1:] - pred[:-1]).abs().mean()


def _grads(tensors):
    return [p.grad.detach().clone() if p.grad is not None
            else torch.zeros_like(p) for p in tensors]


def head_grads(mesh, indices, with_draws, remat=False):
    """The sharded head gradients of ``indices`` at STEP: on the fixed
    coords without draws, or sampled from generator seed 7; ``remat``
    recomputes each frame's forward in the backward."""
    from idealnerf_tpu_torch.parallel.sharded import make_sharded_grads

    cfg = ExperimentConfig(**STEP)
    ds = dataset()
    st = head_state(cfg)
    grads = make_sharded_grads(cfg, ds, mesh, remat=remat)
    if with_draws:
        m = grads(st, ds.to_device("cpu"), indices,
                  torch.Generator().manual_seed(7))
    else:
        m = grads(st, ds.to_device("cpu"), indices, None,
                  coords=fixed_coords(N_FRAMES, cfg.N_rand)[indices])
    return {"loss": float(m["loss"]), "grads": _grads(st.trainable())}


def torso_grads(mesh, indices):
    """The sharded torso gradients of ``indices`` at STEP, rays and jitter
    from generator seed 7."""
    from idealnerf_tpu_torch.parallel.sharded import make_sharded_torso_grads
    from idealnerf_tpu_torch.train.torso import TorsoState, make_torso_optimizer

    cfg = ExperimentConfig(**STEP)
    ds = dataset(with_torso=True)
    head = head_state(cfg)
    tp = torso_params(cfg)
    st = TorsoState(0, tp, make_torso_optimizer(cfg, tp))
    m = make_sharded_torso_grads(cfg, ds, mesh)(
        st, head.params, head.latent_codes.detach(), ds.to_device("cpu"),
        indices, torch.Generator().manual_seed(7))
    return {"loss": float(m["loss"]), "grads": _grads(st.trainable())}


def frames(mesh):
    """The sharded frame, composite, video and composite video at RENDER
    on pose/conditioning i of the dataset."""
    from idealnerf_tpu_torch.parallel import sharded
    from idealnerf_tpu_torch.train.torso import (
        torso_nerf_config, torso_signal,
    )

    cfg = ExperimentConfig(**RENDER)
    ds = dataset(with_torso=True)
    head = head_state(cfg).params
    torso = torso_params(cfg)
    ncfg, tcfg = cfg.face_nerf_config(), torso_nerf_config(cfg)
    auds, exprs, lats = conditioning(cfg, N_FRAMES)
    poses = torch.from_numpy(ds.poses)
    bc = torch.from_numpy(ds.bc_img).float() / 255.0
    sigs = torch.stack([torso_signal(auds[i], poses[i], cfg.dim_aud_body)
                        for i in range(N_FRAMES)])
    view = (HW, HW, ds.focal, ds.near, ds.far, cfg.render_config())
    kw = dict(cx=ds.cx, cy=ds.cy, tile=TILE)
    out = {
        "frame": sharded.make_sharded_frame_renderer(ncfg, mesh, *view, **kw)(
            head, poses[1], bc, auds[1], exprs[1], lats[1]),
        "composite": sharded.make_sharded_composite_renderer(
            ncfg, tcfg, mesh, *view, **kw)(
            head, torso, poses[1], poses[0], bc, auds[1], sigs[1], exprs[1],
            lats[1]),
    }
    if mesh.n_data > 1:
        out["video"] = sharded.make_sharded_video_renderer(
            ncfg, mesh, *view, **kw)(head, poses, bc, auds, exprs, lats)
        out["composite_video"] = sharded.make_sharded_composite_video_renderer(
            ncfg, tcfg, mesh, *view, **kw)(
            head, torso, poses, poses[0], bc, auds, sigs, exprs, lats)
    return out


def second_stage_grads(mesh, tile):
    """One sharded second-stage step's reduced gradients (before the
    update) on a 12 x 12 crop in tiles of ``tile`` rays, with crop_aux."""
    from idealnerf_tpu_torch.train.second_stage import make_second_stage_loss
    from idealnerf_tpu_torch.parallel.sharded import all_reduce_gradients

    cfg = ExperimentConfig(**STEP)
    ds = dataset()
    st = head_state(cfg)
    loss_fn = make_second_stage_loss(cfg, ds, 12, aux_loss=crop_aux,
                                     tile=tile, mesh=mesh)
    loss, aux = loss_fn(st.params, st.latent_codes, ds.to_device("cpu"), 1,
                        torch.Generator().manual_seed(9))
    loss.backward()
    mse, aux_total = all_reduce_gradients(
        st.trainable(), (aux["mse_loss"], aux["aux_loss"]), mesh.ray_group)
    return {"loss": float(mse + aux_total), "aux": float(aux_total),
            "grads": _grads(st.trainable())}


def trainer_params(mesh):
    """Every parameter after one epoch of ShardedHeadTrainer at STEP
    (N_FRAMES / n_data steps)."""
    from idealnerf_tpu_torch.parallel import ShardedHeadTrainer

    cfg = ExperimentConfig(**STEP)
    tr = ShardedHeadTrainer(cfg, dataset(), mesh, seed=0)
    tr.run(n_epochs=1, log_every=1)
    return {"step": tr.global_step,
            "params": [p.detach().clone() for p in tr.state.trainable()]}


def bad_mesh(mesh):
    """make_mesh's message for a shape that does not cover the world."""
    from idealnerf_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(mesh.size, mesh.size)
    except ValueError as e:
        return str(e)
    return None


def run(mesh, checks):
    """``checks``: (label, function name, kwargs) of this module's
    functions -> their results by label, the rank's place, backend and
    device under "rank" and its float32 matmul precision and cuDNN TF32
    setting under "precision"."""
    out = {label: globals()[name](mesh, **kw) for label, name, kw in checks}
    out["rank"] = (mesh.rank, mesh.data_index, mesh.ray_index, mesh.backend,
                   str(mesh.device))
    out["precision"] = (torch.get_float32_matmul_precision(),
                        torch.backends.cudnn.allow_tf32)
    return out


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def hang(mesh):
    import time

    time.sleep(600)
