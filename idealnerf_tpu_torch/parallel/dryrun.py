"""A multi-rank dry run on the CPU (counterpart of
``__graft_entry__.dryrun_multichip``): one sharded train step, one
ray-sharded frame and, where the mesh has a 'data' axis, one
frame-batched video render, on ``n`` gloo ranks at a tiny size.

    python -m idealnerf_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import sys

import torch

from idealnerf_tpu_torch.parallel.launch import launch

# the JAX dry run's configuration
_TINY = dict(
    dim_aud=64, dim_expr=8, dim_latent=32,
    N_rand=128, mouth_rays=16, torso_rays=16, sample_rate=0.9,
    N_samples=8, N_importance=8, lrate=5e-4,
    nosmo_iters=10**9,
)


def _dryrun_rank(mesh, n_devices: int) -> dict:
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.parallel.mesh import make_mesh
    from idealnerf_tpu_torch.parallel.sharded import (
        make_sharded_frame_renderer, make_sharded_train_step,
        make_sharded_video_renderer,
    )
    from idealnerf_tpu_torch.train.state import init_train_state

    n_data = mesh.n_data
    cfg = ExperimentConfig(**_TINY)
    ds = make_synthetic_dataset(n_frames=2 * n_data, H=24, W=24, dim_expr=8)
    data = ds.to_device(mesh.device)
    state = init_train_state(cfg, ds.size, torch.Generator().manual_seed(0),
                             mesh.device)
    step = make_sharded_train_step(cfg, ds, mesh, smooth_audio=False)
    m = step(state, data, list(range(2 * n_data)),
             torch.Generator().manual_seed(1))
    out = {"loss": float(m["loss"]), "mesh": mesh.shape}

    # every rank on the 'ray' axis of a second mesh over the same ranks
    H, W = ds.hw
    mesh_ray = make_mesh(n_ray=n_devices, device=mesh.device)
    tile = (H * W) // 4
    tile -= tile % n_devices
    kw = dict(cx=ds.cx, cy=ds.cy, tile=tile)
    ncfg, rcfg = cfg.face_nerf_config(), cfg.render_config()
    bc = data["bc_img"].float() / 255.0
    render = make_sharded_frame_renderer(ncfg, mesh_ray, H, W, ds.focal,
                                         ds.near, ds.far, rcfg, **kw)
    frame = render(state.params, data["poses"][0], bc,
                   aud=torch.zeros(cfg.dim_aud), expr=torch.zeros(cfg.dim_expr),
                   latent=state.latent_codes[0].detach())
    out["frame"] = frame
    if n_data > 1:
        video = make_sharded_video_renderer(ncfg, mesh, H, W, ds.focal,
                                            ds.near, ds.far, rcfg, **kw)
        out["video"] = video(
            state.params, data["poses"][:n_data], bc,
            torch.zeros(n_data, cfg.dim_aud),
            torch.zeros(n_data, cfg.dim_expr),
            state.latent_codes[0].detach().expand(n_data, -1))
    return out


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> dict:
    """The dry run on ``n_devices`` gloo ranks of the CPU -> rank 0's
    {"loss", "mesh", "frame", "video" (with a 'data' axis)}; raises where
    a result is not finite or not of its shape."""
    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    out = launch(_dryrun_rank, n_data, n_devices // n_data, device="cpu",
                 args=(n_devices,), timeout=timeout)[0]
    if not torch.isfinite(torch.tensor(out["loss"])):
        raise AssertionError(f"non-finite loss {out['loss']}")
    print(f"dryrun_multichip OK (train): {n_devices} ranks, mesh "
          f"{out['mesh']}, loss={out['loss']:.5f}")
    frame = out["frame"]
    if frame.shape != (24, 24, 3) or not torch.isfinite(frame).all():
        raise AssertionError(f"ray-sharded frame {tuple(frame.shape)}")
    print(f"dryrun_multichip OK (eval): {n_devices}-way ray-sharded 24x24 "
          "frame render finite")
    if n_data > 1:
        video = out["video"]
        if (video.shape != (n_data, 24, 24, 3)
                or not torch.isfinite(video).all()):
            raise AssertionError(f"video batch {tuple(video.shape)}")
        print(f"dryrun_multichip OK (video): {n_data}-frame batch x "
              f"{n_devices // n_data}-way rays")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
