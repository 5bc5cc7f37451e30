"""The paper model's frame rendered by the JAX package's plain XLA path,
held as a fixture against the port's fused kernels.

The model (D=8, W=256, 64 + 128 samples, dim_aud 64, dim_expr 76,
dim_latent 32) is drawn with numpy from a seed (``bridge.seeded_tree``),
so both packages, and the card, build the same weights without JAX on the
card's side. The pose and plate are the synthetic subject's frame 0, the
conditioning ``bridge.seeded_conditioning``. Write the 450² fixture with

    JAX_PLATFORMS=cpu python tests/frame_fixture.py --hw 450

(several minutes on 8 CPU cores): an 8-bit PNG of the rgb, rounded to the
nearest level, and a JSON of the seed, config and shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PAPER = dict(netdepth=8, netwidth=256, netdepth_fine=8, netwidth_fine=256,
             dim_aud=64, dim_expr=76, dim_latent=32, N_samples=64,
             N_importance=128)
SEED = 0
SUBJECT = dict(n_frames=8, frame=0, with_torso=True)


def _subject(hw: int):
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(
        n_frames=SUBJECT["n_frames"], H=hw, W=hw,
        dim_expr=PAPER["dim_expr"], with_torso=SUBJECT["with_torso"])


def jax_frame(hw: int, seed: int = SEED, tile: int = 4096) -> np.ndarray:
    """(hw, hw, 3) f32 rgb of the JAX package's plain XLA renderer."""
    import jax.numpy as jnp

    from idealnerf_tpu.config import ExperimentConfig as JaxConfig
    from idealnerf_tpu.eval.renderer import make_frame_renderer
    from idealnerf_tpu_torch import bridge
    from idealnerf_tpu_torch.config import ExperimentConfig

    jcfg = JaxConfig(**PAPER)
    tree = bridge.seeded_tree(ExperimentConfig(**PAPER), seed)
    cond = bridge.seeded_conditioning(jcfg, seed)
    ds = _subject(hw)
    i = SUBJECT["frame"]
    render = make_frame_renderer(
        jcfg.face_nerf_config(), hw, hw, ds.focal, ds.near, ds.far,
        jcfg.render_config(), cx=ds.cx, cy=ds.cy, tile=min(tile, hw * hw),
        use_pallas=False)
    params = {k: tree[k] for k in ("coarse", "fine")}
    out = render(params, jnp.asarray(ds.poses[i]),
                 jnp.asarray(ds.bc_img.astype(np.float32) / 255.0),
                 aud=jnp.asarray(cond["aud"]), expr=jnp.asarray(cond["expr"]),
                 latent=jnp.asarray(cond["latent"]))
    return np.asarray(out, np.float32)


def port_frame(hw: int, seed: int = SEED, device: str = "cpu") -> np.ndarray:
    """The same frame through the port's fused renderer (on the CPU, the
    kernels' plain versions)."""
    import torch

    from idealnerf_tpu_torch import bridge
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.eval.renderer import make_frame_renderer

    cfg = ExperimentConfig(**PAPER)
    params = bridge.params_from_jax(bridge.seeded_tree(cfg, seed), cfg,
                                    device=device)
    cond = {k: torch.from_numpy(v).to(device) for k, v in
            bridge.seeded_conditioning(cfg, seed).items()}
    ds = _subject(hw)
    i = SUBJECT["frame"]
    render = make_frame_renderer(
        cfg.face_nerf_config(), hw, hw, ds.focal, ds.near, ds.far,
        cfg.render_config(), cx=ds.cx, cy=ds.cy)
    out = render(params, torch.from_numpy(ds.poses[i]).to(device),
                 torch.from_numpy(ds.bc_img).to(device).float() / 255.0,
                 **cond)
    return out.cpu().numpy()


def write_fixture(hw: int, seed: int = SEED) -> str:
    import time

    from idealnerf_tpu_torch.eval.video import write_png

    t0 = time.time()
    rgb = jax_frame(hw, seed)
    seconds = time.time() - t0
    stem = os.path.join(FIXTURES, f"jax_frame_{hw}")
    write_png(stem + ".png",
              np.round(255.0 * np.clip(rgb, 0.0, 1.0)).astype(np.uint8))
    with open(stem + ".json", "w") as fh:
        json.dump({"seed": seed, "hw": hw, "config": PAPER,
                   "subject": SUBJECT, "shape": list(rgb.shape),
                   "renderer": "idealnerf_tpu.eval.renderer."
                               "make_frame_renderer(use_pallas=False)",
                   "weights": "idealnerf_tpu_torch.bridge.seeded_tree",
                   "conditioning": "idealnerf_tpu_torch.bridge."
                                   "seeded_conditioning",
                   "png": "rgb rounded to the nearest of 256 levels",
                   "mean": float(rgb.mean()), "std": float(rgb.std()),
                   "render_seconds_on_cpu": round(seconds, 1)},
                  fh, indent=1)
    return stem + ".png"


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=450)
    ap.add_argument("--seed", type=int, default=SEED)
    print(write_fixture(ap.parse_args().hw, ap.parse_args().seed))
