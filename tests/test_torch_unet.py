"""The GRF-style UNet-attention trainer of the PyTorch port
(train/unet.py) against the JAX package: the parameter layout, the
landmark-first ray batch, one step's loss and gradients on given
coordinates with no random draws, and the trainer on the CPU.

Inputs come from numpy with a fixed seed; weights go across through the
bridge. The JAX side's step draws its own coordinates, so its loss is
composed here from the JAX package's own pieces exactly as its
train/unet.py composes them. Tolerances as
tests/test_torch_train.py::test_train_steps_match_jax: softplus density,
multires 6, loss 1e-5 relative, gradients 1e-4 norm-relative per leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.core.embedding import positional_encoding as jax_pe
from idealnerf_tpu.core.render import render_rays as jax_render_rays
from idealnerf_tpu.data.sampler import rays_at_coords as jax_rays_at_coords
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.models.attention import apply_attsets
from idealnerf_tpu.models.face_nerf import apply_point_conditioned
from idealnerf_tpu.models.face_unet import apply_face_unet
from idealnerf_tpu.models.projection import gather_image_features
from idealnerf_tpu.train import unet as jax_unet
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.train.unet import (
    UNetTrainer, init_unet_params, landmark_coords, make_unet_loss,
    unet_nerf_config,
)

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=4, netwidth=64,
             N_rand=96, mouth_rays=8, torso_rays=8, N_samples=4,
             N_importance=4, lrate=5e-4, nosmo_iters=10 ** 9,
             density_activation="softplus", multires=6)
HW = 34  # 16·2 + 2: the UNet's stages line up without padding


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_unet_params_have_the_jax_layout():
    """{"unet", "attsets", "coarse", "fine"} with the JAX package's shapes,
    and a 512-wide aud slot of the decoder."""
    cfg, jcfg = ExperimentConfig(**SMALL), JaxConfig(**SMALL)
    assert unet_nerf_config(cfg).dim_aud == jax_unet.unet_nerf_config(
        jcfg).dim_aud == 512
    params = init_unet_params(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda k: jax_unet.init_unet_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = bridge.module_to_tree(params)
    assert set(got) == set(want) == {"unet", "attsets", "coarse", "fine"}
    assert jax.tree.map(np.shape, got) == jax.tree.map(lambda x: x.shape,
                                                       want)


def test_landmark_coords_lead_as_rows_and_cols():
    """The 68 landmarks, stored (x, y), become clamped [row, col], as the
    JAX step builds them."""
    ds = make_synthetic_dataset(n_frames=2, H=HW, W=HW, dim_expr=8)
    lms = ds.landmarks[1].copy()
    lms[0] = (-3.0, HW + 5.0)
    got = landmark_coords(torch.from_numpy(lms), HW, HW).numpy()
    rows = np.clip(np.round(lms[:, 1]), 0, HW - 1)
    cols = np.clip(np.round(lms[:, 0]), 0, HW - 1)
    np.testing.assert_array_equal(got, np.stack([rows, cols], -1))
    assert tuple(got[0]) == (HW - 1, 0)


def _jax_loss(jcfg, jds):
    """JAX train/unet.py's loss_fn on given coordinates, key=None."""
    focal, cx, cy = jds.focal, jds.cx, jds.cy
    ncfg = jax_unet.unet_nerf_config(jcfg)
    rc = jcfg.render_config()
    intrinsic = jnp.array([[focal, 0.0, cx], [0.0, focal, cy],
                           [0.0, 0.0, 1.0]])

    def field_fn(params, net, fmap, pose):
        def fn(pts, viewdirs):
            R, S, _ = pts.shape
            flat = pts.reshape(R * S, 3)
            pe_pts = jax_pe(flat, jcfg.multires)
            dirs = jnp.broadcast_to(viewdirs[:, None, :],
                                    (R, S, 3)).reshape(R * S, 3)
            pe_dirs = jax_pe(dirs, jcfg.multires_views)
            feats = gather_image_features(flat, pose, intrinsic, fmap,
                                          channels_first=True)
            cond = apply_attsets(params["attsets"], jnp.concatenate(
                [feats, pe_pts], axis=-1)[:, None, :])
            return apply_point_conditioned(params[net], ncfg, pe_pts,
                                           pe_dirs, cond).reshape(R, S, 4)

        return fn

    def loss(params, data, index, coords):
        pose = data["poses"][index]
        image = data["images"][index].astype(jnp.float32) / 255.0
        bc = data["bc_img"].astype(jnp.float32) / 255.0
        target = image[coords[:, 0], coords[:, 1]]
        bc_rgb = bc[coords[:, 0], coords[:, 1]]
        o, d = jax_rays_at_coords(coords, focal, pose, cx, cy)
        emb = jax_pe(image, jax_unet.EMBED_IMG_MULTIRES)[None]
        fmap = apply_face_unet(params["unet"], emb,
                               embed_ln=emb.shape[-1])[0]
        out = jax_render_rays(field_fn(params, "coarse", fmap, pose), o, d,
                              bc_rgb, jds.near, jds.far, rc, key=None,
                              fine_fn=field_fn(params, "fine", fmap, pose))
        return (jnp.mean((out["rgb_map"] - target) ** 2)
                + jnp.mean((out["rgb0"] - target) ** 2))

    return loss


def test_unet_step_matches_jax():
    """One step's loss and gradients (UNet, AttSets, both decoders) on the
    frame's landmark pixels and a grid of rays, no random draws."""
    cfg, jcfg = ExperimentConfig(**SMALL), JaxConfig(**SMALL)
    ds = make_synthetic_dataset(n_frames=2, H=HW, W=HW, dim_expr=8)
    jds = jax_synthetic(n_frames=2, H=HW, W=HW, dim_expr=8)
    params = init_unet_params(cfg, torch.Generator().manual_seed(0))
    tree = bridge.module_to_tree(params)
    grid = np.stack(np.meshgrid(np.arange(4, 30, 6), np.arange(3, 31, 7),
                                indexing="ij"), -1).reshape(-1, 2)
    lm = landmark_coords(torch.from_numpy(ds.landmarks[1]), HW, HW).numpy()
    coords = np.concatenate([lm[::7], grid]).astype(np.int64)
    loss, _ = make_unet_loss(cfg, ds)(params, ds.to_device("cpu"), 1,
                                      torch.from_numpy(coords), None)
    loss.backward()
    with jax.default_matmul_precision("highest"):
        jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jcfg, jds)))(
            jax.tree.map(jnp.asarray, tree), jds.to_device(), 1,
            jnp.asarray(coords, jnp.int32))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    holder = init_unet_params(cfg)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), params.parameters()):
            p.copy_(q.grad)
    got = bridge.module_to_tree(holder)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(got), strict=True):
        r = np.asarray(r)
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-12)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)
    assert np.linalg.norm(got["unet"]["enc"][0]["w"]) > 0


def test_unet_trainer_steps_on_the_cpu():
    """Three steps at 34²: finite losses, every parameter moved but
    AttSets' d5 (its softmax runs over one view, so the mask is 1 and d5
    gets no gradient, on both sides), the lr decays; rays drawn from a
    seeded generator repeat."""
    cfg = ExperimentConfig(**SMALL)
    ds = make_synthetic_dataset(n_frames=2, H=HW, W=HW, dim_expr=8)
    runs = []
    for _ in range(2):
        tr = UNetTrainer(cfg, ds, seed=0)
        before = {n: p.detach().clone()
                  for n, p in tr.params.named_parameters()}
        hist = []
        tr.run(n_steps=3, log_every=1, on_metrics=lambda s, m: hist.append(m))
        assert tr.step == 3 and len(hist) == 3
        assert all(np.isfinite(m["loss"]) for m in hist)
        assert hist[-1]["lr"] < hist[0]["lr"]
        still = [n for n, p in tr.params.named_parameters()
                 if torch.equal(before[n], p)]
        assert still == ["attsets.d5.weight", "attsets.d5.bias"], still
        runs.append([m["loss"] for m in hist])
    assert runs[0] == runs[1]
