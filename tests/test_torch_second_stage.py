"""The second stage (cross-identity fine-tune) and the baseline trainer
of the PyTorch port against the JAX package: the cross-identity pairing,
one crop step's loss and gradients on a one-tile crop with no random
draws, without and with the aux terms (FAN landmark, VGG16, VGGFace), the
padded two-tile crop against the one-tile step, checkpointed tiles
against unchecked ones, the CLIs end to end on the CPU with each aux
flag, and the refusal (ROADMAP.md A13).

Inputs come from numpy with a fixed seed; weights go across through the
bridge. The JAX step's loss is composed here from the JAX package's own
pieces as its train/second_stage.py composes it (its step folds the
update in); the JAX step's own loss on the same weights is held to it.
Tolerances as tests/test_torch_train.py::test_train_steps_match_jax:
softplus density, multires 6, loss 1e-5 relative, gradients 1e-4
norm-relative per leaf."""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idealnerf_tpu.pipeline.fan as jfan
from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.core.render import render_rays as jax_render_rays
from idealnerf_tpu.data.sampler import rays_at_coords as jax_rays_at_coords
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.models.variants import build_field_fns as jax_field_fns
from idealnerf_tpu.train import baseline as jax_baseline
from idealnerf_tpu.train.head import compute_aud_feature as jax_aud_feature
from idealnerf_tpu.train.second_stage import (
    make_aux_loss as jax_make_aux_loss,
    make_cross_identity_dataset as jax_cross, make_second_stage_step,
)
from idealnerf_tpu.train.state import TrainState as JaxTrainState
from idealnerf_tpu.train.state import make_optimizer as jax_optimizer
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.losses import vgg as pvgg
from idealnerf_tpu_torch.pipeline import fan as pfan
from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.cli import common as cli_common
from idealnerf_tpu_torch.cli import (
    train_baseline, train_head, train_second_stage,
)
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.train.baseline import BaselineTrainer, baseline_config
from idealnerf_tpu_torch.train.second_stage import (
    SecondStageTrainer, crop_coords, make_aux_loss,
    make_cross_identity_dataset, make_second_stage_loss,
    make_second_stage_step as port_step,
)
from idealnerf_tpu_torch.utils.summary import SummaryWriter

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=4, netwidth=64,
             N_rand=48, mouth_rays=8, torso_rays=8, N_samples=6,
             N_importance=6, lrate=5e-4, smo_size=4, nosmo_iters=10 ** 9,
             density_activation="softplus", multires=6)
CLI = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
       "--netdepth", "4", "--netwidth", "64", "--N_rand", "48",
       "--N_samples", "6", "--N_importance", "6", "--smo_size", "4",
       "--density_activation", "softplus", "--multires", "6"]


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


def _subjects(hw=16):
    ident = make_synthetic_dataset(n_frames=3, H=hw, W=hw, dim_expr=8, seed=0)
    drive = make_synthetic_dataset(n_frames=2, H=hw, W=hw, dim_expr=8, seed=7)
    return ident, drive


def _grads(params, cfg):
    """The parameters' .grad as a JAX-layout numpy tree."""
    holder = bridge.params_from_jax(bridge.params_to_jax(params), cfg)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), params.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return bridge.module_to_tree(holder)


def test_cross_identity_dataset_pairing():
    """tests/test_losses_second_stage.py: the identity's frames with the
    driving audio and expressions, clamped to the driving clip, as the
    JAX package pairs them."""
    a = make_synthetic_dataset(n_frames=5, H=32, W=32, dim_expr=8, seed=0)
    b = make_synthetic_dataset(n_frames=3, H=32, W=32, dim_expr=8, seed=9)
    ds = make_cross_identity_dataset(a, b.auds, b.exprs)
    assert ds.size == 5
    np.testing.assert_array_equal(ds.images, a.images)
    np.testing.assert_array_equal(ds.auds, b.auds)
    np.testing.assert_array_equal(ds.aud_ids, [0, 1, 2, 2, 2])
    np.testing.assert_array_equal(ds.exprs[3], b.exprs[2])
    ja, jb = (jax_synthetic(n_frames=n, H=32, W=32, dim_expr=8, seed=s)
              for n, s in ((5, 0), (3, 9)))
    jds = jax_cross(ja, jb.auds, jb.exprs)
    for f in ("auds", "aud_ids", "exprs", "images", "poses"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f))


def _jax_crop_loss(jcfg, jds, crop, aux=None):
    """JAX train/second_stage.py's loss_fn on a one-tile crop, key=None,
    plus ``aux`` (JAX ``make_aux_loss``'s) over the assembled crops."""
    H, W = jds.hw

    def loss(diff, data, index):
        params, latent_codes = diff
        aud = jax_aud_feature(params, data["auds"], data["aud_ids"], index,
                              jcfg, False)
        rect = data["face_rects"][index]
        x0 = jnp.clip(rect[0], 0, W - crop)
        y0 = jnp.clip(rect[1], 0, H - crop)
        rr = y0 + jax.lax.broadcasted_iota(jnp.int32, (crop, crop), 0)
        cc = x0 + jax.lax.broadcasted_iota(jnp.int32, (crop, crop), 1)
        coords = jnp.stack([rr.reshape(-1), cc.reshape(-1)], axis=-1)
        o, d = jax_rays_at_coords(coords, jds.focal, data["poses"][index],
                                  jds.cx, jds.cy)
        image = data["images"][index].astype(jnp.float32) / 255.0
        bc = data["bc_img"].astype(jnp.float32) / 255.0
        target = image[coords[:, 0], coords[:, 1]]
        coarse, fine = jax_field_fns(params, jcfg, aud,
                                     data["exprs"][index],
                                     latent_codes[index])
        out = jax_render_rays(coarse, o, d, bc[coords[:, 0], coords[:, 1]],
                              jds.near, jds.far, jcfg.render_config(),
                              key=None, fine_fn=fine)
        loss = (jnp.mean((out["rgb_map"] - target) ** 2)
                + jnp.mean((out["rgb0"] - target) ** 2))
        if aux is not None:
            loss = loss + aux(out["rgb_map"].reshape(crop, crop, 3),
                              target.reshape(crop, crop, 3))
        return loss

    return loss


def _aux_pair(monkeypatch):
    """The FAN landmark term (one stack, a 64x64 crop: both packages'
    module constants patched) and the VGG16 and VGGFace terms at small
    weights, as the port's and JAX's make_aux_loss compose them on the
    same weights."""
    monkeypatch.setattr(jfan, "NUM_MODULES", 1)
    monkeypatch.setattr(jfan, "CROP_SIZE", 64)
    monkeypatch.setattr(pfan, "CROP_SIZE", 64)
    fan = pfan.init_fan(3, num_modules=1)
    vgg16, vggface = pvgg.init_vgg16(1), pvgg.init_vggface(2)
    w = dict(w_landmark=2e-5, w_vgg=0.05, w_vggface=0.05)
    jax_aux = jax_make_aux_loss(fan, bridge.vgg16_to_jax(vgg16),
                                bridge.vggface_to_jax(vggface), **w)
    return make_aux_loss(bridge.fan_from_jax(fan), vgg16, vggface,
                         **w), jax_aux


@pytest.mark.parametrize("with_aux", [False, True], ids=["mse", "aux"])
def test_second_stage_step_matches_jax(with_aux, monkeypatch):
    """One crop step (crop 10, one tile) on the driving audio from bridged
    weights, no random draws: the loss and every gradient against the JAX
    package's crop loss, whose value its own step also reports; the crop
    anchored at the clipped face-rect corner. With the aux terms on (the
    FAN landmark loss, VGG16, VGGFace), the JAX loss adds JAX's
    make_aux_loss over the same nets' weights."""
    cfg, jcfg = ExperimentConfig(**SMALL), JaxConfig(**SMALL,
                                                     flat_optimizer=False)
    ident, drive = _subjects()
    ds = make_cross_identity_dataset(ident, drive.auds, drive.exprs)
    jident, jdrive = (jax_synthetic(n_frames=n, H=16, W=16, dim_expr=8,
                                    seed=s) for n, s in ((3, 0), (2, 7)))
    jds = jax_cross(jident, jdrive.auds, jdrive.exprs)
    crop, index = 10, 2
    aux, jax_aux = _aux_pair(monkeypatch) if with_aux else (None, None)
    tree = bridge.seeded_tree(cfg, 4)
    params = bridge.params_from_jax(tree, cfg)
    latent = torch.nn.Parameter(torch.ones(3, 4))
    data = ds.to_device("cpu")
    rect = ds.face_rects[index]
    coords = crop_coords(data["face_rects"][index], crop, 16, 16).numpy()
    assert coords[0].tolist() == [min(rect[1], 6), min(rect[0], 6)]
    loss, parts = make_second_stage_loss(cfg, ds, crop, aux_loss=aux)(
        params, latent, data, index, None)
    assert (float(parts["aux_loss"].detach()) > 0) == with_aux
    loss.backward()
    diff = (jax.tree.map(jnp.asarray, tree), jnp.ones((3, 4)))
    jdata = jds.to_device()
    with jax.default_matmul_precision("highest"):
        jl, (jg, jlat) = jax.jit(jax.value_and_grad(
            _jax_crop_loss(jcfg, jds, crop, jax_aux)), static_argnums=(2,))(
                diff, jdata, index)
        if not with_aux:  # the JAX step's own loss (compiled once)
            _, m = make_second_stage_step(jcfg, jds, crop)(
                JaxTrainState(jnp.zeros((), jnp.int32), *diff,
                              jax_optimizer(jcfg).init(diff)),
                jdata, index, None)
            assert abs(float(m["loss"]) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    got = _grads(params, cfg)
    ref = {k: jg[k] for k in got}
    floor = 1e-6 * max(np.linalg.norm(np.asarray(r))
                       for r in jax.tree.leaves(ref))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got), strict=True):
        r = np.asarray(r)
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), floor)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)
    np.testing.assert_allclose(latent.grad.numpy(), np.asarray(jlat),
                               rtol=1e-4, atol=1e-9)


def _crop_grads(cfg, ds, crop, gen_seed=None, **kw):
    params = bridge.params_from_jax(bridge.seeded_tree(cfg, 4), cfg)
    latent = torch.nn.Parameter(torch.ones(ds.size, 4))
    gen = (None if gen_seed is None
           else torch.Generator().manual_seed(gen_seed))
    loss, _ = make_second_stage_loss(cfg, ds, crop, **kw)(
        params, latent, ds.to_device("cpu"), 1, gen)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in params.parameters()
                           if p.grad is not None] + [latent.grad.clone()]


def test_padded_two_tile_crop_matches_the_one_tile_step():
    """Crop 10 in tiles of 64 rays: two tiles, the second padded with 28
    rays from (1, 1, 1) along -z over a black plate and sliced off; the
    loss and gradients equal the one-tile step's (1e-6 and 1e-5
    norm-relative: the same rays in batches of other sizes)."""
    cfg = ExperimentConfig(**SMALL)
    ident, drive = _subjects()
    ds = make_cross_identity_dataset(ident, drive.auds, drive.exprs)
    one = _crop_grads(cfg, ds, 10)
    two = _crop_grads(cfg, ds, 10, tile=64)
    assert abs(float(one[0] - two[0])) <= 1e-6 * float(one[0])
    for a, b in zip(one[1], two[1], strict=True):
        assert float((a - b).norm()) <= 1e-5 * max(float(a.norm()), 1e-12)


def test_checkpointed_tiles_give_the_unchecked_gradients_bitwise():
    """With random draws (a seeded generator: jittered and importance
    depths), the recomputed tiles draw what the first pass drew: the
    gradients through torch.utils.checkpoint equal those without it,
    bitwise; another seed moves them."""
    cfg = ExperimentConfig(**SMALL)
    ident, drive = _subjects()
    ds = make_cross_identity_dataset(ident, drive.auds, drive.exprs)
    ck = _crop_grads(cfg, ds, 10, gen_seed=3, tile=64)
    plain = _crop_grads(cfg, ds, 10, gen_seed=3, tile=64,
                        checkpoint_tiles=False)
    assert torch.equal(ck[0], plain[0])
    for a, b in zip(ck[1], plain[1], strict=True):
        assert torch.equal(a, b)
    other = _crop_grads(cfg, ds, 10, gen_seed=4, tile=64)
    assert not torch.equal(other[1][0], ck[1][0])


def test_second_stage_trainer_merges_a_head_and_steps(tmp_path):
    """A head checkpoint merged through partial_restore (a net of another
    width stays fresh), then steps: finite, the lr decays, the weights
    move."""
    cfg = ExperimentConfig(**SMALL)
    ident, drive = _subjects()
    head = train_head.main(["--device", "cpu", "--synthetic", "3",
                            "--synthetic_hw", "16", *CLI, "--epochs", "1",
                            "--basedir", str(tmp_path)])
    ck = CheckpointManager(head["ckpt_dir"]).restore()
    tr = SecondStageTrainer(cfg, ident, drive.auds, drive.exprs,
                            init_params=ck["params"], crop=12, seed=1)
    for k, v in tr.state.params.state_dict().items():
        assert torch.equal(v, ck["params"][k]), k
    hist = []
    tr.run(3, log_every=1, on_metrics=lambda s, m: hist.append(m))
    assert len(hist) == 3 and all(math.isfinite(m["loss"]) for m in hist)
    assert hist[-1]["lr"] < hist[0]["lr"] and hist[0]["aux_loss"] == 0.0
    w = tr.state.params["coarse"].pts_linears[1].weight
    assert not torch.equal(w, ck["params"]["coarse.pts_linears.1.weight"])
    wide = dataclasses.replace(cfg, dim_aud=40)
    tr = SecondStageTrainer(wide, ident, drive.auds, init_params=ck["params"],
                            crop=40)
    assert tr.crop == 16
    assert not torch.equal(tr.state.params["coarse"].pts_linears[0].weight,
                           ck["params"]["coarse.pts_linears.0.weight"])


def test_baseline_config_and_trainer_match_the_jax_packages():
    """The baseline strips expressions, latents and the mouth and torso
    budgets as the JAX package does, and its trainer draws frames in
    random order."""
    kw = {**SMALL, "model_variant": "face_nerf_agg"}
    got = dataclasses.asdict(baseline_config(ExperimentConfig(**kw)))
    want = dataclasses.asdict(jax_baseline.baseline_config(JaxConfig(**kw)))
    assert {k: got[k] for k in got if k in want} == {k: want[k] for k in got
                                                     if k in want}
    ds = make_synthetic_dataset(n_frames=3, H=12, W=12, dim_expr=8)
    tr = BaselineTrainer(ExperimentConfig(**SMALL), ds, seed=0)
    assert tr.cfg.dim_expr == tr.cfg.dim_latent == 0
    hist = []
    tr.run(n_epochs=1, log_every=1, on_metrics=lambda s, m: hist.append(m))
    assert tr.global_step == 3 and all(math.isfinite(m["loss"])
                                       for m in hist)


def test_train_baseline_cli(tmp_path):
    res = train_baseline.main(["--device", "cpu", "--synthetic", "2",
                               "--synthetic_hw", "12", *CLI, "--epochs", "2",
                               "--i_print", "1", "--basedir", str(tmp_path)])
    assert res["step"] == 4 and len(res["history"]) == 4
    assert all(math.isfinite(m["loss"]) for _, m in res["history"])
    assert CheckpointManager(res["ckpt_dir"]).latest_step() == 4


def test_train_second_stage_cli_from_a_train_head_checkpoint(tmp_path):
    """train_head, then train_second_stage from its checkpoint on a
    driving clip's aud.npy: a checkpoint at the last step whose nets
    moved from the head's."""
    head = train_head.main(["--device", "cpu", "--synthetic", "2",
                            "--synthetic_hw", "16", *CLI, "--epochs", "1",
                            "--basedir", str(tmp_path)])
    aud = tmp_path / "aud.npy"
    np.save(aud, make_synthetic_dataset(n_frames=3, H=16, W=16, seed=7).auds)
    res = train_second_stage.main([
        "--device", "cpu", "--synthetic", "2", "--synthetic_hw", "16", *CLI,
        "--head_ckpt", head["ckpt_dir"], "--driving_aud", str(aud),
        "--crop", "12", "--steps", "3", "--basedir", str(tmp_path)])
    assert res["crop"] == 12 and res["step"] == 3
    ck = CheckpointManager(res["ckpt_dir"]).restore()
    assert ck["step"] == 3 and set(ck) == {"step", "params", "latent_codes"}
    h = CheckpointManager(head["ckpt_dir"]).restore()["params"]
    k = "fine.pts_linears.2.weight"
    assert not torch.equal(ck["params"][k], h[k])


AUX_FLAGS = {
    "aux-landmark": ["--aux_landmark", "1e-4"],
    "aux-vgg": ["--aux_vgg", "0.5"],
    "aux-vggface": ["--aux_vggface", "0.5"],
    "fan-npz": ["--aux_landmark", "1e-4", "--fan_npz", "fan.npz"],
}


@pytest.mark.parametrize("flags", AUX_FLAGS.values(), ids=AUX_FLAGS.keys())
def test_train_second_stage_cli_trains_with_each_aux_term(flags, tmp_path,
                                                          monkeypatch):
    """Each aux flag trains: two steps at crop 12 whose metrics.jsonl
    carries a finite aux_loss above zero, and a checkpoint. The FAN is one
    stack on a 64x64 crop (the port's module constants patched); with
    --fan_npz it is the JAX package's init_fan written as an npz, as its
    own --fan_npz reads one."""
    monkeypatch.setattr(pfan, "NUM_MODULES", 1)
    monkeypatch.setattr(pfan, "CROP_SIZE", 64)
    monkeypatch.chdir(tmp_path)
    if "--fan_npz" in flags:
        np.savez("fan.npz", **jfan.init_fan(jax.random.PRNGKey(0),
                                            num_modules=1))
    res = train_second_stage.main([
        "--device", "cpu", "--synthetic", "2", "--synthetic_hw", "16", *CLI,
        "--crop", "12", "--steps", "2", "--i_print", "1", "--basedir",
        str(tmp_path), "--expname", "aux", *flags])
    rows = [r for r in map(json.loads, open(
        tmp_path / "aux_second" / "metrics.jsonl")) if "train/aux_loss" in r]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(math.isfinite(r["train/aux_loss"]) and r["train/aux_loss"] > 0
               for r in rows)
    assert CheckpointManager(res["ckpt_dir"]).latest_step() == 2


def test_refusals():
    """The sharded crop waits for A13: the CLI and the step's ``mesh``
    raise, naming it; make_aux_loss with no term on is None."""
    with pytest.raises(NotImplementedError, match="A13"):
        train_second_stage.main(["--device", "cpu", "--synthetic", "1",
                                 "--ray_devices", "2"])
    ds = make_synthetic_dataset(n_frames=1, H=12, W=12, dim_expr=8)
    with pytest.raises(NotImplementedError, match="A13"):
        port_step(ExperimentConfig(**SMALL), ds, 8, mesh=object())
    assert make_aux_loss() is None
    assert make_aux_loss(fan=torch.nn.Linear(1, 1), w_landmark=0.0) is None


@pytest.mark.slow
def test_second_stage_finetune_improves():
    """tests/test_losses_second_stage.py::test_second_stage_finetune_improves
    on the port (a traceable aux term: any torch function of the crops)."""
    cfg = ExperimentConfig(**{**SMALL, "N_rand": 128, "N_samples": 8,
                              "N_importance": 8, "netdepth": 8,
                              "netwidth": 256, "multires": 10, "smo_size": 8,
                              "density_activation": "relu", "dim_aud": 64,
                              "dim_latent": 32})
    ident = make_synthetic_dataset(n_frames=3, H=32, W=32, dim_expr=8, seed=0)
    drive = make_synthetic_dataset(n_frames=3, H=32, W=32, dim_expr=8, seed=7)
    from idealnerf_tpu_torch.train.head import HeadTrainer

    pre = HeadTrainer(cfg, ident, seed=0)
    pre.run(n_epochs=8, log_every=100, on_metrics=lambda s, m: None)
    tr = SecondStageTrainer(
        cfg, ident, drive.auds, drive.exprs,
        init_params=pre.state.params.state_dict(), crop=24, seed=1,
        aux_loss=lambda p, t: 0.01 * torch.mean(torch.abs(p - t)))
    hist = []
    tr.run(31, log_every=30, on_metrics=lambda s, m: hist.append(m))
    assert hist[-1]["psnr"] > hist[0]["psnr"], hist
    assert hist[-1]["aux_loss"] > 0
