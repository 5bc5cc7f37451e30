"""The composite frame and the reenactment of the PyTorch port against
the JAX package (fused "ray" path, Pallas in interpret mode), per frame
and temporal, the driving audio features and expressions, the
train_torso, eval_reenact and serve CLIs on the CPU, the modes they
refuse, and the nets the kernels take: a narrower net runs zero-padded to
the chain's widths (ROADMAP.md C1).

The composite frame is held to 3e-2 plus a correlation above 0.999, as
the head frame in tests/test_torch_render_val.py: both sides round
weights and activations to bf16, at points that can land one ulp apart.
The audio features are f32 on both sides, 1e-5."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.eval.reenact import reenact as jax_reenact
from idealnerf_tpu.eval.reenact import (
    smoothed_audio_features as jax_smoothed_features,
)
from idealnerf_tpu.eval.renderer import (
    make_composite_frame_renderer as jax_composite_renderer,
)
from idealnerf_tpu.train.torso import torso_nerf_config as jax_torso_config
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.cli import eval_reenact, serve, train_torso
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval import reenact as reenact_mod
from idealnerf_tpu_torch.eval.video import read_avi_frames
from idealnerf_tpu_torch.eval.renderer import make_composite_frame_renderer
from idealnerf_tpu_torch.kernels import build as kbuild
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.models.face_nerf import fold_conditioning
from idealnerf_tpu_torch.train.head import HeadTrainer, train_use_pallas
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.train.torso import (
    init_torso_params, torso_nerf_config, torso_signal,
)

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, dim_aud_body=16,
             netdepth=6, netwidth=64, smo_size=4)
CLI_SMALL = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
             "--dim_aud_body", "16", "--netdepth", "4", "--netwidth", "64",
             "--N_rand", "64", "--N_samples", "6", "--N_importance", "6"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=3e-2)
    c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert c > 0.999, c


def test_composite_frame_matches_jax_fused_renderer():
    jcfg, cfg = JaxConfig(**SMALL), ExperimentConfig(**SMALL)
    ds = make_synthetic_dataset(n_frames=2, H=16, W=16, dim_expr=8,
                                with_torso=True)
    head = init_params(cfg, ds.size, torch.Generator().manual_seed(0)).params
    torso = init_torso_params(cfg, torch.Generator().manual_seed(1))
    jhead = jax.tree.map(jnp.asarray, bridge.params_to_jax(head))
    jtorso = jax.tree.map(jnp.asarray, bridge.torso_params_to_jax(torso))
    rng = np.random.RandomState(0)
    aud = rng.randn(32).astype(np.float32)
    expr, latent = ds.exprs[1], np.ones(4, np.float32)
    pose, pose0 = ds.poses[1], ds.poses[0]
    bc = ds.bc_img.astype(np.float32) / 255.0
    signal = torso_signal(torch.from_numpy(aud), torch.from_numpy(pose), 16)

    ref = jax_composite_renderer(
        jcfg.face_nerf_config(), jax_torso_config(jcfg), 16, 16, ds.focal,
        ds.near, ds.far, jcfg.render_config(), cx=ds.cx, cy=ds.cy,
        use_pallas="ray")(
        jhead, jtorso, jnp.asarray(pose), jnp.asarray(pose0), jnp.asarray(bc),
        aud=jnp.asarray(aud), signal=jnp.asarray(signal.numpy()),
        expr=jnp.asarray(expr), latent=jnp.asarray(latent))
    out = make_composite_frame_renderer(
        cfg.face_nerf_config(), torso_nerf_config(cfg), 16, 16, ds.focal,
        ds.near, ds.far, cfg.render_config(), cx=ds.cx, cy=ds.cy)(
        head, torso, torch.from_numpy(pose), torch.from_numpy(pose0),
        torch.from_numpy(bc), aud=torch.from_numpy(aud), signal=signal,
        expr=torch.from_numpy(expr), latent=torch.from_numpy(latent))
    assert out.shape == (16, 16, 3)
    _agree(out.numpy(), ref)


@pytest.mark.parametrize("smooth", [True, False])
def test_smoothed_audio_features_match_jax(smooth):
    cfg = ExperimentConfig(**SMALL)
    params = init_params(cfg, 1, torch.Generator().manual_seed(2)).params
    auds = np.random.RandomState(3).randn(9, 16, 29).astype(np.float32)
    got = reenact_mod.smoothed_audio_features(params, torch.from_numpy(auds),
                                              cfg, smooth)
    ref = jax_smoothed_features(
        jax.tree.map(jnp.asarray, bridge.params_to_jax(params)),
        jnp.asarray(auds), JaxConfig(**SMALL), smooth)
    assert got.shape == (9, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_load_driving_exprs(tmp_path):
    exprs = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    path = tmp_path / "transforms_val.json"
    path.write_text(json.dumps({"frames": [{"exp": e.tolist(), "aud_id": i}
                                           for i, e in enumerate(exprs)]}))
    got = reenact_mod.load_driving_exprs(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, exprs)


def _cli_run(tmp_path, *extra):
    return ["--device", "cpu", "--synthetic", "2", "--synthetic_hw", "12",
            *CLI_SMALL, "--basedir", str(tmp_path), *extra]


def test_train_torso_then_eval_reenact_on_cpu(tmp_path):
    cfg = ExperimentConfig(dim_aud=32, dim_expr=8, dim_latent=4,
                           dim_aud_body=16, netdepth=4, netwidth=64)
    ds = make_synthetic_dataset(n_frames=2, H=12, W=12, dim_expr=8)
    HeadTrainer(cfg, ds, seed=0, ckpt_dir=str(tmp_path / "head")).save()
    res = train_torso.main(_cli_run(tmp_path, "--head_ckpt",
                                    str(tmp_path / "head"), "--steps", "3",
                                    "--i_print", "2"))
    assert res["step"] == 3 and [s for s, _ in res["history"]] == [0, 2]
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["psnr"])
               for _, m in res["history"])
    assert CheckpointManager(res["ckpt_dir"]).all_steps() == [3]
    head = CheckpointManager(str(tmp_path / "head")).restore()["params"]
    for k, v in res["head_params"].state_dict().items():
        assert torch.equal(v, head[k]), k

    save = tmp_path / "frames"
    out = eval_reenact.main(_cli_run(
        tmp_path, "--head_ckpt", str(tmp_path / "head"), "--torso_ckpt",
        res["ckpt_dir"], "--save_path", str(save)))
    assert out["frames"] == 2
    assert math.isfinite(out["psnr"]) and math.isfinite(out["frame_ms"])
    assert sorted(os.listdir(save)) == ["exp.avi", "exp_00000.jpg"]
    video, fps = read_avi_frames(str(save / "exp.avi"))
    assert fps == 25.0 and video.shape == (2, 12, 12, 3)
    head_only = eval_reenact.main(_cli_run(
        tmp_path, "--head_ckpt", str(tmp_path / "head"), "--max_frames", "1",
        "--save_path", str(tmp_path / "head_frames")))
    assert head_only["frames"] == 1 and math.isfinite(head_only["psnr"])


def test_reenact_frame_is_the_composite_renderers_frame():
    """Frame i of the per-frame reenact equals the composite renderer's
    frame for the same pose, plate, audio feature, expression and latent;
    poses cycle through the identity and expressions clamp at the end of
    the driving sequence."""
    cfg = ExperimentConfig(**SMALL, N_samples=6, N_importance=6)
    ds = make_synthetic_dataset(n_frames=2, H=12, W=12, dim_expr=8,
                                with_torso=True)
    st = init_params(cfg, ds.size, torch.Generator().manual_seed(0))
    torso = init_torso_params(cfg, torch.Generator().manual_seed(1))
    exprs = ds.exprs[:2]
    times = []
    frames = reenact_mod.reenact(cfg, st.params, ds, ds.auds[:2].repeat(2, 0),
                                 driving_exprs=exprs,
                                 latent_codes=st.latent_codes,
                                 torso_params=torso, frame_times=times)
    assert frames.shape == (4, 12, 12, 3) and len(times) == 4
    assert np.isfinite(frames).all()
    feats = reenact_mod.smoothed_audio_features(
        st.params, torch.from_numpy(ds.auds[:2].repeat(2, 0)), cfg)
    render = make_composite_frame_renderer(
        cfg.face_nerf_config(), torso_nerf_config(cfg), 12, 12, ds.focal,
        ds.near, ds.far, cfg.render_config(), cx=ds.cx, cy=ds.cy)
    pose = torch.from_numpy(ds.poses[1])
    want = render(st.params, torso, pose, torch.from_numpy(ds.poses[0]),
                  torch.from_numpy(ds.bc_img).float() / 255.0, aud=feats[3],
                  signal=torso_signal(feats[3], pose, cfg.dim_aud_body),
                  expr=torch.from_numpy(exprs[1]),
                  latent=st.latent_codes[0])
    np.testing.assert_array_equal(frames[3], want.clamp(0, 1).numpy())


_REFUSED = [
    # the fast modes are ported; with a mesh flag they still meet A13
    (eval_reenact.main, ["--fast", "40", "--ray_devices", "2"], "A13"),
    (eval_reenact.main, ["--tighten_bounds", "1", "--data_devices", "2"],
     "A13"),
    (eval_reenact.main, ["--ray_devices", "2"], "A13"),
    (eval_reenact.main, ["--data_devices", "2"], "A13"),
    (train_torso.main, ["--ray_devices", "2"], "A13"),
    (train_torso.main, ["--data_devices", "2"], "A13"),
    (reenact_mod.reenact, {"fast_keep": 0.4, "mesh": object()}, "A13"),
    (reenact_mod.reenact, {"bounds": (0.4, 0.8), "mesh": object()}, "A13"),
    (reenact_mod.reenact, {"mesh": object()}, "A13"),
]


@pytest.mark.parametrize("entry,flags,item", _REFUSED,
                         ids=[f"{e.__module__.split('.')[-1]}-"
                              f"{next(iter(f)).strip('-')}"
                              for e, f, _ in _REFUSED])
def test_unported_modes_raise_naming_their_roadmap_item(entry, flags, item,
                                                        tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        if isinstance(flags, dict):
            entry(ExperimentConfig(), None, None, None, **flags)
        else:
            entry(["--device", "cpu", "--synthetic", "1", "--basedir",
                   str(tmp_path), *flags])


_INVALID = {
    "eval_reenact-roll_k_torso-1": (
        eval_reenact.main, ["--temporal", "5", "--roll_k_torso", "1"],
        "roll_k_torso"),
    "eval_reenact-prior-without-temporal": (
        eval_reenact.main, ["--prior", "1", "--synthetic_hw", "8",
                            "--netwidth", "64", "--netdepth", "2"],
        "use_prior requires"),
    "reenact-roll_k_torso-1": (
        reenact_mod.reenact, {"temporal": 5, "roll_k_torso": 1},
        "roll_k_torso"),
    "reenact-roll_k-with-roll_k_torso": (
        reenact_mod.reenact, {"temporal": 5, "roll_k": 2, "roll_k_torso": 2},
        "exclusive"),
    "reenact-cycle-under-roll_k_torso": (
        reenact_mod.reenact, {"temporal": 5, "roll_k_torso": 4,
                              "cycle": True}, "cycle"),
    "reenact-cycle-under-roll_k": (
        reenact_mod.reenact, {"temporal": 5, "roll_k": 4, "cycle": True},
        "cycle"),
    "reenact-use_prior-without-temporal": (
        reenact_mod.reenact, {"use_prior": True}, "use_prior requires"),
    "reenact-temporal-0": (
        reenact_mod.reenact, {"temporal": 0}, "temporal must be"),
}


@pytest.mark.parametrize("entry,flags,match", _INVALID.values(),
                         ids=_INVALID.keys())
def test_invalid_modes_raise_value_error(entry, flags, match, tmp_path):
    """The JAX package's refusals of the temporal modes, and a rolling
    period of 1, which the JAX package accepts and then fails on
    (ROADMAP.md C)."""
    with pytest.raises(ValueError, match=match):
        if isinstance(flags, dict):
            entry(ExperimentConfig(), None, None, None, **flags)
        else:
            entry(["--device", "cpu", "--synthetic", "1", "--basedir",
                   str(tmp_path), *flags])


# ------------------------------------------------------ temporal reenact

TEMPORAL = dict(dim_aud=32, dim_expr=8, dim_latent=4, dim_aud_body=16,
                netdepth=6, netwidth=64, smo_size=4, N_samples=8,
                N_importance=8, density_activation="softplus")


@pytest.mark.parametrize("cycle", [False, True], ids=["per-frame", "cycle"])
def test_head_temporal_reenact_matches_jax(cycle):
    """Head-only reenact(temporal=3) over 5 frames (keyframes 0 and 3)
    against the JAX reenact on the same bridged weights and track, per
    frame 3e-2 and correlation > 0.999; the port's frame_times has one
    wall time per frame."""
    jcfg, cfg = JaxConfig(**TEMPORAL), ExperimentConfig(**TEMPORAL)
    ds = make_synthetic_dataset(n_frames=5, H=16, W=16, dim_expr=8)
    st = init_params(cfg, ds.size, torch.Generator().manual_seed(3))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_jax(st.params))
    kw = dict(max_frames=5, temporal=3, s_delta=8, cycle=cycle)
    want = jax_reenact(jcfg, jparams, ds, ds.auds, driving_exprs=ds.exprs,
                       latent_codes=jnp.asarray(st.latent_codes.numpy()),
                       **kw)
    times = []
    got = reenact_mod.reenact(cfg, st.params, ds, ds.auds,
                              driving_exprs=ds.exprs,
                              latent_codes=st.latent_codes,
                              frame_times=times, **kw)
    assert got.shape == (5, 16, 16, 3) and len(times) == 5
    for g, w in zip(got, np.asarray(want)):
        _agree(g, w)


def test_composite_temporal_reenact_cycle_is_the_per_frame_loop():
    """reenact(temporal=4, cycle=True) of the composite over 7 frames
    gives the per-frame loop's frames bitwise, with one wall time per
    frame, under per-field priors; its keyframe is the per-frame
    composite reenact's frame (2e-5)."""
    cfg = ExperimentConfig(**TEMPORAL)
    ds = make_synthetic_dataset(n_frames=7, H=16, W=16, dim_expr=8,
                                with_torso=True)
    st = init_params(cfg, ds.size, torch.Generator().manual_seed(0))
    torso = init_torso_params(cfg, torch.Generator().manual_seed(1))
    run = dict(driving_exprs=ds.exprs, latent_codes=st.latent_codes,
               torso_params=torso)
    kw = dict(temporal=4, s_delta=8, delta_keep_torso=0.5, use_prior=True)
    loop = reenact_mod.reenact(cfg, st.params, ds, ds.auds, **run, **kw)
    times = []
    cyc = reenact_mod.reenact(cfg, st.params, ds, ds.auds, **run, **kw,
                              cycle=True, frame_times=times)
    assert cyc.shape == (7, 16, 16, 3) and len(times) == 7
    np.testing.assert_array_equal(cyc, loop)
    full = reenact_mod.reenact(cfg, st.params, ds, ds.auds[:1], **run)
    kf = reenact_mod.reenact(cfg, st.params, ds, ds.auds[:1], **run,
                             temporal=4, s_delta=8)
    np.testing.assert_allclose(kf, full, atol=2e-5)


def test_composite_serve_and_temporal_eval_reenact_on_cpu(tmp_path):
    """train_head -> train_torso -> serve --torso_ckpt and eval_reenact
    --torso_ckpt --temporal 3 on the CPU: the stats keys, the PNGs, and
    no kernel launched or built."""
    cfg = ExperimentConfig(dim_aud=32, dim_expr=8, dim_latent=4,
                           dim_aud_body=16, netdepth=4, netwidth=64)
    ds = make_synthetic_dataset(n_frames=2, H=12, W=12, dim_expr=8)
    HeadTrainer(cfg, ds, seed=0, ckpt_dir=str(tmp_path / "head")).save()
    res = train_torso.main(_cli_run(tmp_path, "--head_ckpt",
                                    str(tmp_path / "head"), "--steps", "2"))
    ckpts = ["--head_ckpt", str(tmp_path / "head"), "--torso_ckpt",
             res["ckpt_dir"]]
    fr.reset_launch_counts()
    kbuild.load_library.cache_clear()
    stats = serve.main([
        "--device", "cpu", "--synthetic", "3", "--synthetic_hw", "16",
        *CLI_SMALL, "--refresh", "2", "--s_delta", "6", *ckpts,
        "--save_path", str(tmp_path / "serve")])
    assert set(stats) == {
        "frames", "roll_k", "warmup_s", "p50_ms", "p95_ms", "p99_ms",
        "deadline_40ms_hit_rate", "steady_fps", "keyframes", "keyframe_ms",
        "delta_frames", "delta_p50_ms", "delta_p95_ms", "finite"}
    assert stats["frames"] == 3 and stats["finite"] is True
    assert stats["keyframes"] == 2 and stats["delta_frames"] == 1
    assert sorted(os.listdir(tmp_path / "serve")) == [
        "exp_stream.avi", "exp_stream_00000.jpg"]
    assert read_avi_frames(str(tmp_path / "serve" / "exp_stream.avi"))[
        0].shape == (3, 16, 16, 3)
    stats = serve.main([
        "--device", "cpu", "--synthetic", "3", "--synthetic_hw", "16",
        *CLI_SMALL, "--s_delta", "6", *ckpts, "--roll_k_torso", "2",
        "--no_smooth"])
    assert stats["frames"] == 3 and stats["finite"] is True

    save = tmp_path / "frames"
    out = eval_reenact.main(_cli_run(tmp_path, *ckpts, "--temporal", "3",
                                     "--s_delta", "6", "--prior", "1",
                                     "--save_path", str(save)))
    assert out["frames"] == 2 and out["video"].shape == (2, 12, 12, 3)
    assert math.isfinite(out["psnr"]) and math.isfinite(out["frame_ms"])
    assert sorted(os.listdir(save)) == ["exp.avi", "exp_00000.jpg"]
    video, _ = read_avi_frames(str(save / "exp.avi"))
    assert np.abs(video / 255.0 - out["video"]).mean() < 6 / 255
    per_frame = eval_reenact.main(_cli_run(tmp_path, *ckpts, "--temporal",
                                           "3", "--s_delta", "6", "--prior",
                                           "1", "--cycle", "0"))
    np.testing.assert_array_equal(per_frame["video"], out["video"])
    out = eval_reenact.main(_cli_run(tmp_path, *ckpts, "--temporal", "2",
                                     "--s_delta", "6", "--roll_k_torso", "2",
                                     "--freeze_z_torso", "1"))
    assert out["frames"] == 2 and np.isfinite(out["video"]).all()
    assert all(v == 0 for v in fr.launch_counts.values())
    assert kbuild.load_library.cache_info().currsize == 0


# ------------------------------------------- C1: the nets the kernels take

def test_kernels_cover_nets_up_to_the_chains_width_and_depth_16():
    base = ExperimentConfig()
    cover = fr.kernels_cover
    for kw in (dict(), dict(netwidth=128), dict(netwidth=64, netdepth=4),
               dict(netdepth=16)):
        assert cover(ExperimentConfig(**kw).face_nerf_config()), kw
    for kw in (dict(netwidth=512), dict(netdepth=17),
               dict(use_viewdirs=False), dict(multires=11)):
        assert not cover(ExperimentConfig(**kw).face_nerf_config()), kw
    # the torso net shares the head's width and depth
    assert cover(torso_nerf_config(ExperimentConfig(netwidth=128)))
    assert not cover(torso_nerf_config(ExperimentConfig(netwidth=512)))
    for w in (256, 128):
        assert train_use_pallas(ExperimentConfig(netwidth=w),
                                "cuda") == "train_bf16"
    assert train_use_pallas(ExperimentConfig(netwidth=128, train_fused=1),
                            "cuda") == "train"
    assert train_use_pallas(ExperimentConfig(netwidth=128), "cpu") is False
    with pytest.raises(ValueError, match="B10"):
        train_use_pallas(ExperimentConfig(netwidth=512), "cuda")
    assert train_use_pallas(ExperimentConfig(netwidth=512, train_fused=0),
                            "cuda") is False
    assert train_use_pallas(base, "cpu") is False


def _packed(width, depth, dtype=torch.bfloat16, seed=0):
    cfg = ExperimentConfig(**{**SMALL, "netwidth": width, "netdepth": depth})
    ncfg = cfg.face_nerf_config()
    model = init_params(cfg, 1, torch.Generator().manual_seed(seed)
                        ).params["coarse"]
    rng = np.random.default_rng(seed)
    cond = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for n in (32, 8, 4)]
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, *cond)
        leaves = fr.model_leaves(model, folded, ncfg)
    return fr.pack_leaves(ncfg, leaves, dtype)


def _points(n=300, seed=1):
    rng = np.random.default_rng(seed)
    pts, dirs, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for s in ((n, 3), (n, 3), (n, 4)))
    return pts, dirs, g


@pytest.mark.parametrize("width,depth", [(128, 4), (64, 6)])
def test_widen_pads_to_the_chains_widths_and_keeps_the_function(width,
                                                                depth):
    """The wrappers run a narrower net zero-padded to W=256 (view branch
    128): the padded units stay 0 and the raw outputs are the narrow
    net's, in f64 sums to 1e-12."""
    from idealnerf_tpu_torch.kernels.fused_mlp import encode_points

    net = _packed(width, depth)
    wide = fr.widen(net)
    assert (wide.width, wide.wv[0].shape[1]) == (256, 128)
    assert sorted(wide.wskip) == sorted(net.wskip)
    fr._check_rays("fused_render_rays", wide)
    pts, dirs, _ = _points()

    def raw(n):
        pe, ped = (x.double() for x in encode_points(n, pts, dirs))
        return fr._mlp_reference(n, pe, ped @ n.wv0d.double()
                                 + n.bv[0].double())

    np.testing.assert_allclose(raw(wide).numpy(), raw(net).numpy(),
                               rtol=0, atol=1e-12)
    paper = _packed(256, 8)
    assert fr.widen(paper) is paper


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,depth", [(128, 4), (64, 6)])
def test_narrowed_gradients_of_the_widened_net_are_the_nets(width, depth,
                                                            dtype):
    """point_mlp_grad's route for a narrower net: the backward of the
    widened net, cut back by ``narrow``, gives every gradient of the
    narrow net (the two passes' plain versions, f64 sums, to 1e-10)."""
    from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg

    net = _packed(width, depth, dtype)
    pts, dirs, g = _points()

    def grads(n):
        return fmg.grad_pass_b_reference(n, fmg.grad_pass_a_reference(
            n, pts, dirs, g, acc=torch.float64))

    got, want = fr.narrow(grads(fr.widen(net)), net), grads(net)
    pairs = (list(zip(got.w, want.w)) + list(zip(got.b, want.b))
             + list(zip(got.wv, want.wv)) + list(zip(got.bv, want.bv))
             + [(got.wskip[i], want.wskip[i]) for i in want.wskip]
             + [(got.wv0d, want.wv0d), (got.w_alpha, want.w_alpha),
                (got.w_rgb, want.w_rgb), (got.b_heads, want.b_heads)])
    for a, b in pairs:
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


def test_wrappers_refuse_a_net_wider_than_the_chain():
    with pytest.raises(ValueError, match="B10"):
        fr.widen(_packed(512, 4))
    # unwidened, a narrow net is refused by the kernels' checks
    with pytest.raises(ValueError, match="kernel width is 256"):
        fr._check_rays("fused_render_rays", _packed(128, 4))
