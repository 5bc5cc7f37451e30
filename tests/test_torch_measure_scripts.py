"""The port's measurement scripts on the CPU at their ``--smoke`` sizes:
``train_profile``, ``stream_latency``, ``temporal_profile``,
``comp_profile``, ``composite_delta`` and ``audatt_peak``. Each writes its
JSON with the JAX script's keys, less the keys documented as dropped
(and, where one is renamed, under its new name). Beyond the keys:
``train_profile``'s full and fixed-coordinate steps give the same loss on
the same coordinates; the profiles' stage chains reproduce their
renderer's frame bitwise; ``stream_latency`` serves the gated point and
refuses without one as the JAX script does; ``composite_delta``'s full
clip is the port's composite reenactment of the same inputs, bitwise;
``audatt_peak``'s attention equals the JAX AudioAttNet's on bridged
weights (1e-6)."""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.models.audio_net import apply_audio_net
from idealnerf_tpu.models.nn import conv1d, dense, leaky_relu
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.cli import common as cli_common
from idealnerf_tpu_torch.cli.common import load_head, load_torso
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
from idealnerf_tpu_torch.eval import operating_points as op
from idealnerf_tpu_torch.eval.reenact import reenact
from idealnerf_tpu_torch.scripts import (
    audatt_peak, comp_profile, composite_delta, rehearsal, stream_latency,
    temporal_profile, train_profile,
)
from idealnerf_tpu_torch.utils.summary import SummaryWriter

# the JAX scripts' output keys, and those the port drops (documented in
# each script's docstring)
TRAIN_KEYS = {"full", "fixed_coords", "sgd", "grad_only", "flat_adam",
              "approx_sampler", "flat_adam_approx", "sampler_ms",
              "adam_vs_sgd_ms", "optimizer_ms", "flat_adam_saves_ms",
              "approx_sampler_saves_ms", "combined_saves_ms", "backend"}
TRAIN_DROPPED = {"flat_adam", "approx_sampler", "flat_adam_approx",
                 "flat_adam_saves_ms", "approx_sampler_saves_ms",
                 "combined_saves_ms"}
STREAM_KEYS = {"mode", "roll_k", "quality_vs_full", "frames",
               "operating_point", "lookahead_frames", "warmup_s",
               "tunnel_rtt_floor_ms", "compute_isolation", "p50_ms",
               "p95_ms", "p99_ms", "max_ms", "keyframe_p50_ms",
               "delta_p50_ms", "deadline_40ms_hit_rate", "steady_fps",
               "first_cycle_ms"}
STREAM_RENAMED = {"tunnel_rtt_floor_ms": "local_launch_floor_ms"}
ISOLATION_KEYS = {"method", "window_walls_ms", "rtt_intercept_ms",
                  "compute_ms_per_frame", "compute_ms_p50",
                  "compute_ms_p95", "deadline_40ms_compute_ok"}
ISOLATION_RENAMED = {"rtt_intercept_ms": "launch_intercept_ms"}
TEMPORAL_KEYS = {"hw", "rung", "s_delta", "delta_keep", "reps", "backend",
                 "stages_ms", "end_to_end_ms", "sum_stages_ms", "glue_ms",
                 "fps", "end_to_end_ms_s2", "s_delta2", "ms_per_sample",
                 "fixed_ms", "end_to_end_ms_xla_delta",
                 "kernel_delta_saving_ms", "end_to_end_ms_nodilate",
                 "dilation_ms", "cycle_ms_per_frame", "cycle_T",
                 "cycle_fps", "cycle_ms_per_frame_s2"}
TEMPORAL_DROPPED = {"end_to_end_ms_xla_delta", "kernel_delta_saving_ms"}
COMP_KEYS = {"hw", "rung", "reps", "backend", "stages_ms", "end_to_end_ms",
             "sum_stages_ms", "glue_ms", "fps"}
COMP_STAGES = {"coarse_head", "coarse_torso", "keep", "fine_head",
               "fine_torso", "composite"}
DELTA_KEYS = {"frames", "keep", "tightened_bounds", "fast_schedule",
              "psnr_fast_vs_full", "psnr_full_vs_gt", "psnr_fast_vs_gt",
              "delta_psnr_vs_gt", "s_per_frame_full_incl_compile",
              "s_per_frame_fast_incl_compile", "fps_full_warm",
              "fps_fast_warm"}
AUDATT_KEYS = {"ckpt", "step", "smo_size", "center_index",
               "mean_attention_by_position", "argmax_at_center_fraction",
               "mean_center_weight", "uniform_weight", "frames"}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The smoke runs are many small ops: beside other test processes a
    large intra-op thread pool makes them slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _read(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite(v) for v in tree)
    if isinstance(tree, float):
        return np.isfinite(tree)
    return True


def _open_evidence(subject: str, refresh: int = 3) -> None:
    """An evidence file whose composite and head points hold the gate."""
    td = {"refresh": refresh, "keyframe_rung": "8+8", "fps_full_warm": 2.0,
          "fps_head_full_warm": 4.0, "modes": {
              "s_delta_6": {"delta_psnr_vs_gt": 0.01,
                            "fps_delta_frames": 8.0},
              "head_only_s_delta_6": {"psnr_temporal_vs_full": 45.0,
                                      "delta_psnr_vs_gt": 0.01,
                                      "fps_delta_frames": 12.0}}}
    with open(os.path.join(subject, "temporal_delta.json"), "w") as fh:
        json.dump(td, fh)


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    """A trained 16x16 with-torso subject (scripts.rehearsal --smoke) with
    an open-gate evidence file."""
    root = tmp_path_factory.mktemp("measure")
    out = str(root / "subject")
    with pytest.MonkeyPatch.context() as mp:
        # the metrics stream without TensorBoard, whose import is slow
        mp.setattr(cli_common, "SummaryWriter",
                   functools.partial(SummaryWriter, use_tensorboard=False))
        reh = rehearsal.main(["--out", out, "--smoke", "--with_torso",
                              "--train_fraction", "0.5", "--device", "cpu",
                              "--phase", "all", "--eval_modes", "full"])
    _open_evidence(out)
    cfg = ExperimentConfig.from_file(os.path.join(out, "HeadNeRF_config.txt"))
    return dict(root=root, dir=out, cfg=cfg,
                head_ckpt=reh["train"]["head"]["ckpt_dir"],
                torso_ckpt=reh["train"]["torso"]["ckpt_dir"])


def test_train_profile_smoke_writes_the_jax_keys(tmp_path):
    path = str(tmp_path / "train_profile.json")
    res = train_profile.main(["--device", "cpu", "--smoke", "--out", path])
    assert _read(path) == json.loads(json.dumps(res))
    assert TRAIN_KEYS - TRAIN_DROPPED <= set(res)
    assert not TRAIN_DROPPED & set(res)
    for name in train_profile.VARIANTS:
        v = res[name]
        assert v["ms_per_step"] > 0 and v["steps"] == 5
        assert v["steps_per_sec"] == pytest.approx(1e3 / v["ms_per_step"])
    full = res["full"]["ms_per_step"]
    assert res["sampler_ms"] == full - res["fixed_coords"]["ms_per_step"]
    assert res["optimizer_ms"] == full - res["grad_only"]["ms_per_step"]
    assert res["backend"] == "cpu" and _finite(res)
    # the idle share's wall is an unprofiled window beside the profiled one
    prof = res["profile"]
    assert prof["wall_ms"] > 0 and prof["profiled_wall_ms"] > 0
    assert prof["idle_share"] is None and prof["device_busy_ms"] is None


def test_train_profile_full_and_fixed_steps_agree_on_the_same_coords():
    """The fixed-coordinate step at the coordinates the full step samples
    (from the same generator state) gives the full step's loss bitwise,
    and both move the parameters the same way."""
    cfg = ExperimentConfig(**{**train_profile.PAPER, **train_profile.SMOKE})
    prof = train_profile.Profile(cfg, 48, 3, torch.device("cpu"))
    sa, sb = prof.state("adam"), prof.state("adam")
    loss_a = prof.step_fn("full")(sa, 1, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    coords = prof.sample(1, g)
    loss_b = prof.step_fn("fixed_coords", coords)(sb, 1, g)
    assert torch.equal(loss_a, loss_b)
    for (n, a), b in zip(sa.params.named_parameters(),
                         sb.params.parameters()):
        assert torch.equal(a, b), n
    # the default fixed coordinates are other rays: another loss
    loss_c = prof.step_fn("fixed_coords")(prof.state("adam"), 1,
                                          torch.Generator().manual_seed(5))
    assert not torch.equal(loss_a, loss_c)


@pytest.mark.parametrize("mode", ["comp", "head"])
def test_stream_latency_smoke_serves_the_gated_point(subject, mode,
                                                     tmp_path):
    path = str(tmp_path / "stream_latency.json")
    res = stream_latency.main(["--evidence_dir", subject["dir"], "--mode",
                               mode, "--device", "cpu", "--smoke", "--out",
                               path])
    assert _read(path) == json.loads(json.dumps(res))
    want = {STREAM_RENAMED.get(k, k) for k in STREAM_KEYS}
    assert want <= set(res) and not set(STREAM_RENAMED) & set(res)
    iso = res["compute_isolation"]
    assert {ISOLATION_RENAMED.get(k, k) for k in ISOLATION_KEYS} == set(iso)
    assert set(iso["window_walls_ms"]) == {"1", "2"}   # K < refresh 3
    conf = op.gated_video_config(subject["dir"], mode)
    assert res["operating_point"] == {k: conf[k] for k in
                                      stream_latency.POINT_KEYS}
    assert res["frames"] == res["emitted"] == 8
    assert res["keyframes"] == 3 and res["delta_frames"] == 5
    assert res["lookahead_frames"] == 1   # smo_size 4: 4 - 2 - 1
    assert res["p50_ms"] <= res["p95_ms"] <= res["p99_ms"] <= res["max_ms"]
    assert res["backend"] == "cpu" and _finite(res)


def test_stream_latency_without_an_open_gate_prints_the_error(tmp_path,
                                                              capsys):
    closed = tmp_path / "closed"
    closed.mkdir()
    td = {"refresh": 3, "modes": {"s_delta_6": {"delta_psnr_vs_gt": 0.4}}}
    with open(closed / "temporal_delta.json", "w") as fh:
        json.dump(td, fh)
    rc = stream_latency.main(["--evidence_dir", str(closed), "--device",
                              "cpu", "--smoke"])
    assert rc == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "error": f"no gated comp operating point in {closed}"}


def test_temporal_profile_smoke_and_its_stage_chain(tmp_path):
    path = str(tmp_path / "temporal_profile.json")
    res = temporal_profile.main(["--device", "cpu", "--smoke", "--out",
                                 path])
    assert _read(path) == json.loads(json.dumps(res))
    assert TEMPORAL_KEYS - TEMPORAL_DROPPED <= set(res)
    assert not TEMPORAL_DROPPED & set(res)
    assert set(res["stages_ms"]) == {"head_delta", "torso_delta",
                                     "composite"}
    assert res["stage_chain_max_abs_err"] == 0.0
    assert res["sum_stages_ms"] == pytest.approx(
        sum(res["stages_ms"].values()))
    assert res["fixed_ms"] == pytest.approx(
        res["end_to_end_ms"] - res["ms_per_sample"] * res["s_delta"])
    assert res["hw"] == 32 and res["cycle_T"] == 4 and _finite(res)


def test_comp_profile_smoke_and_its_stage_chain(tmp_path):
    path = str(tmp_path / "comp_profile.json")
    res = comp_profile.main(["--device", "cpu", "--smoke", "--out", path])
    assert _read(path) == json.loads(json.dumps(res))
    assert COMP_KEYS <= set(res) and set(res["stages_ms"]) == COMP_STAGES
    assert res["stage_chain_max_abs_err"] == 0.0
    assert res["glue_ms"] == pytest.approx(res["end_to_end_ms"]
                                           - res["sum_stages_ms"])
    assert _finite(res)


@pytest.mark.parametrize("tighten", [False, True], ids=["bounds", "tight"])
def test_composite_delta_smoke(subject, tighten, tmp_path):
    path = str(tmp_path / "composite_delta.json")
    argv = ["--subject_dir", subject["dir"], "--device", "cpu", "--smoke",
            "--samples", "4", "--importance", "4", "--out", path]
    res = composite_delta.main(argv + (["--tighten"] if tighten else []))
    clips = res.pop("frames_rendered")
    assert _read(path) == json.loads(json.dumps(res))
    assert DELTA_KEYS <= set(res) and _finite(res)
    assert res["fast_schedule"] == "4+4" and res["frames"] == 2
    assert (res["tightened_bounds"] is not None) == tighten
    # the full clip is the port's composite reenactment of the inputs
    cfg = subject["cfg"]
    ds = load_transforms_dataset(cfg.datadir, "val", near=cfg.near,
                                 far=cfg.far, gt_dirs="com_imgs")
    st = load_head(argparse.Namespace(
        seed=0, head_ckpt=subject["head_ckpt"]), cfg, ds.size)
    want = reenact(cfg, st.params, ds, ds.auds[ds.aud_ids[:2]],
                   driving_exprs=ds.exprs[:2], latent_codes=st.latent_codes,
                   torso_params=load_torso(subject["torso_ckpt"], cfg, "cpu"),
                   max_frames=2, smooth_audio=False)
    assert np.array_equal(clips["full"], want)
    assert res["psnr_fast_vs_full"] == pytest.approx(
        composite_delta.psnr(clips["fast"], want))


def _jax_attention(tree, auds, win_size: int, smo: int) -> np.ndarray:
    """The JAX script's attention weights (scripts/audatt_peak.py)."""
    feats = apply_audio_net(tree["aud_net"], jnp.asarray(auds),
                            win_size=win_size)
    half, ap = smo // 2, tree["aud_att"]
    dim_aud = ap["conv"][0]["w"].shape[1]

    def att(i):
        win = jax.lax.dynamic_slice_in_dim(feats, i - half, smo, 0)
        y = jnp.transpose(win[:, :dim_aud])[None]
        for conv in ap["conv"]:
            y = leaky_relu(conv1d(conv, y, stride=1, padding=1))
        return jax.nn.softmax(dense(ap["att"], y.reshape(1, smo)),
                              axis=1).reshape(smo)

    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.vmap(att)(jnp.arange(half,
                                                   feats.shape[0] - half)))


def test_audatt_peak_matches_the_jax_attention(subject, tmp_path):
    path = str(tmp_path / "audatt_peak.json")
    res = audatt_peak.main(["--ckpt", subject["head_ckpt"], "--subject",
                            subject["dir"], "--device", "cpu", "--out", path])
    assert _read(path) == json.loads(json.dumps(res))
    assert AUDATT_KEYS <= set(res) and _finite(res)
    cfg = subject["cfg"]
    st = load_head(argparse.Namespace(
        seed=0, head_ckpt=subject["head_ckpt"]), cfg, 1)
    auds = np.load(os.path.join(subject["dir"], cfg.aud_file))
    got = audatt_peak.attention_weights(st.params, auds, cfg.smo_size, "cpu")
    tree = jax.tree.map(jnp.asarray, bridge.params_to_jax(st.params))
    want = _jax_attention(tree, auds, cfg.win_size, cfg.smo_size)
    assert got.shape == want.shape == (res["frames"], cfg.smo_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["mean_attention_by_position"],
                               want.mean(0), rtol=0, atol=1e-6)
    assert res["center_index"] == cfg.smo_size // 2
    assert res["step"] == st.step > 0
