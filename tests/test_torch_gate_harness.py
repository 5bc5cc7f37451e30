"""The port's quality-gate harness and the gated operating points on the
CPU: ``scripts.rehearsal`` makes and trains a 16x16 subject (a narrow
net, a few steps), ``scripts.sample_sweep`` sweeps its val split and
``scripts.temporal_delta`` measures its temporal modes; the evidence must
read the same through the JAX package's picker and the port's, its PSNR
rows must be the PSNR of the port's own ``reenact`` frames, and ``serve``
/ ``eval_reenact --auto_temporal`` must run at the point the evidence
gates, or refuse with exit code 2 where no point holds the gate. The
arguments each CLI derives from an operating point are held against the
JAX CLIs' mapping."""

import argparse
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from idealnerf_tpu.eval import operating_points as jop
from idealnerf_tpu_torch.cli import common as cli_common
from idealnerf_tpu_torch.cli import eval_reenact, serve
from idealnerf_tpu_torch.cli.common import load_head, load_torso
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
from idealnerf_tpu_torch.eval import operating_points as op
from idealnerf_tpu_torch.eval.reenact import reenact
from idealnerf_tpu_torch.eval.renderer import cached_depth_band
from idealnerf_tpu_torch.scripts import rehearsal, sample_sweep
from idealnerf_tpu_torch.scripts import temporal_delta
from idealnerf_tpu_torch.utils.summary import SummaryWriter

REFRESH, S_DELTA, FRAMES = 2, (6, 4), 4
RUNGS = "64+8,8+8,4+4"
TOP = {"frames", "split", "subject_dir", "refresh", "keyframe_rung",
       "head_ckpt", "head_step", "torso_ckpt", "tightened_bounds",
       "psnr_full_vs_gt", "fps_full_warm", "modes", "fps_head_full_warm",
       "psnr_head_full_vs_gt"}
COMP_ROW = {"psnr_temporal_vs_full", "psnr_temporal_vs_gt",
            "delta_psnr_vs_gt", "fps_temporal_warm", "fps_delta_frames",
            "keyframe_cost_measured"}
# under --tighten: the agreement with a full render in the same bounds
SAME = "psnr_temporal_vs_full_same_bounds"


def _as_the_port_reads(td: dict) -> dict:
    """``td`` with each head row's agreement replaced by the one the
    port's head gate reads (``operating_points.head_agreement``): the JAX
    picker fed this file picks what the port picks from ``td``."""
    modes = {k: (dict(v, psnr_temporal_vs_full=op.head_agreement(v))
                 if k.startswith("head_only_") else v)
             for k, v in td["modes"].items()}
    return dict(td, modes=modes)


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """A trained 16x16 subject with its sweep and temporal evidence."""
    root = tmp_path_factory.mktemp("gate")
    subject = str(root / "subject")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        # the metrics stream without TensorBoard, whose import is slow
        mp.setattr(cli_common, "SummaryWriter",
                   functools.partial(SummaryWriter, use_tensorboard=False))
        try:
            reh = rehearsal.main(["--out", subject, "--smoke", "--with_torso",
                                  "--train_fraction", "0.5", "--device",
                                  "cpu", "--phase", "all", "--eval_modes",
                                  "full,masked_40"])
            sweep = sample_sweep.main(["--out", subject, "--rungs", RUNGS,
                                       "--device", "cpu"])
            td = temporal_delta.main([
                "--subject_dir", subject, "--frames", str(FRAMES),
                "--refresh", str(REFRESH), "--s_delta",
                *map(str, S_DELTA), "--tighten", "--auto_rung",
                "--device", "cpu"])
        finally:
            torch.set_num_threads(threads)
    return dict(root=root, subject=subject, reh=reh, sweep=sweep, td=td)


def test_rehearsal_writes_a_trained_subject(measured):
    reh, subject = measured["reh"], measured["subject"]
    cfg = ExperimentConfig.from_file(os.path.join(subject,
                                                  "HeadNeRF_config.txt"))
    assert (cfg.netwidth, cfg.dim_aud, cfg.N_samples) == (64, 32, 8)
    assert reh["train"]["head"]["step"] == 12      # 3 epochs of 4 frames
    assert reh["train"]["torso"]["step"] == 12
    assert os.listdir(reh["train"]["torso"]["ckpt_dir"])
    # head_imgs: the subject without its torso; com_imgs: with it
    head = load_transforms_dataset(subject, "train", gt_dirs="head_imgs")
    com = load_transforms_dataset(subject, "train", gt_dirs="com_imgs")
    assert head.size == com.size == 4
    assert not np.array_equal(head.images, com.images)
    ev = reh["eval"]
    assert {"full", "masked_40", "delta_psnr_masked_40"} <= set(ev)
    with open(os.path.join(subject, "results.json")) as fh:
        assert json.load(fh) == ev
    assert op.pick_masked_point(ev) == jop.pick_masked_point(ev)


def test_sample_sweep_feeds_the_rung_picker(measured):
    sweep, td = measured["sweep"], measured["td"]
    assert list(sweep) == RUNGS.split(",")
    for v in sweep.values():
        assert {"psnr", "ssim", "wall_s", "frame_ms",
                "delta_psnr_vs_64+8"} <= set(v)
        assert np.isfinite(v["psnr"])
    assert sweep["64+8"]["delta_psnr_vs_64+8"] == 0.0
    best = op.pick_quality_matched_rung(sweep)
    assert best == jop.pick_quality_matched_rung(sweep)
    assert td["keyframe_rung"] == (f"{best[0]}+{best[1]}" if best
                                   else "8+8")


def test_harness_evidence_reads_the_same_through_both_pickers(measured):
    td = measured["td"]
    assert TOP <= set(td) and td["refresh"] == REFRESH
    assert td["frames"] == FRAMES and td["tightened_bounds"] is not None
    comp = [f"s_delta_{s}" for s in S_DELTA]
    head = [f"head_only_s_delta_{s}" for s in S_DELTA]
    assert list(td["modes"]) == comp + head
    for k in comp + head:
        assert set(td["modes"][k]) == COMP_ROW | {SAME}
    with open(os.path.join(measured["subject"], "temporal_delta.json")) as fh:
        assert json.load(fh) == td
    want = jop.pick_temporal_points(_as_the_port_reads(td), REFRESH)
    # every key parses under both pickers
    assert len(want["composite_delta_db_vs_gt"]) == len(comp)
    assert len(want["head_agreement_db_vs_full"]) == len(head)
    got = op.pick_temporal_points(td, REFRESH, fixed=5.6, dil=1.0)
    assert got == want
    for kind in ("comp", "head"):
        fit = td["delta_cost_fit"][kind]
        if fit is not None:
            assert fit["s_delta"] == sorted(S_DELTA)
            assert fit["ms_per_sample"] > 0 and fit["fixed"] >= 0
            assert op.cost_constants(td, kind) == (fit["fixed"], fit["dil"])
    assert td["dilation_ms"] > 0 and td["device"] == "cpu"


def _psnr_rows(measured):
    """The harness's PSNR rows recomputed from the port's reenact."""
    td, subject = measured["td"], measured["subject"]
    cfg = ExperimentConfig.from_file(os.path.join(subject,
                                                  "HeadNeRF_config.txt"))
    ds = load_transforms_dataset(subject, "val", gt_dirs="com_imgs")
    ds_h = load_transforms_dataset(subject, "val", gt_dirs="head_imgs")
    state = load_head(argparse.Namespace(seed=0, head_ckpt=td["head_ckpt"]),
                      cfg, ds.size)
    torso = load_torso(td["torso_ckpt"], cfg, "cpu")
    bounds = {f: tuple(b) for f, b in td["tightened_bounds"].items()}
    s_kf, imp_kf = map(int, td["keyframe_rung"].split("+"))
    cfg_kf = dataclasses.replace(cfg, N_samples=s_kf, N_importance=imp_kf)
    n = FRAMES
    common = dict(driving_auds=ds.auds[ds.aud_ids[:n]],
                  driving_exprs=ds.exprs[:n], latent_codes=state.latent_codes,
                  max_frames=n, smooth_audio=False)
    gt = ds.images[:n].astype(np.float32) / 255.0
    gt_h = ds_h.images[:n].astype(np.float32) / 255.0
    full = reenact(cfg, state.params, ds, torso_params=torso, **common)
    s = S_DELTA[0]
    tm = reenact(cfg_kf, state.params, ds, torso_params=torso,
                 temporal=REFRESH, s_delta=s, use_prior=True, bounds=bounds,
                 **common)
    full_h = reenact(cfg, state.params, ds, **common)
    tm_h = reenact(cfg_kf, state.params, ds, temporal=REFRESH, s_delta=s,
                   use_prior=True, bounds=bounds["head"], **common)
    # the full clips within the temporal modes' tightened bands
    same = reenact(cfg, state.params, ds, torso_params=torso, bounds=bounds,
                   fast_keep=1.0, **common)
    same_h = reenact(cfg, state.params, ds, bounds=bounds["head"], **common)
    p = temporal_delta.psnr
    return {"psnr_full_vs_gt": p(full, gt),
            "psnr_head_full_vs_gt": p(full_h, gt_h),
            "psnr_full_same_bounds_vs_gt": p(same, gt),
            "psnr_head_full_same_bounds_vs_gt": p(same_h, gt_h),
            f"s_delta_{s}": {"psnr_temporal_vs_full": p(tm, full),
                             "psnr_temporal_vs_gt": p(tm, gt),
                             SAME: p(tm, same)},
            f"head_only_s_delta_{s}": {"psnr_temporal_vs_full": p(tm_h,
                                                                  full_h),
                                       "psnr_temporal_vs_gt": p(tm_h, gt_h),
                                       SAME: p(tm_h, same_h)}}


def test_harness_psnr_rows_are_psnr_of_the_ports_reenact_frames(measured):
    td = measured["td"]
    # the bands the harness used are the ones cached beside the checkpoints
    assert tuple(td["tightened_bounds"]["head"]) == cached_depth_band(
        td["head_ckpt"], "head", td["head_step"], None)
    want = _psnr_rows(measured)
    for k in ("psnr_full_vs_gt", "psnr_head_full_vs_gt",
              "psnr_full_same_bounds_vs_gt",
              "psnr_head_full_same_bounds_vs_gt"):
        assert td[k] == pytest.approx(want[k], abs=1e-6)
    for key in (f"s_delta_{S_DELTA[0]}", f"head_only_s_delta_{S_DELTA[0]}"):
        for k, v in want[key].items():
            assert td["modes"][key][k] == pytest.approx(v, abs=1e-6), (key, k)
    row = td["modes"][f"s_delta_{S_DELTA[0]}"]
    assert row["delta_psnr_vs_gt"] == round(
        td["psnr_full_vs_gt"] - row["psnr_temporal_vs_gt"], 3)


def test_temporal_fps_needs_a_keyframe_after_frame_0():
    assert temporal_delta.temporal_fps([1.0, 0.1, 0.1], 5) == (
        None, 10.0, False)
    fps, delta, key = temporal_delta.temporal_fps([1.0, 0.1, 0.5, 0.1], 2)
    assert key and delta == 10.0 and fps == round(1.0 / 0.3, 3)


def _cli_base(measured, torso: bool):
    td, subject = measured["td"], measured["subject"]
    argv = ["--device", "cpu", "--config",
            os.path.join(subject, "HeadNeRF_config.txt"), "--head_ckpt",
            td["head_ckpt"], "--max_frames", "3"]
    return argv + (["--torso_ckpt", td["torso_ckpt"]] if torso else [])


class _Spy:
    """Records the keyword arguments of each call and passes it on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **kw):
        self.calls.append(kw)
        return self.fn(*a, **kw)


@pytest.mark.parametrize("torso", [False, True], ids=["head", "comp"])
def test_cli_auto_temporal_on_the_harness_evidence(measured, torso,
                                                   monkeypatch, capsys):
    """Both CLIs run at the point gated_video_config picks from the
    harness's evidence, or refuse (exit code 2) where it picks none."""
    mode = "comp" if torso else "head"
    evidence = measured["subject"]
    conf = op.gated_video_config(evidence, mode)
    base = _cli_base(measured, torso) + ["--auto_temporal", evidence]
    spy = _Spy(serve.TemporalStream)
    monkeypatch.setattr(serve, "TemporalStream", spy)
    rspy = _Spy(eval_reenact.reenact)
    monkeypatch.setattr(eval_reenact, "reenact", rspy)
    if conf is None:
        for main in (serve.main, eval_reenact.main):
            with pytest.raises(SystemExit) as e:
                main(base)
            assert e.value.code == 2
            assert "temporal_delta" in capsys.readouterr().err
        return
    stats = serve.main(base)
    assert spy.calls[0]["operating_point"] == conf
    assert stats["keyframes"] == -(-3 // conf["refresh"])
    res = eval_reenact.main(base)
    kw = rspy.calls[0]
    assert res["frames"] == 3
    assert (kw["temporal"], kw["s_delta"], kw["delta_keep"],
            kw["use_prior"]) == (conf["refresh"], conf["s_delta"],
                                 conf["delta_keep"], True)


def _handmade(path, gate_db: float, agreement_db: float):
    """One evidence file whose points hold (or fail) both gates."""
    os.makedirs(path, exist_ok=True)
    td = {"refresh": 3, "keyframe_rung": "8+8", "fps_full_warm": 2.0,
          "fps_head_full_warm": 4.0, "modes": {
              "s_delta_6": {"delta_psnr_vs_gt": gate_db,
                            "fps_delta_frames": 8.0},
              "s_delta_4_k60": {"delta_psnr_vs_gt": gate_db,
                                "fps_delta_frames": 9.0},
              "head_only_s_delta_6": {"psnr_temporal_vs_full": agreement_db,
                                      "delta_psnr_vs_gt": gate_db,
                                      "fps_delta_frames": 12.0}}}
    with open(os.path.join(path, "temporal_delta.json"), "w") as fh:
        json.dump(td, fh)
    return str(path)


@pytest.mark.parametrize("torso", [False, True], ids=["head", "comp"])
def test_cli_auto_temporal_runs_at_an_open_gate(measured, torso,
                                                monkeypatch):
    """On evidence whose gates hold, serve hands the point to the stream
    (refresh 3, the 8+8 keyframe rung) and eval_reenact renders at it."""
    evidence = _handmade(measured["root"] / "open", 0.01, 45.0)
    mode = "comp" if torso else "head"
    conf = op.gated_video_config(evidence, mode)
    assert conf["refresh"] == 3 and conf["keyframe_rung"] == "8+8"
    base = _cli_base(measured, torso) + ["--auto_temporal", evidence]
    spy = _Spy(serve.TemporalStream)
    monkeypatch.setattr(serve, "TemporalStream", spy)
    stats = serve.main(base)
    assert spy.calls[0]["operating_point"] == conf
    assert stats["keyframes"] == 1 and stats["delta_frames"] == 2
    rspy = _Spy(eval_reenact.reenact)
    monkeypatch.setattr(eval_reenact, "reenact", rspy)
    eval_reenact.main(base)
    kw = rspy.calls[0]
    assert (kw["temporal"], kw["s_delta"], kw["delta_keep"]) == (
        3, conf["s_delta"], conf["delta_keep"])
    assert conf["s_delta"] == (4 if torso else 6)


@pytest.mark.parametrize("entry", ["serve", "eval_reenact"])
@pytest.mark.parametrize("torso", [False, True], ids=["head", "comp"])
def test_cli_auto_temporal_refuses_a_closed_gate(measured, torso, entry,
                                                 capsys):
    closed = _handmade(measured["root"] / "closed", 0.2, 30.0)
    main = {"serve": serve.main, "eval_reenact": eval_reenact.main}[entry]
    with pytest.raises(SystemExit) as e:
        main(_cli_base(measured, torso) + ["--auto_temporal", closed])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--auto_temporal" in err and ("comp" if torso else "head") in err
    assert "idealnerf_tpu_torch.scripts.temporal_delta" in err
    # a rolling cadence without evidence of its own is refused too
    if entry == "serve":
        open_dir = _handmade(measured["root"] / "open_roll", 0.01, 45.0)
        with pytest.raises(SystemExit) as e:
            serve.main(_cli_base(measured, torso)
                       + ["--auto_temporal", open_dir, "--roll_k", "4"])
        assert e.value.code == 2
        assert "roll_k=4" in capsys.readouterr().err


CONFS = {
    "head-rung": dict(refresh=50, s_delta=16, s_delta_torso=None,
                      delta_keep=0.6, delta_keep_torso=None,
                      freeze_z_torso=False, roll_k_torso=0, roll_k=0,
                      uni_frac=0.5, kf_blend=0.3, dilate_every=2,
                      head_parse=True, keyframe_rung="32+64",
                      quality_ok=True),
    "comp-fz": dict(refresh=25, s_delta=12, s_delta_torso=24,
                    delta_keep=1.0, delta_keep_torso=0.01,
                    freeze_z_torso=True, roll_k_torso=0, roll_k=0,
                    uni_frac=0.25, kf_blend=0.0, dilate_every=1,
                    head_parse=False, keyframe_rung=None, quality_ok=True),
    "comp-rt": dict(refresh=25, s_delta=16, s_delta_torso=None,
                    delta_keep=0.8, delta_keep_torso=None,
                    freeze_z_torso=False, roll_k_torso=10, roll_k=0,
                    uni_frac=0.25, kf_blend=0.0, dilate_every=3,
                    head_parse=False, keyframe_rung="16+32",
                    quality_ok=True),
}
DERIVED = ("temporal", "s_delta", "s_delta_torso", "delta_keep",
           "delta_keep_torso", "freeze_z_torso", "uni_frac", "kf_blend",
           "dilate_every", "roll_k_torso", "head_parse", "prior",
           "N_samples", "N_importance")


class _Stop(Exception):
    pass


def _capture(store):
    def stop(*a, **kw):
        store.append((a, kw))
        raise _Stop
    return stop


@pytest.mark.parametrize("name", list(CONFS))
def test_eval_reenact_maps_a_config_as_the_jax_cli(name, monkeypatch):
    """The flags eval_reenact derives from an operating point are the JAX
    CLI's (idealnerf_tpu/cli/eval_reenact.py, --auto_temporal)."""
    from idealnerf_tpu.cli import eval_reenact as jax_cli

    conf = CONFS[name]
    argv = ["--synthetic", "2", "--auto_temporal", "ev", "--head_ckpt", "h"]
    if name.startswith("comp"):
        argv += ["--torso_ckpt", "t"]
    seen = {}
    for pkg, cli, opmod in (("jax", jax_cli, jop), ("port", eval_reenact,
                                                     eval_reenact)):
        calls, got = [], []
        monkeypatch.setattr(opmod, "gated_video_config",
                            lambda d, mode, *a, **kw: (calls.append(mode),
                                                       dict(conf))[1])
        monkeypatch.setattr(cli, "resolve_config", _capture(got))
        with pytest.raises(_Stop):
            cli.main(argv + (["--device", "cpu"] if pkg == "port" else []))
        assert calls == ["comp" if name.startswith("comp") else "head"]
        args = got[0][0][0]
        seen[pkg] = {k: getattr(args, k) for k in DERIVED}
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("name", list(CONFS))
def test_serve_hands_a_config_to_the_stream_as_the_jax_cli(name,
                                                           monkeypatch):
    """serve --auto_temporal gives TemporalStream the operating point and
    the keyframe rung's N_samples/N_importance, as the JAX CLI does."""
    import idealnerf_tpu.ckpt as jax_ckpt
    import idealnerf_tpu.eval.stream as jax_stream
    from idealnerf_tpu.cli import serve as jax_serve

    class _NoCheckpoint:
        """The JAX CLI's torso restore, answered with the fresh nets."""

        def __init__(self, directory):
            pass

        def restore_partial(self, like):
            return like, []

    conf = CONFS[name]
    argv = ["--synthetic", "2", "--synthetic_hw", "8", "--dim_aud", "32",
            "--dim_expr", "8", "--dim_latent", "4", "--netdepth", "2",
            "--netwidth", "32", "--auto_temporal", "ev"]
    if name.startswith("comp"):
        argv += ["--torso_ckpt", "t"]
    seen = {}
    for pkg, opmod, target in (
            ("jax", jop, (jax_stream, "TemporalStream")),
            ("port", serve, (serve, "TemporalStream"))):
        got, modes = [], []
        monkeypatch.setattr(opmod, "gated_video_config",
                            lambda d, mode, roll_k=0, **kw: (
                                modes.append((mode, roll_k)), dict(conf))[1])
        monkeypatch.setattr(*target, _capture(got))
        if pkg == "port":
            monkeypatch.setattr(serve, "load_torso", lambda *a: None)
        else:
            monkeypatch.setattr(jax_ckpt, "CheckpointManager", _NoCheckpoint)
        main = jax_serve.main if pkg == "jax" else serve.main
        with pytest.raises(_Stop):
            main(argv + (["--device", "cpu"] if pkg == "port" else []))
        assert modes == [("comp" if name.startswith("comp") else "head", 0)]
        (cfg, *_), kw = got[0]
        seen[pkg] = (kw["operating_point"], cfg.N_samples, cfg.N_importance)
    assert seen["port"] == seen["jax"]


def test_harness_without_tighten_writes_no_same_bounds_rows(measured,
                                                            tmp_path):
    """C3: without --tighten the full and temporal clips share the
    config's bounds and the evidence keeps the JAX script's fields."""
    out = str(tmp_path / "temporal_delta_plain.json")
    td = temporal_delta.main([
        "--subject_dir", measured["subject"], "--frames", "3", "--refresh",
        str(REFRESH), "--s_delta", str(S_DELTA[0]), "--device", "cpu",
        "--out", out])
    assert td["tightened_bounds"] is None
    assert not any(k.startswith("psnr_full_same") or
                   k.startswith("psnr_head_full_same") for k in td)
    for v in td["modes"].values():
        assert set(v) == COMP_ROW


def test_keep_one_composite_is_the_full_composite_in_its_band(measured):
    """C3's composite reference: ``reenact`` at ``fast_keep=1.0`` with no
    prior and one band for both fields renders, bitwise, the full
    composite of a subject whose near and far are that band."""
    td, subject = measured["td"], measured["subject"]
    cfg = ExperimentConfig.from_file(os.path.join(subject,
                                                  "HeadNeRF_config.txt"))
    ds = load_transforms_dataset(subject, "val", gt_dirs="com_imgs")
    band = (ds.near + 0.25, ds.far - 0.5)
    ds_band = load_transforms_dataset(subject, "val", near=band[0],
                                      far=band[1], gt_dirs="com_imgs")
    state = load_head(argparse.Namespace(seed=0, head_ckpt=td["head_ckpt"]),
                      cfg, ds.size)
    common = dict(driving_auds=ds.auds[ds.aud_ids[:2]],
                  driving_exprs=ds.exprs[:2], latent_codes=state.latent_codes,
                  torso_params=load_torso(td["torso_ckpt"], cfg, "cpu"),
                  max_frames=2, smooth_audio=False)
    full = reenact(cfg, state.params, ds_band, **common)
    keep1 = reenact(cfg, state.params, ds, fast_keep=1.0,
                    bounds={"head": band, "torso": band}, **common)
    np.testing.assert_array_equal(keep1, full)
    assert not np.array_equal(full, reenact(cfg, state.params, ds, **common))
