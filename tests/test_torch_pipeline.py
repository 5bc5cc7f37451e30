"""The port's offline pipeline steps (``idealnerf_tpu_torch.pipeline``
audio and process, ``utils.image_tools`` and ``cli.process_data``)
against the JAX package's, mirroring tests/test_pipeline.py.

Bitwise: the audio chain (MFCC, the DeepSpeech input vector, the
interpolation, the windows, the whole chain with its fallback projection
and its resampling), the parse colour map, the background plate, the
decoupling and the face rect, and every field of the JSON that
``write_transforms`` writes but the pose matrices, which come through a
float32 cos/sin: XLA's and torch's differ in the last bit on about 6 % of
angles, so the matrices are held to 2 ulps of 1.0, 2^-22 absolute, where
both the rotations and these translations lie within [-1, 1]: over
100,000 random poses the two writers' matrices differ by at most 3 and
2.5 units of 2^-24 (ROADMAP.md C6). ``crop_face`` is within one uint8
level of OpenCV's INTER_LINEAR, whose coefficients are fixed point.

The CLI runs end to end on a 64x64 six-frame subject on the CPU, with a
one-stack FAN (.npz) at a 64² crop, BiSeNet (a torch .pth) at a 64²
inference size (both modules' sizes patched, as tests/test_torch_fan.py
patches FAN's) and a DeepSpeech graph at 8 hidden units; each file it
writes is held against the JAX functions on the same inputs, written as
the JAX CLI writes them (imageio, JPEG quality 75), and train_head then
trains a few steps from the directory. The tracker itself is held in
test_torch_tracking.py.
"""

import functools
import json
import os
import struct
import wave

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idealnerf_tpu.pipeline.fan as jfan
import idealnerf_tpu.pipeline.parsing_net as jparse
from idealnerf_tpu.pipeline import audio as jaudio
from idealnerf_tpu.pipeline import process as jproc
from idealnerf_tpu.pipeline.deepspeech import make_logits_fn_from_graph
from idealnerf_tpu.utils import image_tools as jtools
from idealnerf_tpu_torch.pipeline import audio as paudio
from idealnerf_tpu_torch.pipeline import deepspeech as pds
from idealnerf_tpu_torch.pipeline import fan as pfan
from idealnerf_tpu_torch.pipeline import parsing_net as pparse
from idealnerf_tpu_torch.pipeline import process as pproc
from idealnerf_tpu_torch.utils import image_tools as ptools

CROP = 64
POSE_ATOL = 2.0 ** -22   # the pose matrices' bound: 2 float32 ulps of 1.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- audio


def test_audio_chain_is_bitwise_jax():
    rng = np.random.RandomState(0)
    sr = 16000
    audio = rng.randn(2 * sr) * 2000
    _same(paudio.mfcc(audio, sr), jaudio.mfcc(audio, sr))
    _same(paudio.deepspeech_input_vector(audio, sr),
          jaudio.deepspeech_input_vector(audio, sr))
    feats = rng.randn(100, 29)
    _same(paudio.interpolate_features(feats, 50, 25, 48),
          jaudio.interpolate_features(feats, 50, 25, 48))
    _same(paudio.make_audio_windows(feats, win_size=16),
          jaudio.make_audio_windows(feats, win_size=16))
    _same(paudio.extract_deepspeech_features(audio, sr, num_frames=50),
          jaudio.extract_deepspeech_features(audio, sr, num_frames=50))
    # a 22.05 kHz int16 clip: the resample to 16 kHz, the video rate
    # from the audio's length
    clip = (np.sin(np.arange(22050) * 0.05) * 8000).astype(np.int16)
    _same(paudio.extract_deepspeech_features(clip, 22050),
          jaudio.extract_deepspeech_features(clip, 22050))


# ------------------------------------------------------------- process


def _parse_image(rng, h, w):
    """A parse colour image with head, hair, torso and background."""
    cm = rng.randint(0, 19, (h, w))
    return pproc.parse_color_map(cm), cm


def test_process_functions_are_bitwise_jax():
    rng = np.random.RandomState(1)
    cm = rng.randint(0, 19, (20, 24))
    _same(pproc.parse_color_map(cm), jproc.parse_color_map(cm))
    parse, _ = _parse_image(rng, 20, 24)
    _same(pproc.head_mask_from_parse(parse), jproc.head_mask_from_parse(parse))

    # the plate of a head moving over a textured background
    h = w = 40
    bg = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
    imgs, masks = [], []
    for i in range(4):
        img = bg.copy()
        m = np.zeros((h, w), bool)
        m[10:30, 5 + 6 * i: 15 + 6 * i] = True
        img[m] = [200, 50, 50]
        imgs.append(img)
        masks.append(m)
    plate = pproc.extract_background_plate(np.stack(imgs), np.stack(masks))
    _same(plate, jproc.extract_background_plate(np.stack(imgs),
                                                np.stack(masks)))
    parse, _ = _parse_image(rng, h, w)
    for got, want in zip(pproc.decouple_images(imgs[0], parse, plate),
                         jproc.decouple_images(imgs[0], parse, plate)):
        _same(got, want)
    for _ in range(5):
        lms = np.c_[rng.uniform(0, 64, 68), rng.uniform(0, 48, 68)]
        _same(pproc.face_rect_from_landmarks(lms, 48, 64),
              jproc.face_rect_from_landmarks(lms, 48, 64))


def _hold_transforms(got_dir, want_dir, names=("train", "val")):
    """The port's transforms_exp_*.json against the JAX writer's: every
    field bitwise but the pose matrices (``POSE_ATOL``); the config files
    byte for byte where both exist."""
    worst = 0
    for name in names:
        with open(os.path.join(got_dir, f"transforms_exp_{name}.json")) as f:
            got = json.load(f)
        with open(os.path.join(want_dir, f"transforms_exp_{name}.json")) as f:
            want = json.load(f)
        mats = [(fr.pop("transform_matrix"), fw.pop("transform_matrix"))
                for fr, fw in zip(got["frames"], want["frames"])]
        assert got == want
        worst = max([worst] + [float(np.abs(np.subtract(a, b)).max())
                               for a, b in mats])
    assert worst <= POSE_ATOL, worst
    for cfg in ("HeadNeRF_config.txt", "TorsoNeRF_config.txt"):
        if os.path.exists(os.path.join(want_dir, cfg)):
            with open(os.path.join(got_dir, cfg)) as f:
                got = f.read()
            with open(os.path.join(want_dir, cfg)) as f:
                want = f.read()
            assert got == want.replace(want_dir, got_dir)
    return worst


def test_write_transforms_matches_jax(tmp_path):
    n, h, w = 11, 32, 32
    rng = np.random.RandomState(0)
    euler = rng.randn(n, 3).astype(np.float32) * 0.1
    trans = np.tile([0.0, 0.0, -0.9], (n, 1)).astype(np.float32)
    trans[:, :2] += rng.randn(n, 2).astype(np.float32) * 0.05
    exps = rng.randn(n, 6).astype(np.float32)
    lms = {i: np.c_[rng.uniform(8, 24, 68), rng.uniform(8, 24, 68)]
           for i in range(n)}
    for mod, d in ((pproc, tmp_path / "port"), (jproc, tmp_path / "jax")):
        mod.write_transforms(str(d), list(range(n)), euler, trans, exps, lms,
                             focal=60.0, h=h, w=w, subject="tst")
    _hold_transforms(str(tmp_path / "port"), str(tmp_path / "jax"))
    with open(tmp_path / "port" / "transforms_exp_train.json") as fh:
        doc = json.load(fh)
    assert len(doc["frames"]) == 10 and doc["focal_len"] == 60.0
    pose = np.array(doc["frames"][0]["transform_matrix"])
    np.testing.assert_allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3),
                               atol=1e-5)


# ---------------------------------------------------------- image tools


@pytest.mark.parametrize("hw,rect,size", [
    ((100, 80), (10, 20, 50, 60), 256),     # grows
    ((300, 300), (20, 30, 250, 240), 64),   # shrinks, no antialias
    ((57, 93), (0, 0, 93, 57), 128),        # the rect clipped at the frame
])
def test_crop_face_within_one_level_of_cv2(hw, rect, size):
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(size).randint(0, 256, hw + (3,),
                                              dtype=np.uint8)
    got = ptools.crop_face(img, rect, size)
    want = jtools.crop_face(img, rect, size)
    assert got.shape == want.shape == (size, size, 3)
    assert cv2.__version__ and np.abs(got.astype(int) - want).max() <= 1


def test_blackout_and_mouth_box_are_bitwise_jax():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (48, 64, 3), dtype=np.uint8)
    parse, _ = _parse_image(rng, 48, 64)
    _same(ptools.blackout_background(img, parse, (7, 8, 9)),
          jtools.blackout_background(img, parse, (7, 8, 9)))
    lms = np.c_[rng.uniform(20, 44, 68), rng.uniform(20, 40, 68)]
    _same(ptools.visualize_mouth_region(img, lms, 5),
          jtools.visualize_mouth_region(img, lms, 5))


# ------------------------------------------------------------- the CLI


def _subject(root, n_frames=6, hw=64):
    """tests/test_pipeline.py's tiny video: a bright face-like disk
    drifting over a dark background, and 0.5 s of a 330 Hz sine."""
    d = root / "subj"
    ori = d / "ori_imgs"
    os.makedirs(ori)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n_frames):
        cx, cy = hw // 2 + i, 28 * hw // 64 + (i % 2)
        disk = ((xx - cx) ** 2 + (yy - cy) ** 2) < (14 * hw // 64) ** 2
        img = np.full((hw, hw, 3), 30, np.uint8)
        img[disk] = [200, 170, 150]
        img = np.clip(img.astype(int) + rng.randint(-8, 8, img.shape), 0,
                      255).astype(np.uint8)
        imageio.imwrite(ori / f"{i}.jpg", img)
    sr = 16000
    t = np.arange(sr // 2) / sr
    samples = (np.sin(2 * np.pi * 330 * t) * 8000).astype(np.int16)
    with wave.open(str(d / "aud.wav"), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(struct.pack(f"<{len(samples)}h", *samples))
    return d


def _jpeg_bytes(path, img):
    """``img`` as the JAX CLI writes it (imageio), read back as bytes."""
    imageio.imwrite(path, img)
    with open(path, "rb") as fh:
        return fh.read()


def test_process_data_cli_matches_jax_then_trains(tmp_path, monkeypatch):
    from idealnerf_tpu.cli.process_data import _read_wav
    from idealnerf_tpu_torch.cli import common as cli_common
    from idealnerf_tpu_torch.cli import process_data, train_head
    from idealnerf_tpu_torch.utils.summary import SummaryWriter
    from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
    from idealnerf_tpu_torch.eval.video import read_png

    monkeypatch.setattr(pfan, "CROP_SIZE", CROP)
    monkeypatch.setattr(jfan, "NUM_MODULES", 1)
    monkeypatch.setattr(jfan, "CROP_SIZE", CROP)
    monkeypatch.setattr(jfan, "HEATMAP_SIZE", CROP // 4)
    monkeypatch.setattr(jfan, "apply_fan", jax.jit(jfan.apply_fan))
    monkeypatch.setattr(pparse, "INFER_SIZE", CROP)
    monkeypatch.setattr(jparse, "apply_bisenet", jax.jit(jparse.apply_bisenet))
    # the metrics stream without TensorBoard, whose import is slow here
    monkeypatch.setattr(cli_common, "SummaryWriter", functools.partial(
        SummaryWriter, use_tensorboard=False))

    d = _subject(tmp_path)
    n, ori = 6, d / "ori_imgs"
    fan_params = pfan.init_fan(0, num_modules=1)
    bise_params = pparse.init_bisenet(1)
    np.savez(tmp_path / "fan.npz", **fan_params)
    # BiSeNet as a released torch state dict, BatchNorm counters and all
    sd = {k: torch.from_numpy(v) for k, v in bise_params.items()}
    sd["cp.resnet.bn1.num_batches_tracked"] = torch.tensor(5)
    torch.save(sd, tmp_path / "bisenet.pth")
    ds_params = pds.random_params(torch.Generator().manual_seed(2),
                                  n_hidden=8, scale=0.2)
    pb = str(tmp_path / "output_graph.pb")
    pds.save_frozen_graph(pb, pds.consts_from_params(ds_params))

    res = process_data.main([
        "--id_dir", str(d), "--fan_weights", str(tmp_path / "fan.npz"),
        "--parse_weights", str(tmp_path / "bisenet.pth"),
        "--deepspeech_pb", pb, "--device", "cpu"])
    assert res["frames"] == n and set(res["steps"]) == set(
        process_data.STEPS)

    # audio: the JAX chain through the JAX graph reader and model
    audio, sr = _read_wav(str(d / "aud.wav"))
    want = jaudio.extract_deepspeech_features(
        audio, sr, num_frames=n, logits_fn=make_logits_fn_from_graph(pb))
    aud = np.load(d / "aud.npy")
    assert aud.shape == (n, 16, 29) and aud.dtype == np.float32
    np.testing.assert_allclose(aud, want, rtol=2e-4, atol=2e-5)

    # landmarks (the full frame as the box: parsing/ did not exist yet)
    # and the parse maps, wherever the two best classes stand apart
    frames = [imageio.imread(ori / f"{i}.jpg") for i in range(n)]
    net = pparse.BiSeNet.from_state_dict(bise_params)
    for i, img in enumerate(frames):
        want = jfan.detect_landmarks(fan_params, img,
                                     np.array([0, 0, 64, 64], np.float32))
        np.testing.assert_allclose(np.loadtxt(ori / f"{i}.lms"), want,
                                   rtol=0, atol=1e-4)
        parse = read_png(str(d / "parsing" / f"{i}.png"))
        want = jproc.parse_color_map(jparse.parse_image(bise_params, img,
                                                        infer_size=CROP))
        top2 = torch.topk(pparse.parse_logits(net, img), 2, dim=0).values
        clear = (top2[0] - top2[1] > 1e-3).numpy()
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(parse[clear], want[clear])

    # the plate, com_imgs and head_imgs: the JAX functions on the files
    # the port wrote, written by imageio, are the port's files byte for byte
    parses = [imageio.imread(d / "parsing" / f"{i}.png") for i in range(n)]
    plate = jproc.extract_background_plate(
        np.stack(frames), np.stack([jproc.head_mask_from_parse(p)
                                    for p in parses]))
    ref = tmp_path / "ref"
    os.makedirs(ref)
    assert (d / "bc.jpg").read_bytes() == _jpeg_bytes(ref / "bc.jpg", plate)
    plate = imageio.imread(d / "bc.jpg")
    for i in range(n):
        com, head = jproc.decouple_images(frames[i], parses[i], plate)
        assert (d / "com_imgs" / f"{i}.jpg").read_bytes() == _jpeg_bytes(
            ref / "c.jpg", com)
        assert (d / "head_imgs" / f"{i}.jpg").read_bytes() == _jpeg_bytes(
            ref / "h.jpg", head)

    # the tracker's output and the transforms the JAX writer makes of it
    tp = np.load(d / "track_params.npz")
    assert float(tp["focal"]) in range(600, 1500, 100)
    assert all(np.isfinite(tp[k]).all() for k in ("euler", "trans", "exp"))
    lms = {i: np.loadtxt(ori / f"{i}.lms")[:, :2] for i in range(n)}
    jproc.write_transforms(str(ref), list(range(n)), tp["euler"],
                           tp["trans"] / 10.0, tp["exp"], lms,
                           focal=float(tp["focal"]), h=64, w=64,
                           subject="subj")
    _hold_transforms(str(d), str(ref))

    # the directory loads and trains
    ds = load_transforms_dataset(str(d), mode="train")
    assert ds.size == 5 and ds.images.shape[1:3] == (64, 64)
    out = train_head.main([
        "--config", str(d / "HeadNeRF_config.txt"), "--device", "cpu",
        "--dim_aud", "32", "--dim_expr", str(ds.exprs.shape[1]),
        "--dim_latent", "4", "--netdepth", "4", "--netwidth", "32",
        "--N_rand", "64", "--N_samples", "8", "--N_importance", "8",
        "--epochs", "1", "--i_print", "1", "--basedir",
        str(tmp_path / "logs")])
    assert out["step"] == 5 and len(out["history"]) == 5
    assert all(np.isfinite(m["loss"]) for _, m in out["history"])
