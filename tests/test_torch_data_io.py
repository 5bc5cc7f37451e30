"""The port's file I/O against the JAX package's: the subject loader and
its export, the JPEG route (Pillow), the PNG reader, the MJPG .avi
writer, the metrics stream, the diagnostics, and the CLIs on a
reference-format subject directory; plus the paper model's frame against
the JAX package's plain XLA renderer (the 24² case of the committed 450²
fixture, tests/frame_fixture.py).

Images: the JAX loader decodes frames with the system libjpeg
(native/frameloader.cpp) and the plate through imageio; the port decodes
both with Pillow's own libjpeg-turbo. They are held within 2 levels, and
the count of differing pixels is bounded (it is 0 on the machines these
tests were written on).
"""

import json
import math
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from idealnerf_tpu.data.dataset import (
    load_transforms_dataset as jax_load,
)
from idealnerf_tpu.data.export import write_reference_format as jax_export
from idealnerf_tpu.utils.summary import SummaryWriter as JaxSummary
from idealnerf_tpu_torch.cli import render_val, train_head, train_torso
from idealnerf_tpu_torch.data import jpeg
from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
from idealnerf_tpu_torch.data.export import write_reference_format
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval.video import (
    VideoWriter, read_avi_frames, read_png, write_png,
)
from idealnerf_tpu_torch.utils import diagnostics, video_tools
from idealnerf_tpu_torch.utils.summary import SummaryWriter

import frame_fixture

ARRAYS = ("poses", "auds", "aud_ids", "exprs", "face_rects", "mouth_boxes",
          "landmarks", "torso_masks")
CLI_SMALL = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
             "--netdepth", "4", "--netwidth", "64", "--N_rand", "64",
             "--N_samples", "8", "--N_importance", "8"]


@pytest.fixture(scope="module")
def subject_ds():
    return make_synthetic_dataset(n_frames=6, H=24, W=20, dim_expr=8,
                                  seed=2, with_torso=True)


def _same_images(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 2, diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).sum()


def _held_equal(port, ref):
    for name in ARRAYS:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (port.focal, port.cx, port.cy, port.near, port.far) == (
        ref.focal, ref.cx, ref.cy, ref.near, ref.far)
    _same_images(port.images, ref.images)
    _same_images(port.bc_img, ref.bc_img)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loader_matches_jax_loader(writer, subject_ds, tmp_path):
    """Both loaders on the same directory, written by either export."""
    export = jax_export if writer == "jax" else write_reference_format
    cfg_path = export(subject_ds, str(tmp_path), subject="t")
    assert cfg_path == str(tmp_path / "HeadNeRF_config.txt")
    for mode, gt_dirs in (("train", "head_imgs"), ("val", "com_imgs")):
        port = load_transforms_dataset(str(tmp_path), mode=mode,
                                       gt_dirs=gt_dirs)
        ref = jax_load(str(tmp_path), mode=mode, gt_dirs=gt_dirs)
        assert port.size == (5 if mode == "train" else 1)
        _held_equal(port, ref)
    # skip, max_frames, explicit bounds, and aud_id clamped to the track
    port = load_transforms_dataset(str(tmp_path), skip=2, max_frames=2,
                                   near=0.5, far=2.5)
    ref = jax_load(str(tmp_path), skip=2, max_frames=2, near=0.5, far=2.5)
    assert port.size == 2 and (port.near, port.far) == (0.5, 2.5)
    _held_equal(port, ref)
    np.save(tmp_path / "short.npy", subject_ds.auds[:3])
    port = load_transforms_dataset(str(tmp_path), aud_file="short.npy")
    assert port.aud_ids.max() == 2
    _held_equal(port, jax_load(str(tmp_path), aud_file="short.npy"))


def test_port_export_round_trips(subject_ds, tmp_path):
    """The port's export read back by the port's loader (as
    tests/test_data_and_train.py::test_export_roundtrip_through_loader
    holds the JAX pair), and its JPEGs are the JAX export's bytes."""
    write_reference_format(subject_ds, str(tmp_path / "port"), subject="t")
    jax_export(subject_ds, str(tmp_path / "jax"), subject="t")
    ds = load_transforms_dataset(str(tmp_path / "port"))
    split = int(6 * 10 / 11)
    assert ds.size == split
    np.testing.assert_allclose(ds.poses, subject_ds.poses[:split], atol=1e-5)
    np.testing.assert_allclose(ds.exprs, subject_ds.exprs[:split], atol=1e-5)
    np.testing.assert_allclose(ds.landmarks, subject_ds.landmarks[:split],
                               atol=0.01)
    np.testing.assert_array_equal(ds.auds, subject_ds.auds)
    err = np.abs(ds.images.astype(np.int16)
                 - subject_ds.images[:split].astype(np.int16)).mean()
    assert err < 6.0, err
    assert (ds.near, ds.far) == (subject_ds.near, subject_ds.far)
    for rel in ("bc.jpg", "head_imgs/0.jpg", "com_imgs/5.jpg"):
        assert (open(tmp_path / "port" / rel, "rb").read()
                == open(tmp_path / "jax" / rel, "rb").read()), rel
    for name in ("transforms_exp_train.json", "transforms_exp_val.json"):
        assert (json.load(open(tmp_path / "port" / name))
                == json.load(open(tmp_path / "jax" / name)))
    whole = write_reference_format(subject_ds, str(tmp_path / "drive"),
                                   train_fraction=1.0)
    assert load_transforms_dataset(os.path.dirname(whole)).size == 6


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(11):
        img = rng.randint(0, 255, (32, 48, 3)).astype(np.uint8)
        img[:, :, 1] = 20 * i
        p = str(d / f"{i}.jpg")
        imageio.imwrite(p, img, quality=92)
        paths.append(p)
    return paths, np.stack([np.asarray(imageio.imread(p)) for p in paths])


def test_decode_jpeg_batch_matches_imageio(jpgs):
    paths, reference = jpgs
    out = jpeg.decode_jpeg_batch(paths, 32, 48, n_threads=4)
    assert out.shape == (11, 32, 48, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, reference)
    np.testing.assert_array_equal(jpeg.read_jpeg(paths[3]), reference[3])
    data = open(paths[5], "rb").read()
    np.testing.assert_array_equal(jpeg.decode_jpeg_bytes(data), reference[5])


@pytest.mark.parametrize("case", ["corrupt", "missing", "mismatch", "png"])
def test_decode_jpeg_batch_names_the_bad_file(case, jpgs, tmp_path):
    """Where the JAX loader zero-fills, the port raises naming the file."""
    paths, _ = jpgs
    bad = str(tmp_path / "bad.jpg")
    if case == "corrupt":
        with open(bad, "wb") as fh:
            fh.write(b"\xff\xd8 not a real jpeg \xff\xd9")
    elif case == "mismatch":
        jpeg.write_jpeg(bad, np.zeros((16, 16, 3), np.uint8))
    elif case == "png":
        write_png(bad, np.zeros((32, 48, 3), np.uint8))
    with pytest.raises(ValueError, match=os.path.basename(bad)):
        jpeg.decode_jpeg_batch([paths[1], bad, paths[2]], 32, 48,
                               n_threads=2)
    with pytest.raises(ValueError, match=os.path.basename(bad)):
        for _ in jpeg.stream_decode_chunks([paths[1], bad], 32, 48, chunk=1):
            pass


def test_stream_decode_chunks_matches_batch(jpgs):
    paths, _ = jpgs
    want = jpeg.decode_jpeg_batch(paths, 32, 48)
    got = np.zeros_like(want)
    seen = []
    for idx, frames in jpeg.stream_decode_chunks(paths, 32, 48, chunk=4):
        seen.append(idx)
        got[idx * 4:idx * 4 + frames.shape[0]] = frames  # copy out
    assert seen == [0, 1, 2]
    np.testing.assert_array_equal(got, want)
    # a consumer that stops early releases the pool
    first = next(iter(jpeg.stream_decode_chunks(paths, 32, 48, chunk=4)))
    assert first[0] == 0


def _png_bytes(img, filter_type, color=2, depth=8, interlace=0):
    """An 8-bit PNG whose every row uses ``filter_type`` (the filters are
    computed from the original bytes, so numpy vectorises them)."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, -1).astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = [0 * x, a, b, (a + b) >> 1][filter_type]
    rows = np.concatenate([np.full((h, 1), filter_type),
                           (x - pred) & 0xFF], 1).astype(np.uint8)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, color, 0, 0,
                       interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_read_png_matches_pil(filter_type, tmp_path):
    rng = np.random.RandomState(filter_type)
    rgb = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    rgb[4:9] = np.linspace(0, 255, 17)[None, :, None].astype(np.uint8)
    for color, img in ((0, rgb[:, :, 0]), (2, rgb),
                       (6, np.concatenate([rgb, rgb[:, :, :1]], -1))):
        path = str(tmp_path / f"{color}.png")
        with open(path, "wb") as fh:
            fh.write(_png_bytes(img, filter_type, color))
        got = read_png(path)
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
        np.testing.assert_array_equal(got, img)


def test_read_png_reads_pil_files_and_refuses_others(tmp_path):
    rgb = np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(
        np.uint8)
    rgb[5:15] = 255
    Image.fromarray(rgb).save(tmp_path / "pil.png")     # adaptive filters
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil.png")), rgb)
    for name, kw in (("deep", dict(depth=16)), ("palette", dict(color=3)),
                     ("interlaced", dict(interlace=1))):
        path = tmp_path / f"{name}.png"
        path.write_bytes(_png_bytes(rgb, 0, **kw))
        with pytest.raises(ValueError, match=f"{name}.png"):
            read_png(str(path))
    raw = bytearray(_png_bytes(rgb, 0))
    path = tmp_path / "badfilter.png"
    rows = np.frombuffer(zlib.decompress(_idat(bytes(raw))), np.uint8).copy()
    rows[0] = 7
    path.write_bytes(bytes(raw).replace(
        zlib.compress(np.concatenate([np.zeros((20, 1), np.uint8),
                                      rgb.reshape(20, -1)], 1).tobytes()),
        zlib.compress(rows.tobytes())))
    with pytest.raises(ValueError, match="filter type 7"):
        read_png(str(path))


def _idat(png):
    n = struct.unpack(">I", png[33:37])[0]
    return png[41:41 + n]


def test_video_writer_read_by_cv2(tmp_path):
    """Mirrors tests/test_eval.py::test_video_writer, and cv2 reads the
    file: frame count, 25 fps, frames within JPEG error."""
    yy, xx = np.mgrid[0:32, 0:48]
    frames = [np.stack([(xx * 5 + 20 * i) % 256, yy * 7, 0 * xx + 40 * i],
                       -1).astype(np.uint8) for i in range(5)]
    path = str(tmp_path / "out.avi")
    with VideoWriter(path, fps=25, frame_jpg_every=2) as w:
        for f in frames:
            w.add(f)
        w.add(frames[0].astype(np.float32) / 255.0)       # floats too
    jpgs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".jpg"))
    assert jpgs == ["out_00000.jpg", "out_00002.jpg", "out_00004.jpg"]
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 6
    read = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        read.append(f[..., ::-1])
    cap.release()
    want = np.stack(frames + [frames[0]]).astype(np.int16)
    assert len(read) == 6
    assert np.abs(np.stack(read) - want).mean() < 6.0
    ours, fps = read_avi_frames(path)
    assert fps == 25.0 and ours.shape == (6, 32, 48, 3)
    assert np.abs(ours - want).mean() < 6.0
    still = np.asarray(imageio.imread(tmp_path / "out_00002.jpg"))
    np.testing.assert_array_equal(still, ours[2])
    with pytest.raises(ValueError, match="frame 1"):
        with VideoWriter(str(tmp_path / "x.avi")) as w:
            w.add(frames[0])
            w.add(frames[0][:16])


def test_video_tools_round_trip(tmp_path, monkeypatch):
    frames = [np.full((16, 24, 3), 30 * i, np.uint8) for i in range(4)]
    paths = []
    for i, f in enumerate(frames):
        p = str(tmp_path / (f"{i}.png" if i % 2 else f"{i}.jpg"))
        (write_png if i % 2 else jpeg.write_jpeg)(p, f)
        paths.append(p)
    avi = str(tmp_path / "v.avi")
    assert video_tools.images_to_video(paths, avi) == 4
    assert not [f for f in os.listdir(tmp_path) if f.startswith("v_")]
    assert video_tools.video_to_images(avi, str(tmp_path / "out"),
                                       max_frames=3) == 3
    back = np.stack([jpeg.read_jpeg(str(tmp_path / "out" / f"{i}.jpg"))
                     for i in range(3)])
    assert np.abs(back.astype(int) - np.stack(frames[:3])).max() <= 3
    # another container needs an ffmpeg binary, and without one it raises
    # naming it
    monkeypatch.setattr(video_tools.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no ffmpeg binary"):
        video_tools.video_to_images(str(tmp_path / "clip.mp4"),
                                    str(tmp_path / "x"))
    # a truncated .avi keeps the reader's own error, chained
    bad = str(tmp_path / "cut.avi")
    with open(avi, "rb") as src, open(bad, "wb") as dst:
        dst.write(src.read(24))
    with pytest.raises(RuntimeError, match="MJPG reader refused") as err:
        video_tools.video_to_images(bad, str(tmp_path / "y"))
    assert isinstance(err.value.__cause__, ValueError)


def test_summary_writer_matches_jax_records(tmp_path):
    values = [(0, {"loss": 0.5, "psnr": np.float32(12.25)}),
              (10, {"loss": 0.125, "psnr": 20.0, "lr": 5e-4})]
    for cls, d in ((JaxSummary, tmp_path / "jax"),
                   (SummaryWriter, tmp_path / "port")):
        w = cls(str(d), use_tensorboard=False)
        for step, v in values:
            w.scalars(step, v)
        w.scalars(3, {"loss": 1.0}, prefix="torso")
        w.close()
    recs = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "metrics.jsonl") as fh:
            rs = [json.loads(line) for line in fh]
        assert all(isinstance(r.pop("time"), float) for r in rs)
        recs.append(rs)
    assert recs[0] == recs[1] and recs[1][2] == {"step": 3,
                                                 "torso/loss": 1.0}
    with SummaryWriter(str(tmp_path / "img"), use_tensorboard=False) as w:
        path = w.image(7, "val/rgb", np.full((8, 8, 3), 0.5, np.float32))
    assert os.path.basename(path) == "val_rgb_00000007.jpg"
    assert abs(int(jpeg.read_jpeg(path).mean()) - 127) <= 1


def test_diagnostics():
    net = torch.nn.Linear(3, 2)
    assert float(diagnostics.finite_check(net)) == 1.0
    tree = {"a": torch.ones(2), "b": [torch.zeros(3, dtype=torch.int64),
                                      torch.tensor([1.0, float("nan")])]}
    assert float(diagnostics.finite_check(tree)) == 0.0
    assert float(diagnostics.finite_check([])) == 1.0
    timer = diagnostics.StepTimer(warmup=1)
    assert timer.tick("cpu") == {}
    out = timer.tick(torch.ones(1))
    assert set(out) == {"steps_per_sec", "ms_per_step"}


def test_profile_writes_a_trace(tmp_path):
    with diagnostics.profile(str(tmp_path)):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_frame_matches_jax_xla_renderer():
    """The paper model (seeded numpy weights) at 24²: the port's fused
    renderer (bf16 rounding, on the CPU its plain version) against the
    JAX package's plain f32 XLA path, the generator of the committed 450²
    fixture, at 3e-2 with corr > 0.999."""
    ref = frame_fixture.jax_frame(24)
    out = frame_fixture.port_frame(24)
    assert out.shape == ref.shape == (24, 24, 3)
    np.testing.assert_allclose(out, ref, atol=3e-2)
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999


def test_committed_fixture_is_the_generators():
    stem = os.path.join(frame_fixture.FIXTURES, "jax_frame_450")
    with open(stem + ".json") as fh:
        meta = json.load(fh)
    assert meta["config"] == frame_fixture.PAPER
    assert meta["subject"] == frame_fixture.SUBJECT
    assert meta["seed"] == frame_fixture.SEED
    img = read_png(stem + ".png")
    assert list(img.shape) == meta["shape"] == [450, 450, 3]
    assert abs(img.mean() / 255.0 - meta["mean"]) < 1e-3


@pytest.fixture(scope="module")
def subject_dir(tmp_path_factory, subject_ds):
    d = tmp_path_factory.mktemp("subject")
    return write_reference_format(subject_ds, str(d / "subj"), subject="s")


def test_train_head_and_torso_on_a_subject_directory(subject_dir, tmp_path):
    """train_head and train_torso read --datadir (through the subject's
    config file) and stream their metrics with the JAX CLIs' keys."""
    base = ["--device", "cpu", "--config", subject_dir, *CLI_SMALL,
            "--basedir", str(tmp_path), "--i_print", "2"]
    res = train_head.main([*base, "--epochs", "1"])
    assert res["step"] == 5
    with open(tmp_path / "s_head" / "metrics.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs] == [2, 4]
    assert set(recs[0]) == {"step", "time"} | {
        f"train/{k}" for k in ("loss", "psnr", "latent_loss", "lr",
                               "steps_per_sec", "steps_per_sec_rolling")}
    assert all(math.isfinite(v) for r in recs for v in r.values())
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "s_head"))
    out = train_torso.main([*base, "--head_ckpt", res["ckpt_dir"],
                            "--steps", "3", "--vis_path",
                            str(tmp_path / "vis")])
    assert out["step"] == 3
    with open(tmp_path / "vis" / "metrics.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs] == [0, 2]
    assert {"torso/loss", "torso/psnr", "torso/lr"} <= set(recs[0])


def test_render_val_on_a_subject_directory(subject_dir, tmp_path):
    res = render_val.main(["--device", "cpu", "--config", subject_dir,
                           *CLI_SMALL, "--save_path", str(tmp_path)])
    assert res["frames"].shape == (1, 24, 20, 3)
    assert sorted(os.listdir(tmp_path)) == ["s_head_val.avi",
                                            "s_head_val_00000.jpg"]
    video, fps = read_avi_frames(str(tmp_path / "s_head_val.avi"))
    assert fps == 25.0 and video.shape == (1, 24, 20, 3)
    assert np.abs(video / 255.0 - res["frames"]).mean() < 6 / 255
