"""Streaming serving of the PyTorch port (eval/stream.TemporalStream and
cli/serve), head only and head + torso, against the JAX package's
TemporalStream, plus the stream's own contract (lookahead, flush,
warm-up, push_device, rolling refresh, the composite stream against the
offline temporal reenact) and a guard that the port never imports JAX or
the JAX package.

The setup is tests/test_stream.py's (24x24 synthetic subject, 6 frames,
refresh 2, s_delta 6, prior on, AudioAttNet smoothing), with softplus
density: the comparison runs through the delta-frame feedback, where a
CDF bin under sample_pdf's 1e-5 floor would meet the recorded pin
difference (ROADMAP.md C). Frames are held to 3e-2 with correlation >
0.999, the bound of the fused kernels' tests (bf16 weights and
activations on both sides)."""

import ast
import math
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.eval.stream import TemporalStream as JaxStream
from idealnerf_tpu.train.state import init_train_state as jax_init_state
from idealnerf_tpu.train.torso import init_torso_params as jax_init_torso
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.cli import serve
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval.reenact import reenact
from idealnerf_tpu_torch.eval.stream import TemporalStream
from idealnerf_tpu_torch.eval.video import read_avi_frames
from idealnerf_tpu_torch.kernels import build as kbuild
from idealnerf_tpu_torch.kernels import fused_render as fr

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(dim_aud=64, dim_expr=8, dim_latent=32, N_samples=8,
          N_importance=8, density_activation="softplus")
CLI_SMALL = ["--dim_aud", "32", "--dim_expr", "8", "--dim_latent", "4",
             "--netdepth", "4", "--netwidth", "64", "--N_samples", "8",
             "--N_importance", "8", "--refresh", "2", "--s_delta", "6"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The JAX package's initial state, bridged into the port."""
    jcfg, cfg = JaxConfig(**KW), ExperimentConfig(**KW)
    jds = jax_synthetic(n_frames=6, H=24, W=24, dim_expr=8)
    ds = make_synthetic_dataset(n_frames=6, H=24, W=24, dim_expr=8)
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jds.size)
    state = bridge.train_state_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        np.asarray(jstate.latent_codes), cfg)
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jstate=jstate,
                params=state.params, latents=state.latent_codes.detach())


@pytest.fixture(scope="module")
def composite():
    """The setup fixture's subject with narrower head and torso fields of
    both packages (netwidth 64, netdepth 4): two fields per frame."""
    kw = dict(KW, netwidth=64, netdepth=4)
    jcfg, cfg = JaxConfig(**kw), ExperimentConfig(**kw)
    jds = jax_synthetic(n_frames=6, H=24, W=24, dim_expr=8)
    ds = make_synthetic_dataset(n_frames=6, H=24, W=24, dim_expr=8)
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jds.size)
    state = bridge.train_state_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        np.asarray(jstate.latent_codes), cfg)
    jtorso = jax_init_torso(jax.random.PRNGKey(1), jcfg)
    torso = bridge.torso_params_from_jax(jax.tree.map(np.asarray, jtorso),
                                         cfg)
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jstate=jstate,
                params=state.params, latents=state.latent_codes.detach(),
                jtorso=jtorso, torso=torso)


def _stream(s, **kw):
    return TemporalStream(s["cfg"], s["params"], s["ds"],
                          latent_codes=s["latents"], **kw)


def _drive(stream, ds, n):
    """tests/test_stream.py:_drive: push n frames (poses cycle, exprs
    clamp at the track's end) and drain."""
    frames = []
    for i in range(n):
        f = stream.push(ds.auds[i], expr=ds.exprs[min(i, n - 1)],
                        pose=ds.poses[i % ds.size])
        if f is not None:
            frames.append(f)
    frames.extend(stream.flush())
    return frames


def test_stream_matches_jax_stream(setup):
    """Head-only: 6 streamed frames, two keyframes and four delta frames
    (s_delta 6: 2 uniform + 3 importance depths, one delta-kernel launch
    each), against the JAX stream on the same pushes."""
    s = setup
    kw = dict(refresh=2, s_delta=6, use_prior=True, smooth_audio=True)
    ref = _drive(JaxStream(s["jcfg"], s["jstate"].params, s["jds"],
                           latent_codes=s["jstate"].latent_codes, **kw),
                 s["jds"], 6)
    stream = _stream(s, **kw)
    assert stream.algorithmic_latency_frames == 3
    frames = _drive(stream, s["ds"], 6)
    assert len(frames) == 6
    assert stream.frame_kinds == ["keyframe", "delta"] * 3
    for got, want in zip(frames, ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=3e-2)
        c = np.corrcoef(got.ravel(), np.asarray(want).ravel())[0, 1]
        assert c > 0.999, c


def test_stream_lookahead_flush_and_closed(setup):
    """tests/test_stream.py:129-155: a smoothed stream holds back exactly
    its lookahead of 3 and flush drains it; unsmoothed, every push emits
    (lookahead 0); a closed stream refuses pushes."""
    s = setup
    stream = _stream(s, refresh=3, s_delta=6, smooth_audio=True)
    n = 5
    emitted = [stream.push(s["ds"].auds[i]) for i in range(n)]
    warm = stream.algorithmic_latency_frames
    assert warm == 3
    assert [e is None for e in emitted] == [True] * warm + [False] * (n - warm)
    assert len(stream.flush()) == warm
    with pytest.raises(RuntimeError, match="closed"):
        stream.push(s["ds"].auds[0])

    live = _stream(s, refresh=3, s_delta=6, smooth_audio=False)
    assert live.algorithmic_latency_frames == 0
    assert all(live.push(s["ds"].auds[i]) is not None for i in range(3))
    assert live.flush() == []
    assert len(live.frame_times) == 3
    assert live.frame_kinds == ["keyframe", "delta", "delta"]


def test_stream_warmup_does_not_perturb_output(setup):
    """tests/test_stream.py:158-173: a warmed stream emits the frames of
    a cold one, bit for bit."""
    s = setup
    kw = dict(refresh=2, s_delta=6, smooth_audio=False)
    ref = _drive(_stream(s, **kw), s["ds"], 4)
    warm = _stream(s, **kw)
    assert warm.warmup() > 0.0
    np.testing.assert_array_equal(np.stack(_drive(warm, s["ds"], 4)),
                                  np.stack(ref))


def test_stream_push_device_matches_push(setup):
    s = setup
    a = _stream(s, refresh=3, s_delta=6, smooth_audio=False)
    b = _stream(s, refresh=3, s_delta=6, smooth_audio=False)
    for i in range(4):
        fa = a.push(s["ds"].auds[i], pose=s["ds"].poses[i % s["ds"].size])
        fb = b.push_device(s["ds"].auds[i],
                           pose=s["ds"].poses[i % s["ds"].size])
        assert isinstance(fa, np.ndarray) and isinstance(fb, torch.Tensor)
        np.testing.assert_array_equal(fa, fb.numpy())


def test_stream_rolling_refresh(setup):
    """tests/test_temporal.py:918-945: with roll_k only frame 0 is a
    keyframe, every push emits, and the refresh phase keeps cycling."""
    s = setup
    stream = _stream(s, s_delta=6, delta_keep=0.75, roll_k=3, use_prior=True,
                     smooth_audio=False)
    n = 7
    frames = [stream.push(s["ds"].auds[i % 6], expr=s["ds"].exprs[i % 6])
              for i in range(n)] + stream.flush()
    assert len(frames) == n and all(np.isfinite(f).all() for f in frames)
    assert stream._cache["phase"] == (n - 1) % 3
    assert stream.frame_kinds == ["keyframe"] + ["delta"] * (n - 1)


# a kt1-style operating point: the torso frozen between keyframes and
# pruned to its top rays (tests/test_stream.py:78-95)
KT1 = dict(refresh=2, s_delta=6, delta_keep=0.75, delta_keep_torso=0.01,
           freeze_z_torso=True, quality_ok=True)


def test_composite_stream_matches_offline_reenact_and_jax(composite):
    """tests/test_stream.py:78-95: the head + torso stream at a kt1-style
    point against the port's offline reenact(temporal=2) on the same
    driving track (the stream computes AudioNet per frame and the offline
    path in one batch: within 6e-3, 99 % of pixels within 2e-5, as the
    JAX test), and against the JAX stream (3e-2, correlation > 0.999)."""
    s = composite
    n = 5
    op = dict(KT1)
    ref = reenact(s["cfg"], s["params"], s["ds"], s["ds"].auds[:n],
                  driving_exprs=s["ds"].exprs[:n],
                  latent_codes=s["latents"], torso_params=s["torso"],
                  max_frames=n, smooth_audio=True, use_prior=True,
                  temporal=op["refresh"], s_delta=op["s_delta"],
                  delta_keep=op["delta_keep"],
                  delta_keep_torso=op["delta_keep_torso"],
                  freeze_z_torso=op["freeze_z_torso"])
    stream = _stream(s, torso_params=s["torso"], use_prior=True,
                     operating_point=op)
    assert stream.refresh == 2 and stream._render.stages["torso"].tag == "torso"
    frames = _drive(stream, s["ds"], n)
    assert len(frames) == n
    assert stream.frame_kinds == ["keyframe", "delta"] * 2 + ["keyframe"]
    d = np.abs(np.stack(frames) - ref)
    assert d.max() < 6e-3 and (d <= 2e-5).mean() > 0.99, d.max()
    jref = _drive(JaxStream(s["jcfg"], s["jstate"].params, s["jds"],
                            torso_params=s["jtorso"],
                            latent_codes=s["jstate"].latent_codes,
                            use_prior=True, operating_point=op), s["jds"], n)
    for got, want in zip(frames, jref):
        np.testing.assert_allclose(got, np.asarray(want), atol=3e-2)
        c = np.corrcoef(got.ravel(), np.asarray(want).ravel())[0, 1]
        assert c > 0.999, c


@pytest.mark.parametrize("roll", [dict(roll_k=3), dict(roll_k_torso=3)],
                         ids=["roll-k", "roll-k-torso"])
def test_composite_stream_rolls(composite, roll):
    """Rolling composite streams: with roll_k only frame 0 is a keyframe
    and both fields cycle their refresh phase; with roll_k_torso the head
    keeps its keyframes and the torso its phase. The warm-up leaves the
    frames of a cold stream unchanged."""
    s = composite
    kw = dict(torso_params=s["torso"], s_delta=6, use_prior=True,
              smooth_audio=False, refresh=4, **roll)
    n = 5
    cold = [s["ds"].auds[i] for i in range(n)]
    ref = _stream(s, **kw)
    want = [ref.push(a) for a in cold]
    warm = _stream(s, **kw)
    assert warm.warmup() > 0.0
    got = [warm.push(a) for a in cold]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert all(np.isfinite(f).all() for f in got)
    cache = warm._cache
    if "roll_k" in roll:
        assert warm.frame_kinds == ["keyframe"] + ["delta"] * (n - 1)
        assert cache["head"]["phase"] == cache["torso"]["phase"] == (n - 1) % 3
    else:
        assert warm.frame_kinds == ["keyframe", "delta", "delta", "delta",
                                    "keyframe"]
        assert cache["torso"]["phase"] == 0 and isinstance(cache["head"],
                                                           tuple)


@pytest.mark.parametrize("kw,err,match", [
    (dict(operating_point=dict(quality_ok=False, refresh=25)), ValueError,
     "quality gate"),
    (dict(torso_params={}, roll_k_torso=1), ValueError, "roll_k_torso"),
    (dict(torso_params={}, roll_k=2, roll_k_torso=2), ValueError,
     "exclusive"),
    (dict(torso_params={}, bounds=(0.5, 1.5)), ValueError, "per-field"),
    (dict(operating_point=dict(roll_k_torso=1)), ValueError, "roll_k_torso"),
    (dict(roll_k=1), ValueError, "roll_k"),
    (dict(bounds={"head": (0.5, 1.5)}), ValueError, "composite"),
])
def test_stream_refuses(setup, kw, err, match):
    with pytest.raises(err, match=match):
        _stream(setup, **kw)


def test_stream_operating_point_overrides_arguments(setup):
    stream = _stream(setup, refresh=25, operating_point=dict(
        quality_ok=True, refresh=3, s_delta=7, delta_keep_torso=0.1))
    assert stream.refresh == 3
    field = stream._render.field
    assert field.uses_delta_kernel


def test_serve_cli_on_cpu(tmp_path):
    """cli.serve on the CPU: the JAX CLI's stats plus the split by frame
    kind, the .avi, and no kernel launched or built."""
    fr.reset_launch_counts()
    kbuild.load_library.cache_clear()
    stats = serve.main(["--device", "cpu", "--synthetic", "3",
                        "--synthetic_hw", "16", *CLI_SMALL,
                        "--save_path", str(tmp_path)])
    assert set(stats) == {
        "frames", "roll_k", "warmup_s", "p50_ms", "p95_ms", "p99_ms",
        "deadline_40ms_hit_rate", "steady_fps", "keyframes", "keyframe_ms",
        "delta_frames", "delta_p50_ms", "delta_p95_ms", "finite"}
    assert stats["frames"] == 3 and stats["roll_k"] == 0
    assert stats["keyframes"] == 2 and stats["delta_frames"] == 1
    assert stats["finite"] is True
    assert all(math.isfinite(stats[k]) for k in
               ("warmup_s", "p50_ms", "p99_ms", "steady_fps", "keyframe_ms"))
    assert 0.0 <= stats["deadline_40ms_hit_rate"] <= 1.0
    assert sorted(os.listdir(tmp_path)) == ["exp_stream.avi",
                                            "exp_stream_00000.jpg"]
    assert read_avi_frames(str(tmp_path / "exp_stream.avi"))[0].shape == (
        3, 16, 16, 3)
    assert all(v == 0 for v in fr.launch_counts.values())
    assert kbuild.load_library.cache_info().currsize == 0

    stats = serve.main(["--device", "cpu", "--synthetic", "3",
                        "--synthetic_hw", "16", *CLI_SMALL, "--roll_k", "2",
                        "--no_smooth", "--max_frames", "2"])
    assert stats["frames"] == 2 and stats["roll_k"] == 2
    assert stats["keyframes"] == 1 and stats["delta_frames"] == 1


@pytest.mark.parametrize("flags,err,match", [
    (["--torso_ckpt", "t", "--roll_k_torso", "1"], ValueError,
     "roll_k_torso"),
    (["--roll_k", "2", "--roll_k_torso", "2"], ValueError, "exclusive"),
    # no evidence in the directory: the gate is closed, parser.error
    (["--auto_temporal", "no/such/dir"], SystemExit, "2"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
])
def test_serve_refuses(flags, err, match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cpu", "--synthetic", "1", "--synthetic_hw", "8",
            *CLI_SMALL, *flags]
    with pytest.raises(err, match=match):
        serve.main(argv)


def _imports(path):
    """Module names a file imports: import statements at any depth and
    importlib.import_module / __import__ calls with a literal name."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_never_imports_jax_or_the_jax_package():
    """Nor imageio, cv2 or torchvision, which the card's machine lacks
    (Pillow is the port's JPEG route and may be imported)."""
    files = sorted((ROOT / "idealnerf_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "idealnerf_tpu", "flax",
                                  "optax", "orbax", "imageio", "cv2",
                                  "torchvision")]
    assert not bad, bad
