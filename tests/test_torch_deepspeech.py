"""The port's DeepSpeech 0.1.0 model and frozen-graph reader/writer
(``idealnerf_tpu_torch.pipeline.deepspeech``) against the JAX package's,
mirroring tests/test_deepspeech.py.

The logits at n_hidden 64 (and the LSTM against a numpy rederivation at
6) are held to rtol 2e-4, atol 2e-5, tests/test_deepspeech.py:69's bound,
on JAX's ``random_params`` draws carried across by the bridge. The
protobuf round trip is bitwise in both directions: the port's writer
read by the JAX reader and the JAX writer read by the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.pipeline import audio as jaudio
from idealnerf_tpu.pipeline import deepspeech as jds
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.pipeline import audio as paudio
from idealnerf_tpu_torch.pipeline import deepspeech as pds

TOL = {"rtol": 2e-4, "atol": 2e-5}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed, n_input, n_hidden, scale):
    p = jds.random_params(jax.random.PRNGKey(seed), n_input=n_input,
                          n_hidden=n_hidden, scale=scale)
    return {k: np.asarray(v) for k, v in p.items()}


def test_logits_match_jax_at_64_hidden():
    """The release's 494-wide input, 64 hidden units, 30 frames."""
    p = _jax_params(0, 494, 64, 0.1)
    net = bridge.deepspeech_from_jax(p)
    x = np.random.RandomState(0).randn(30, 494).astype(np.float32)
    want = np.asarray(jds.deepspeech_logits(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = pds.deepspeech_logits(net, x).numpy()
    assert got.shape == (30, 29)
    np.testing.assert_allclose(got, want, **TOL)
    # the clipped relu clips: a blown-up input stays finite
    assert np.isfinite(pds.deepspeech_logits(net, x * 1e4).numpy()).all()


def test_lstm_matches_numpy_rederivation():
    """BasicLSTMCell (gate order i, j, f, o; forget_bias 1) step by step
    in numpy, on JAX's draws (tests/test_deepspeech.py:25-69)."""
    p = _jax_params(1, 10, 6, 0.3)
    x = np.random.RandomState(1).randn(7, 10).astype(np.float32)

    def clip(v):
        return np.minimum(np.maximum(v, 0.0), pds.RELU_CLIP)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    def lstm(kernel, bias, xs):
        hd = kernel.shape[1] // 4
        c, hh, out = np.zeros(hd), np.zeros(hd), []
        for t in range(xs.shape[0]):
            i, j, f, o = np.split(np.concatenate([xs[t], hh]) @ kernel
                                  + bias, 4)
            c = c * sig(f + 1.0) + sig(i) * np.tanh(j)
            hh = np.tanh(c) * sig(o)
            out.append(hh)
        return np.stack(out)

    h = clip(x @ p["h1"] + p["b1"])
    h = clip(h @ p["h2"] + p["b2"])
    h = clip(h @ p["h3"] + p["b3"])
    fw = lstm(p["fw_kernel"], p["fw_bias"], h)
    bw = lstm(p["bw_kernel"], p["bw_bias"], h[::-1])[::-1]
    want = (clip(np.concatenate([fw, bw], -1) @ p["h5"] + p["b5"]) @ p["h6"]
            + p["b6"])
    got = pds.deepspeech_logits(bridge.deepspeech_from_jax(p), x).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_random_params_topology_and_bridge():
    """The port's draws (a torch.Generator) have JAX's names and shapes;
    the bridge carries a net across and back bitwise."""
    want = _jax_params(2, 494, 16, 0.05)
    got = pds.random_params(torch.Generator().manual_seed(2), n_hidden=16)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    again = pds.random_params(torch.Generator().manual_seed(2), n_hidden=16)
    assert all(torch.equal(got[k], again[k]) for k in got)
    back = bridge.deepspeech_to_jax(bridge.deepspeech_from_jax(want))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_frozen_graph_round_trip_both_ways(tmp_path):
    """The port writes and JAX reads, JAX writes and the port reads: the
    consts bitwise, extra consts ignored, import-prefixed names
    resolved, a missing variable named."""
    p = _jax_params(3, 10, 6, 0.3)
    consts = pds.consts_from_params(p)
    consts["some/shape"] = np.asarray([1, 2, 3], np.float32)
    for writer, reader, name in (
            (pds.save_frozen_graph, jds, "port_to_jax.pb"),
            (jds.save_frozen_graph, pds, "jax_to_port.pb")):
        pb = str(tmp_path / name)
        writer(pb, consts)
        raw = reader.load_frozen_graph_consts(pb)
        assert set(raw) == set(consts)
        for k in consts:
            np.testing.assert_array_equal(np.asarray(raw[k]), consts[k])
        loaded = reader.load_params(pb)
        assert set(loaded) == set(p)
        for k in p:
            np.testing.assert_array_equal(np.asarray(loaded[k]), p[k])
    # the two writers write the same bytes
    assert (tmp_path / "port_to_jax.pb").read_bytes() == (
        tmp_path / "jax_to_port.pb").read_bytes()
    prefixed = {"deepspeech/" + k: v for k, v in consts.items()}
    np.testing.assert_array_equal(
        pds.params_from_consts(prefixed)["fw_kernel"], p["fw_kernel"])
    del prefixed["deepspeech/h6"]
    with pytest.raises(ValueError, match="h6"):
        pds.params_from_consts(prefixed)


def test_wired_into_feature_extractor(tmp_path):
    """Raw audio -> (N, 16, 29) windows through each side's model, read
    from one frozen graph (deepspeech_features.py:112-180 chain)."""
    p = _jax_params(4, 494, 8, 0.2)
    pb = str(tmp_path / "output_graph.pb")
    pds.save_frozen_graph(pb, pds.consts_from_params(p))
    sr = 16000
    t = np.arange(sr) / sr
    audio = (np.sin(2 * np.pi * 440 * t) * 8000).astype(np.int16)
    got = paudio.extract_deepspeech_features(
        audio, sr, num_frames=25,
        logits_fn=pds.make_logits_fn_from_graph(pb, device="cpu"))
    want = jaudio.extract_deepspeech_features(
        audio, sr, num_frames=25, logits_fn=jds.make_logits_fn_from_graph(pb))
    assert got.shape == (25, 16, 29) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_graph_entry_defaults_to_the_card(tmp_path):
    """Without a device the graph's net goes to cuda: with no card that
    raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pb = str(tmp_path / "g.pb")
    pds.save_frozen_graph(pb, pds.consts_from_params(
        _jax_params(5, 10, 4, 0.3)))
    with pytest.raises((RuntimeError, AssertionError)):
        pds.make_logits_fn_from_graph(pb)
