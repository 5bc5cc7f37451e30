"""The depth-band probes of the PyTorch port against the JAX package:
``subject_depth_range`` and ``torso_depth_range`` on the same bridged
weights and subject (the plain frame, f32 on both sides), and
``cached_depth_band``'s file, which both packages read and write alike.

The probe brackets sample depths of the foreground rays' 2 %/98 % weight
quantiles; both sides render the same f32 field, and the bands are held
to 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.eval import renderer as jr
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.eval import renderer as pr
from idealnerf_tpu_torch.train.state import init_params
from idealnerf_tpu_torch.train.torso import init_torso_params

SMALL = dict(dim_aud=32, dim_expr=8, dim_latent=4, dim_aud_body=16,
             netdepth=4, netwidth=32, N_samples=8, N_importance=8,
             density_activation="softplus")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def subject():
    cfg, jcfg = ExperimentConfig(**SMALL), JaxConfig(**SMALL)
    ds = make_synthetic_dataset(n_frames=3, H=24, W=24, dim_expr=8,
                                with_torso=True)
    st = init_params(cfg, ds.size, torch.Generator().manual_seed(0))
    torso = init_torso_params(cfg, torch.Generator().manual_seed(1))
    return dict(cfg=cfg, jcfg=jcfg, ds=ds, st=st, torso=torso,
                jparams=jax.tree.map(jnp.asarray,
                                     bridge.params_to_jax(st.params)),
                jtorso=jax.tree.map(jnp.asarray,
                                    bridge.torso_params_to_jax(torso)),
                jlatent=jnp.asarray(st.latent_codes.detach().numpy()))


def test_subject_depth_range_matches_jax(subject):
    """Without the margin the band is the bracket of sample depths itself
    (the random field's padded band covers [near, far]); with it, that
    bracket padded by 5 % of the interval and clipped."""
    s = subject
    ds = s["ds"]
    args = (s["st"].params, s["st"].latent_codes, ds)
    got = pr.subject_depth_range(s["cfg"], *args, n_frames=2,
                                 margin_frac=0.0)
    want = jr.subject_depth_range(s["jcfg"], s["jparams"], s["jlatent"],
                                  ds, n_frames=2, margin_frac=0.0)
    assert ds.near < got[0] < got[1] < ds.far, got
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pad = 0.05 * (ds.far - ds.near)
    padded = pr.subject_depth_range(s["cfg"], *args, n_frames=2)
    assert padded == (max(ds.near, got[0] - pad), min(ds.far, got[1] + pad))
    np.testing.assert_allclose(padded, jr.subject_depth_range(
        s["jcfg"], s["jparams"], s["jlatent"], ds, n_frames=2), atol=1e-5)


def test_torso_depth_range_matches_jax(subject):
    s = subject
    ds = s["ds"]
    got = pr.torso_depth_range(s["cfg"], s["torso"], s["st"].params, ds,
                               n_frames=2, margin_frac=0.0)
    want = jr.torso_depth_range(s["jcfg"], s["jtorso"], s["jparams"], ds,
                                n_frames=2, margin_frac=0.0)
    assert ds.near < got[0] < got[1] < ds.far, got
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_no_foreground_falls_back_to_the_config_bounds(subject):
    s = subject
    ds = s["ds"]
    got = pr.subject_depth_range(s["cfg"], s["st"].params,
                                 s["st"].latent_codes, ds, n_frames=1,
                                 fg_thresh=2.0)
    assert got == (float(ds.near), float(ds.far))


def test_cached_depth_band_reads_and_writes_as_jax(tmp_path):
    """The port writes depth_bands.json with the JAX package's keys, which
    the JAX function reads without probing, and reads JAX's file the same
    way; a second call does not probe; another step or field does;
    cache_dir=None always does."""
    calls = []

    def probe(band):
        def fn():
            calls.append(band)
            return band
        return fn

    def never():
        raise AssertionError("probed despite a cached band")

    d = str(tmp_path)
    assert pr.cached_depth_band(d, "head", 100, probe((0.5, 1.25))) == (
        0.5, 1.25)
    assert pr.cached_depth_band(d, "head", 100, never) == (0.5, 1.25)
    assert jr.cached_depth_band(d, "head", 100, never) == (0.5, 1.25)
    assert json.loads((tmp_path / "depth_bands.json").read_text()) == {
        "head@100": [0.5, 1.25]}
    # JAX writes a torso band; the port reads it
    jr.cached_depth_band(d, "torso", 100, lambda: (jnp.asarray(0.6),
                                                   jnp.asarray(1.1)))
    got = pr.cached_depth_band(d, "torso", 100, never)
    np.testing.assert_allclose(got, (0.6, 1.1), rtol=1e-7)
    pr.cached_depth_band(d, "head", 200, probe((0.4, 0.9)))
    assert calls == [(0.5, 1.25), (0.4, 0.9)]
    assert sorted(json.loads((tmp_path / "depth_bands.json").read_text())
                  ) == ["head@100", "head@200", "torso@100"]
    assert not list(tmp_path.glob("*.tmp"))
    pr.cached_depth_band(None, "head", 100, probe((0.5, 1.25)))
    assert len(calls) == 3
