"""The port's BiSeNet (``idealnerf_tpu_torch.pipeline.parsing_net``)
against the JAX package's, mirroring tests/test_parsing_net.py: the
state-dict names and ``init_bisenet``'s draws (bitwise), the three heads'
logits at 64² (atol 2e-3, rtol 1e-3, tests/test_parsing_net.py:68's
bound, on the weights that test draws: init_bisenet's He-scaled ones give
logits near 600, whose f32 error passes 2e-3 where they cross zero), the
upsamplings' index arithmetic (bitwise), and ``parse_image``'s class map,
equal wherever the two largest logits differ by more than 1e-3 (a tie
within the logits' error can take either class)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idealnerf_tpu.pipeline.parsing_net as jparse
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.pipeline import parsing_net as pparse

TOL = {"atol": 2e-3, "rtol": 1e-3}
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apply_jit():
    return jax.jit(jparse.apply_bisenet)


def _torch_init_params():
    """tests/test_parsing_net.py's activation-test weights: torch's default
    conv init from seed 0, seeded running statistics."""
    torch.manual_seed(0)
    net = pparse.BiSeNet()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    return bridge.bisenet_to_jax(net)


def _seeded_params():
    """``init_bisenet`` from JAX's key 0 (He-scaled, large logits)."""
    key = jax.random.PRNGKey(0)
    return pparse.init_bisenet(int(jax.random.randint(key, (), 0,
                                                      2 ** 31 - 1)))


def test_init_bisenet_is_the_jax_structure_and_draws():
    """The names are the reference's state-dict names on both sides; an
    int seed gives the JAX draws of the key that maps to it; a released
    dict with num_batches_tracked loads as it is."""
    key = jax.random.PRNGKey(0)
    want = jparse.init_bisenet(key)
    got = _seeded_params()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    net = bridge.bisenet_from_jax(got)
    assert set(net.state_dict()) == set(want)
    released = {k: torch.from_numpy(v) for k, v in got.items()}
    released["cp.resnet.bn1.num_batches_tracked"] = torch.tensor(3)
    net.load_state_dict(released)
    back = bridge.bisenet_to_jax(net)
    assert all(np.array_equal(back[k], got[k]) for k in got)


def test_logits_match_jax(apply_jit):
    params = _torch_init_params()
    net = bridge.bisenet_from_jax(params)
    x = np.random.RandomState(2).randn(1, 3, 64, 64).astype(np.float32)
    want = apply_jit({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (1, 19, 64, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((7, 5), (13, 20)),
                                     ((32, 16), (16, 8)), ((1, 6), (4, 6))])
def test_upsampling_index_arithmetic_is_bitwise_jax(src, dst):
    x = np.random.RandomState(3).randn(1, 2, *src).astype(np.float32)
    for p_fn, j_fn in ((pparse._interp_nearest, jparse._interp_nearest),
                       (pparse._interp_bilinear_ac,
                        jparse._interp_bilinear_ac)):
        got = p_fn(torch.from_numpy(x), dst).numpy()
        want = np.asarray(j_fn(jnp.asarray(x), dst))
        np.testing.assert_array_equal(got, want)


def test_parse_image_matches_jax(monkeypatch, apply_jit):
    """A 96x80 frame through the protocol at a 64² inference size: the
    shrinking antialiased resize, normalization, argmax and nearest
    upsample back."""
    monkeypatch.setattr(jparse, "apply_bisenet", apply_jit)
    params = _torch_init_params()
    net = bridge.bisenet_from_jax(params)
    img = (np.random.RandomState(1).rand(96, 80, 3) * 255).astype(np.uint8)
    got = pparse.parse_image(net, img, infer_size=64)
    want = jparse.parse_image({k: jnp.asarray(v) for k, v in params.items()},
                              img, infer_size=64)
    assert got.shape == want.shape == (96, 80)
    assert got.min() >= 0 and got.max() < 19
    top2 = torch.topk(pparse.parse_logits(net, img, 64), 2, dim=0).values
    clear = (top2[0] - top2[1] > MARGIN).numpy()
    rows = np.floor(np.arange(96, dtype=np.float32) * (64 / 96)).astype(int)
    cols = np.floor(np.arange(80, dtype=np.float32) * (64 / 80)).astype(int)
    clear = clear[rows][:, cols]
    assert clear.mean() > 0.9   # the comparison covers most of the frame
    np.testing.assert_array_equal(got[clear], want[clear])
    # the module's inference size is read at call time
    monkeypatch.setattr(pparse, "INFER_SIZE", 32)
    assert pparse.parse_logits(net, img).shape == (19, 32, 32)
