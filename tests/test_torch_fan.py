"""The port's FAN (``idealnerf_tpu_torch.pipeline.fan``) against the JAX
package's: the state-dict names of ``init_fan``, the heatmap stacks of a
two-stack net (tests/test_fan.py:170's tolerance, atol 2e-3, rtol 1e-3),
the landmark decode on seeded heatmaps, ``detect_landmarks`` on a box
larger than the crop (a shrinking, antialiased resize), the batch norm as
an affine on trainable statistics, and the heatmap loss's gradient.

Small sizes keep the JAX side cheap: 64x64 inputs, its module-level
``NUM_MODULES``, ``CROP_SIZE`` and ``HEATMAP_SIZE`` monkeypatched as its
own tests patch the first (the JAX package is not edited), the port's
``CROP_SIZE`` patched to match, and its
``apply_fan`` jitted once for the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idealnerf_tpu.pipeline.fan as jfan
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.pipeline import fan as pfan

MODULES, CROP = 2, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """One two-stack FAN on both sides (the JAX dict and the port's
    module), and the JAX forward jitted once. Its weights are drawn as
    tests/test_fan.py::test_activation_match_vs_torch draws its torch
    net's, whose scale its tolerance was set for: torch's default conv
    init from seed 0, unit BN scales, seeded running statistics."""
    torch.manual_seed(0)
    net = pfan.FAN(MODULES)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    return bridge.fan_to_jax(net), net, jax.jit(jfan.apply_fan)


@pytest.fixture
def jax_small(monkeypatch, nets):
    monkeypatch.setattr(jfan, "NUM_MODULES", MODULES)
    monkeypatch.setattr(jfan, "CROP_SIZE", CROP)
    monkeypatch.setattr(pfan, "CROP_SIZE", CROP)
    monkeypatch.setattr(jfan, "HEATMAP_SIZE", CROP // 4)
    monkeypatch.setattr(jfan, "apply_fan", nets[2])


def test_init_fan_is_the_jax_structure_and_loads_as_it_is():
    """The port's init_fan has the JAX init_fan's names and shapes; the
    stack count comes from the dict; a released dict's
    num_batches_tracked entries are dropped; the seed fixes the draws."""
    want = jfan.init_fan(jax.random.PRNGKey(0), num_modules=3)
    got = pfan.init_fan(0, num_modules=3)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    net = pfan.FAN.from_state_dict(want)
    assert net.num_modules == 3 and set(net.state_dict()) == set(want)
    released = {k: torch.from_numpy(v) for k, v in want.items()}
    released["bn1.num_batches_tracked"] = torch.tensor(7)
    net.load_state_dict(released)
    for k, v in net.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k
    again = pfan.init_fan(np.random.RandomState(0), num_modules=3)
    assert all(np.array_equal(again[k], got[k]) for k in got)


def test_heatmaps_match_jax(nets, jax_small):
    """Both stacks' heatmaps of a 64x64 input, the second fed through the
    bl/al paths."""
    params, net, apply = nets
    x = np.random.RandomState(2).rand(1, 3, CROP, CROP).astype(np.float32)
    want = apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == MODULES
    for g, w in zip(got, want):
        assert g.shape == (1, 68, CROP // 4, CROP // 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3,
                                   rtol=1e-3)


def test_landmark_decode_matches_jax():
    """heatmaps_to_landmarks (argmax, +-0.25 toward the stronger
    neighbour, edges clamped) and soft_landmarks on seeded heatmaps."""
    hm = np.random.RandomState(3).randn(2, 68, 16, 16).astype(np.float32)
    hm[0, 0, 0, 0] = hm[1, 1, 15, 15] = 9.0  # argmax at both corners
    got = pfan.heatmaps_to_landmarks(torch.from_numpy(hm)).numpy()
    want = np.asarray(jfan.heatmaps_to_landmarks(jnp.asarray(hm)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        pfan.soft_landmarks(torch.from_numpy(hm)).numpy(),
        np.asarray(jfan.soft_landmarks(jnp.asarray(hm))), rtol=1e-5,
        atol=1e-5)


def test_detect_landmarks_matches_jax(nets, jax_small):
    """A 300x290 face box of a 320x330 frame, shrunk to the crop: the
    landmarks in image pixels as JAX's."""
    params, net, _ = nets
    image = np.random.RandomState(4).randint(0, 256, (320, 330, 3),
                                             dtype=np.uint8)
    box = np.array([20, 10, 320, 300])
    want = jfan.detect_landmarks(params, image, box)
    got = pfan.detect_landmarks(net, image, box)
    assert got.shape == (68, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_batch_norm_is_an_affine_on_trainable_statistics():
    """In train mode as in eval mode the BN normalises with its stored
    statistics, and those get gradients (the JAX proxy trainer updates
    every leaf of the dict)."""
    bn = pfan.StatBN(4)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        bn.running_var.copy_(torch.tensor([1.5, 0.5, 2.0, 1.0]))
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    y = bn.train()(x)
    assert torch.equal(y, bn.eval()(x))
    want = jfan._bn({k: jnp.asarray(v.detach().numpy())
                     for k, v in {"b.weight": bn.weight, "b.bias": bn.bias,
                                  "b.running_mean": bn.running_mean,
                                  "b.running_var": bn.running_var}.items()},
                    "b", jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    y.sum().backward()
    assert all(float(p.grad.abs().max()) > 0 for p in bn.parameters())


def test_heatmap_loss_differentiable():
    """tests/test_fan.py::test_heatmap_loss_differentiable on the port: the
    gradient of the heatmap L1 with respect to the image is finite and not
    zero (a one-stack net at 64x64)."""
    net = pfan.FAN.from_state_dict(pfan.init_fan(1, num_modules=1))
    net.requires_grad_(False)
    x = torch.rand(1, 3, CROP, CROP, requires_grad=True,
                   generator=torch.Generator().manual_seed(1))
    torch.mean(torch.abs(net(x)[-1])).backward()
    assert bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().max()) > 0
