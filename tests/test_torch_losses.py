"""The port's second-stage losses (``idealnerf_tpu_torch.losses``), LPIPS,
the pixel metrics and the aux nets' bridge against the JAX package:
landmark features (rtol 1e-4, atol 1e-5, and the reference's Python
loop), the heatmap loss and its detector gate, the gram matrix and
FeatureLoss, VGG16's four taps at 24x24 and VGGFace's five at an odd
21x21 (tests/test_vgg.py's rtol 2e-4, atol 2e-5) with their losses, the
torchvision-layout state dicts, the resize against ``jax.image.resize``
(1e-6, shrinking and growing), and a bridge round trip.

The JAX ``make_vgg16_features`` and ``eval.metrics.lpips`` load
torchvision's VGG16; here they are given a stand-in ``torchvision`` module
whose ``vgg16(...).features`` is the port's net, so the JAX package's own
formulas run over the same weights (nothing of the JAX package is
edited)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idealnerf_tpu.losses as jlosses
from idealnerf_tpu.eval import metrics as jmetrics
from idealnerf_tpu.losses import perceptual as jperceptual
from idealnerf_tpu.losses import vgg as jvgg
from idealnerf_tpu.utils import metrics as jpix
from idealnerf_tpu_torch import bridge, losses
from idealnerf_tpu_torch.eval.metrics import lpips
from idealnerf_tpu_torch.eval.video import to8b
from idealnerf_tpu_torch.losses import vgg as pvgg
from idealnerf_tpu_torch.pipeline import fan as pfan
from idealnerf_tpu_torch.utils import metrics as ppix

TAP_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg16():
    return pvgg.init_vgg16(0)


@pytest.fixture
def torchvision_of(monkeypatch):
    """A stand-in ``torchvision`` whose pretrained VGG16 is ``net``."""

    def install(net):
        models = types.SimpleNamespace(
            VGG16_Weights=types.SimpleNamespace(IMAGENET1K_V1=None),
            vgg16=lambda weights=None: types.SimpleNamespace(features=net))
        monkeypatch.setitem(__import__("sys").modules, "torchvision",
                            types.SimpleNamespace(models=models))

    return install


def _images(shape, seed, lo=-1.0):
    return np.random.RandomState(seed).uniform(lo, 1, shape).astype(
        np.float32)


def _np_landmark_features(lms):
    out = [np.sqrt(np.sum((lms[i] - lms[j]) ** 2))
           for i in range(len(lms)) for j in range(i + 1, len(lms))]
    out = np.array(out)
    return out / out.max()


def test_landmark_losses_match_jax():
    """landmark_features against JAX's and the reference loop;
    landmark_feature_loss zero at a match and under scale; the heatmap L1;
    LandmarkLoss without a detector raises."""
    lms = np.random.RandomState(0).rand(68, 2).astype(np.float32) * 100
    got = losses.landmark_features(torch.from_numpy(lms)).numpy()
    assert got.shape == (68 * 67 // 2,)
    np.testing.assert_allclose(
        got, np.asarray(jlosses.landmark_features(jnp.asarray(lms))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _np_landmark_features(lms), rtol=1e-4,
                               atol=1e-5)
    small = torch.from_numpy(lms[:10])
    feats = losses.landmark_features(small)
    assert float(losses.landmark_feature_loss(small, feats)) < 1e-10
    assert float(losses.landmark_feature_loss(small * 3.0, feats)) < 1e-10
    moved = small.clone()
    moved[0] += 5.0
    assert float(losses.landmark_feature_loss(moved, feats)) > 1e-6
    np.testing.assert_allclose(
        float(losses.landmark_feature_loss(moved, feats)),
        float(jlosses.landmark_feature_loss(jnp.asarray(moved.numpy()),
                                            jnp.asarray(feats.numpy()))),
        rtol=1e-4)
    a = torch.zeros(68, 16, 16)
    assert float(losses.heatmap_landmark_loss(a, a + 0.5)) == 0.5
    with pytest.raises(RuntimeError, match="detector"):
        losses.LandmarkLoss()(torch.zeros(8, 8, 3), torch.zeros(8, 8, 3))


def test_gram_and_feature_loss_match_jax():
    f = np.random.RandomState(0).rand(2, 4, 5, 5).astype(np.float32)
    np.testing.assert_allclose(losses.gram_matrix(torch.from_numpy(f)).numpy(),
                               np.asarray(jlosses.gram_matrix(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-7)
    x = np.random.RandomState(1).rand(4, 4, 3).astype(np.float32)

    def fn(img):
        return [np.asarray(img) * 2.0, np.asarray(img) ** 2]

    for dist in ("l2", "l1"):
        got = losses.FeatureLoss(fn, dist=dist)
        want = jlosses.FeatureLoss(fn, dist=dist)
        assert float(got(x, x)) < 1e-12
        np.testing.assert_allclose(float(got(x, x + 0.1)),
                                   float(want(x, x + 0.1)), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.FeatureLoss(fn, dist="cosine")


def test_vgg16_taps_and_loss_match_jax(vgg16):
    """relu1_2 ... relu4_3 of two 24x24 images in [-1, 1] on bridged
    weights, and VGGLOSS between them."""
    x = _images((2, 24, 24, 3), 1)
    want = jax.jit(jvgg.vgg16_features)(bridge.vgg16_to_jax(vgg16),
                                        jnp.asarray(x))
    with torch.no_grad():
        got = losses.vgg16_features(vgg16, torch.from_numpy(x))
        val = losses.make_vgg16_loss(vgg16)(torch.from_numpy(x[:1]),
                                            torch.from_numpy(x[1:]))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TAP_TOL)
    ref = sum(float(jnp.mean((w[0] - w[1]) ** 2)) for w in want)
    np.testing.assert_allclose(float(val), ref, rtol=1e-4)


def test_vggface_taps_and_loss_match_jax_at_an_odd_size():
    """relu1_1 ... relu5_1 at 21x21, where the ceil-mode pools add a row
    and a column, and VGGFaceLoss."""
    net = pvgg.init_vggface(1)
    with torch.no_grad():
        for m in net.children():
            m.weight.mul_(0.5)
            m.bias.normal_(0, 0.01, generator=torch.Generator().manual_seed(2))
    x = _images((2, 21, 21, 3), 3, lo=0.0)
    want = jax.jit(jvgg.vggface_features)(bridge.vggface_to_jax(net),
                                          jnp.asarray(x))
    with torch.no_grad():
        got = losses.vggface_features(net, torch.from_numpy(x))
        val = losses.make_vggface_loss(net)(torch.from_numpy(x[:1]),
                                            torch.from_numpy(x[1:]))
    assert [g.shape[1] for g in got] == [21, 11, 6, 3, 2]
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TAP_TOL)
    ref = sum(float(jnp.mean(jnp.abs(w[0] - w[1]))) for w in want)
    np.testing.assert_allclose(float(val), ref, rtol=1e-4)


def test_torchvision_layout_state_dicts(vgg16, tmp_path):
    """VGG16 takes torchvision's features dict and the whole model's
    (``features.``-prefixed, classifier ignored); VGGFace ignores the fc
    layers; load_vggface reads a saved state dict; a missing conv
    raises."""
    sd = vgg16.state_dict()
    assert set(sd) == {f"{i}.{p}" for i, _, _ in pvgg.VGG16_CONVS
                       for p in ("weight", "bias")}
    whole = {f"features.{k}": v for k, v in sd.items()}
    whole["classifier.0.weight"] = torch.zeros(2, 2)
    other = pvgg.VGG16()
    other.load_state_dict(whole)
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in sd.items())
    with pytest.raises(RuntimeError, match="Missing"):
        other.load_state_dict({k: v for k, v in sd.items() if k != "28.bias"})
    face = pvgg.init_vggface(4)
    fsd = {**face.state_dict(), "fc6.weight": torch.zeros(2, 2)}
    torch.save(fsd, tmp_path / "vgg_face.pth")
    back = losses.load_vggface(str(tmp_path / "vgg_face.pth"))
    assert all(torch.equal(v, back.state_dict()[k])
               for k, v in face.state_dict().items())


def test_vgg16_features_and_lpips_match_jax(vgg16, torchvision_of):
    """Without weights both return None (the JAX package's value here);
    with them, the JAX formulas over the same net: the extractor's taps
    (layers 3, 8, 15, 22) and LPIPS over relu1_2 ... relu5_3 of 20x20
    images."""
    assert losses.make_vgg16_features() is None
    img, ref = _images((20, 20, 3), 5, 0.0), _images((20, 20, 3), 6, 0.0)
    assert lpips(img, ref) is None
    # through relu5_3: a 20x20 image's map is 1x1 there
    torchvision_of(torch.nn.Sequential(*list(vgg16)[:30]))
    want = jperceptual.make_vgg16_features()(img)
    got = losses.make_vgg16_features(vgg16.state_dict())(img)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    d = lpips(img, ref, vgg16)
    np.testing.assert_allclose(d, jmetrics.lpips(img, ref), rtol=1e-5)
    assert d > 0 and lpips(img, img, vgg16) == 0.0


@pytest.mark.parametrize("src,dst", [((300, 280), (256, 256)),
                                     ((24, 24), (64, 64))],
                         ids=["shrink", "grow"])
def test_resize_matches_jax_image_resize(src, dst):
    im = np.random.RandomState(0).rand(*src, 3).astype(np.float32)
    got = pfan.resize_linear(torch.from_numpy(im), dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(im), dst + (3,),
                                       "linear"))
    assert np.abs(got - want).max() <= 1e-6


def test_aux_net_bridge_round_trips(vgg16):
    """fan/vgg16/vggface from JAX params and back give the same arrays;
    the VGG kernels go HWIO <-> OIHW."""
    fan = pfan.init_fan(2, num_modules=1)
    back = bridge.fan_to_jax(bridge.fan_from_jax(fan))
    assert back.keys() == fan.keys()
    assert all(np.array_equal(back[k], fan[k]) for k in fan)
    rng = np.random.RandomState(3)

    def hwio(cfg):
        return {str(name): {"w": rng.randn(3, 3, cin, cout).astype(
            np.float32), "b": rng.randn(cout).astype(np.float32)}
            for name, cin, cout in cfg}

    for to, frm, p in ((bridge.vgg16_to_jax, bridge.vgg16_from_jax,
                        hwio(jvgg._VGG16_CFG)),
                       (bridge.vggface_to_jax, bridge.vggface_from_jax,
                        hwio(jvgg._VGGFACE_CFG))):
        again = to(frm(p))
        assert again.keys() == p.keys()
        for k in p:
            assert np.array_equal(again[k]["w"], np.asarray(p[k]["w"]))
            assert np.array_equal(again[k]["b"], np.asarray(p[k]["b"]))
    assert bridge.vgg16_to_jax(vgg16)["0"]["w"].shape == (3, 3, 3, 64)


def test_pixel_metrics_and_the_exports():
    """img2mse / mse2psnr as JAX's; to8b is eval.video's; the losses
    package exports the JAX one's names but its two torch-dict converters,
    which the nets' load_state_dict replaces."""
    x, y = _images((4, 4, 3), 7, 0.0), _images((4, 4, 3), 8, 0.0)
    mse = ppix.img2mse(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(mse), float(jpix.img2mse(x, y)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ppix.mse2psnr(mse)),
                               float(jpix.mse2psnr(float(mse))), rtol=1e-6)
    assert ppix.to8b is to8b
    np.testing.assert_array_equal(to8b(x), jpix.to8b(x))
    want = {n for n in dir(jlosses) if not n.startswith("_")
            and callable(getattr(jlosses, n))}
    want -= {"vgg16_params_from_torch", "vggface_params_from_torch"}
    assert want <= set(losses.__all__)
