"""The port's 3DMM tracking (``idealnerf_tpu_torch.pipeline.tracking``)
against the JAX package's, mirroring tests/test_rasterizer.py and the
tracker cases of tests/test_pipeline.py.

Tolerances:
- bitwise: ``Face3DMM.synthetic``'s bases and index sets (numpy draws on
  both sides), ``Face3DMM.load`` of one file, the ``bin_faces`` table and
  its overflow count (a stable sort on both sides);
- geometry 1e-5 relative (float32 cos/sin differ in the last bit);
- ``rasterize_soft`` on the sphere and two-triangle meshes: colour within
  1e-3 on the 0-255 scale, alpha within 1e-5, vertex gradients within
  1e-3 norm-relative, against the JAX function run op by op
  (``jax.disable_jit``). Its jitted program fuses the edge distances
  into one loop and rounds one edge pixel of the sphere 4.1e-4 otherwise
  in alpha (1.4e-3 in colour; ROADMAP.md C7); the test holds the port no
  farther from the jitted JAX than the op-by-op JAX is;
- ``_fit_stage``: 50 Adam steps from one start, parameters within 1e-4;
- ``_adam_loop`` against optax's two scheduled Adams: 1e-5; the initial
  photometric loss at steps 50 and 51 (its weight switch): 1e-5
  relative, gradients 3e-3 norm-relative (C7);
- ``_photometric_initial``: 52 steps from one start, across the rates'
  decay and the weights' switch, id / exp / euler / trans within 3e-5,
  texture and light within 3e-3, the last loss within 2e-5 relative
  (ROADMAP.md C9);
- one photometric window step: the loss within 1e-5 relative, each
  leaf's gradient within 1e-3 norm-relative, and the parameters after
  ``_photometric_refine``'s one step within 1e-5;
- ``fit()`` on a synthetic pose recovers it as tests/test_pipeline.py:
  202-226 asserts, and with images its photometric stages cut the render
  error by 5 % as tests/test_rasterizer.py:219-281 asserts.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idealnerf_tpu.pipeline.tracking as jt
import idealnerf_tpu.pipeline.tracking.rasterizer as jr
import idealnerf_tpu_torch.pipeline.tracking as pt
import idealnerf_tpu_torch.pipeline.tracking.rasterizer as pr
from idealnerf_tpu_torch import bridge

GEO = {"rtol": 1e-5, "atol": 1e-6}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# ------------------------------------------------------------- geometry


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    e = (rng.randn(5, 3) * 0.3).astype(np.float32)
    np.testing.assert_allclose(pt.euler2rot(_t(e)).numpy(),
                               np.asarray(jt.euler2rot(jnp.asarray(e))),
                               **GEO)
    np.testing.assert_allclose(pt.euler2rot_np(e), jt.euler2rot_np(e), **GEO)
    # the reference's column-cat layout, rederived (util.py:18-40)
    t, p, s = map(float, e[0])
    rx = np.array([[1, 0, 0], [0, np.cos(t), -np.sin(t)],
                   [0, np.sin(t), np.cos(t)]])
    ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0],
                   [-np.sin(p), 0, np.cos(p)]])
    rz = np.array([[np.cos(s), np.sin(s), 0], [-np.sin(s), np.cos(s), 0],
                   [0, 0, 1]])
    np.testing.assert_allclose(pt.euler2rot_np(e)[0], rx @ ry @ rz,
                               atol=1e-6)
    geo = (rng.randn(5, 30, 3) * 0.5).astype(np.float32)
    tr = np.tile([0.0, 0.0, -7.0], (5, 1)).astype(np.float32)
    np.testing.assert_allclose(
        pt.forward_transform(_t(geo), _t(e), _t(tr), 900.0,
                             (225.0, 200.0)).numpy(),
        np.asarray(jt.forward_transform(jnp.asarray(geo), jnp.asarray(e),
                                        jnp.asarray(tr), 900.0,
                                        (225.0, 200.0))), **GEO)
    series = rng.randn(6, 4, 3).astype(np.float32)
    np.testing.assert_allclose(float(pt.lap_loss(_t(series), 0.5)),
                               float(jt.lap_loss(jnp.asarray(series), 0.5)),
                               rtol=1e-6)
    assert float(pt.lap_loss(_t(series[:2]))) == 0.0
    a, b = rng.randn(3, 68, 2), rng.randn(3, 68, 2)
    np.testing.assert_allclose(float(pt.landmark_loss(_t(a), _t(b))),
                               float(jt.landmark_loss(jnp.asarray(a),
                                                      jnp.asarray(b))),
                               rtol=1e-6)
    verts, tris = _sphere_mesh(6, 8)
    np.testing.assert_allclose(
        pt.compute_tri_normal(_t(verts)[None], tris).numpy(),
        np.asarray(jt.compute_tri_normal(jnp.asarray(verts)[None],
                                         jnp.asarray(tris))), **GEO)


# ----------------------------------------------------------- face model


SYNTHETIC = {
    "default": {},
    "n_vertices": {"n_vertices": 200, "n_id": 8, "n_exp": 4},
    "contours": {"with_contours": True, "seed": 3},
    "shell": {"n_id": 4, "n_exp": 3, "n_lat": 24, "n_lon": 32,
              "shell": True, "with_contours": True, "seed": 1},
    "reference_scale": {"n_id": 100, "n_exp": 79, "n_lat": 150,
                        "n_lon": 230, "shell": True, "with_contours": True,
                        "seed": 5},
}
FIELDS = ("mu", "base_id", "base_exp", "keypoints", "mu_tex", "base_tex",
          "tris", "sig_id", "sig_exp", "left_contour", "right_contour",
          "rigid_ids")


def _np(x):
    if x is None:
        return None
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_model(got, want):
    for f in FIELDS:
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", list(SYNTHETIC))
def test_synthetic_bases_are_bitwise_jax(case):
    got = pt.Face3DMM.synthetic(**SYNTHETIC[case])
    want = jt.Face3DMM.synthetic(**SYNTHETIC[case])
    _same_model(got, want)
    _same_model(bridge.face3dmm_from_jax(want), want)
    if case == "reference_scale":
        assert (got.n_vertices, got.tris.shape[0]) == (34500, 68242)


def test_load_reads_one_file_as_jax_does(tmp_path):
    """The port's save -> both loaders; and the reference's convert_BFM
    layout (mu_shape/b_shape, scaled by 1e-5) in both."""
    model = pt.Face3DMM.synthetic(with_contours=True, seed=2)
    path = str(tmp_path / "a" / "3DMM_info.npy")
    os.makedirs(tmp_path / "a")
    model.save(path)
    _same_model(pt.Face3DMM.load(path), jt.Face3DMM.load(path))
    _same_model(pt.Face3DMM.load(path), model)
    rng = np.random.RandomState(0)
    v = 50
    info = {"mu_shape": rng.randn(3 * v).astype(np.float32) * 1e5,
            "mu_exp": rng.randn(3 * v).astype(np.float32) * 1e4,
            "b_shape": rng.randn(6, 3 * v).astype(np.float32) * 1e3,
            "b_exp": rng.randn(4, 3 * v).astype(np.float32) * 1e3,
            "b_tex": rng.randn(5, 3 * v).astype(np.float32),
            "mu_tex": rng.rand(3 * v).astype(np.float32) * 255,
            "keypoints": rng.choice(v, 68), "sig_shape": rng.rand(6) + 0.5,
            "sig_exp": rng.rand(4) + 0.5, "sig_tex": rng.rand(5) + 0.5}
    path = str(tmp_path / "b" / "3DMM_info.npy")
    os.makedirs(tmp_path / "b")
    np.save(path, info, allow_pickle=True)
    got, want = pt.Face3DMM.load(path), jt.Face3DMM.load(path)
    _same_model(got, want)
    np.testing.assert_array_equal(_np(got.sig_tex), _np(want.sig_tex))


def test_contour_landmarks_match_jax():
    """Contour-aware jaw rows under two poses (facemodel.py:48-90): the
    JAX selection, and the selected x extremal in its candidate ring."""
    jm = jt.Face3DMM.synthetic(with_contours=True, seed=3)
    pm = bridge.face3dmm_from_jax(jm)
    n_id, n_exp = pm.dims
    rng = np.random.RandomState(4)
    idc = (rng.randn(1, n_id) * 0.3).astype(np.float32)
    expc = (rng.randn(2, n_exp) * 0.3).astype(np.float32)
    euler = np.array([[0.0, 0.0, 0.0], [0.0, 0.6, 0.0]], np.float32)
    trans = np.tile([0.0, 0.0, -7.0], (2, 1)).astype(np.float32)
    got = pm.get_3dlandmarks(_t(idc), _t(expc), _t(euler), _t(trans), 300.0,
                             (32.0, 32.0)).numpy()
    want = np.asarray(jm.get_3dlandmarks(
        jnp.asarray(idc), jnp.asarray(expc), jnp.asarray(euler),
        jnp.asarray(trans), 300.0, (32.0, 32.0)))
    np.testing.assert_allclose(got, want, **GEO)
    assert not np.allclose(got[0, :8], got[1, :8])
    geo = pm.geometry_sub(_t(idc), _t(expc), pm.left_contour.reshape(-1))
    px = pt.forward_transform(geo, _t(euler), _t(trans), 300.0,
                              (32.0, 32.0))[..., 0].reshape(2, 8, -1)
    sel = pt.forward_transform(_t(got[:, :8]), _t(euler), _t(trans), 300.0,
                               (32.0, 32.0))[..., 0]
    np.testing.assert_allclose(sel.numpy(), px.amin(-1).numpy(), atol=1e-4)


# ----------------------------------------------------------- rasterizer


def _sphere_mesh(n_lat=12, n_lon=16, radius=1.0):
    """tests/test_rasterizer.py's closed latitude-longitude sphere."""
    phi = np.repeat(np.linspace(0.15, np.pi - 0.15, n_lat), n_lon)
    th = np.tile(np.linspace(0, 2 * np.pi, n_lon, endpoint=False), n_lat)
    verts = radius * np.stack([np.sin(phi) * np.cos(th), np.cos(phi),
                               np.sin(phi) * np.sin(th)], -1)
    i = np.arange(n_lat - 1)[:, None]
    j = np.arange(n_lon)[None, :]
    a = (i * n_lon + j).reshape(-1)
    b = (i * n_lon + (j + 1) % n_lon).reshape(-1)
    c, d = a + n_lon, b + n_lon
    tris = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)],
                    1).reshape(-1, 3)
    return verts.astype(np.float32), tris.astype(np.int32)


def _project(verts, focal, h, w):
    """The tracker's projection (geometry.proj_pts) with depth = -z."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    return np.stack([-focal * x / z + w / 2.0, focal * y / z + h / 2.0, -z],
                    -1).astype(np.float32)


def _cfgs(**kw):
    return pr.RasterConfig(**kw), jr.RasterConfig(**kw)


def _sphere_case():
    verts, tris = _sphere_mesh()
    verts = verts + np.array([0.0, 0.0, -7.0], np.float32)
    colors = np.random.RandomState(0).uniform(
        0, 255, (verts.shape[0], 3)).astype(np.float32)
    return _project(verts, 100.0, 64, 64), tris, colors, dict(height=64,
                                                               width=64)


def _quad_case():
    """tests/test_rasterizer.py's textured two-triangle quad with its soft
    settings."""
    verts = np.array([[-1.0, -1.0, -7.0], [1.0, -1.0, -7.0],
                      [1.0, 1.0, -7.0], [-1.0, 1.0, -7.0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    colors = np.random.RandomState(0).uniform(0, 255, (4, 3)).astype(
        np.float32)
    return _project(verts, 70.0, 48, 48), tris, colors, dict(
        height=48, width=48, sigma=1e-3, gamma=5e-3, blur_radius=4e-3)


@pytest.mark.parametrize("case", ["sphere", "quad"])
def test_rasterize_soft_matches_jax(case):
    vp, tris, colors, kw = (_sphere_case if case == "sphere"
                            else _quad_case)()
    pcfg, jcfg = _cfgs(**kw)
    w = np.random.RandomState(1).randn(kw["height"], kw["width"], 4).astype(
        np.float32)

    def jax_fn(v):
        return jr.rasterize_soft(v, jnp.asarray(tris), jnp.asarray(colors),
                                 jcfg)

    with jax.disable_jit():
        want, vjp = jax.vjp(jax_fn, jnp.asarray(vp))
        (want_g,) = vjp(jnp.asarray(w))
    want = np.asarray(want)
    v = _t(vp).requires_grad_(True)
    got, overflow = pr.rasterize_soft(v, tris, _t(colors), pcfg,
                                      return_overflow=True)
    (got * _t(w)).sum().backward()
    got = got.detach().numpy()
    assert got.shape == want.shape == (kw["height"], kw["width"], 4)
    assert int(overflow) == 0
    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1e-3
    assert np.abs(got[..., 3] - want[..., 3]).max() <= 1e-5
    assert _norm_rel(v.grad.numpy(), want_g) <= 1e-3
    # the jitted JAX program: the port no farther from it than the JAX
    # function's own op-by-op run
    jit = np.asarray(jax.jit(jax_fn)(jnp.asarray(vp)))
    assert np.abs(got - jit).max() <= np.abs(want - jit).max() + 1e-5
    if case == "sphere":
        # the near hemisphere covers the centre, the corners stay empty
        assert got[32, 32, 3] > 0.95 and got[1, 1, 3] < 0.05


def test_two_stacked_triangles_nearer_wins():
    verts = np.array([[10.0, 10.0, 5.0], [50.0, 10.0, 5.0], [30.0, 50.0, 5.0],
                      [10.0, 10.0, 6.0], [50.0, 10.0, 6.0],
                      [30.0, 50.0, 6.0]], np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.array([[255, 0, 0]] * 3 + [[0, 0, 255]] * 3, np.float32)
    pcfg, jcfg = _cfgs(height=64, width=64)
    got = pr.rasterize_soft(_t(verts), tris, _t(colors), pcfg).numpy()
    want = np.asarray(jr.rasterize_soft(jnp.asarray(verts), jnp.asarray(tris),
                                        jnp.asarray(colors), jcfg))
    assert got[25, 30, 0] > 200 and got[25, 30, 2] < 50
    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1e-3
    assert np.abs(got[..., 3] - want[..., 3]).max() <= 1e-5


@pytest.mark.parametrize("cap", [8, 2048])
def test_bin_faces_is_bitwise_jax(cap):
    """A dense shell at 48² in 8-px tiles: the bin table and the overflow
    count (nonzero at capacity 8), which depend on the sort's stability."""
    model = pt.Face3DMM.synthetic(n_id=4, n_exp=3, n_lat=24, n_lon=32,
                                  shell=True, with_contours=True, seed=1)
    geo = model.geometry(torch.zeros(1, 4), torch.zeros(1, 3))[0]
    geo = geo + torch.tensor([0.0, 0.0, -7.0])
    vp = _project(geo.numpy(), 120.0, 48, 48)
    fxy, fz = vp[:, :2][model.tris], vp[:, 2][model.tris]
    pcfg, jcfg = _cfgs(height=48, width=48, tile=8, max_faces_per_tile=cap,
                       span=3)
    pad = 1.7
    got, got_ov = pr.bin_faces(_t(fxy), _t(fz), pcfg, pad)
    want, want_ov = jr.bin_faces(jnp.asarray(fxy), jnp.asarray(fz), jcfg,
                                 pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_ov) == int(want_ov)
    assert (int(got_ov) > 0) == (cap == 8), int(got_ov)


def test_normals_and_sh9_match_jax():
    verts, tris = _sphere_mesh()
    geo = np.stack([verts, verts * 1.1]).astype(np.float32)
    got_n = pr.compute_vertex_normals(_t(geo), tris).numpy()
    want_n = np.asarray(jr.compute_vertex_normals(jnp.asarray(geo),
                                                  jnp.asarray(tris)))
    np.testing.assert_allclose(got_n, want_n, **GEO)
    rng = np.random.RandomState(5)
    tex = rng.uniform(0, 255, geo.shape).astype(np.float32)
    gamma = (rng.randn(2, 27) * 0.2).astype(np.float32)
    # lit colours on the 0-255 scale, the rasterizer's colour bound
    np.testing.assert_allclose(
        pr.sh9_illumination(_t(tex), _t(got_n), _t(gamma)).numpy(),
        np.asarray(jr.sh9_illumination(jnp.asarray(tex), jnp.asarray(got_n),
                                       jnp.asarray(gamma))), rtol=0,
        atol=1e-3)
    # gamma 0: the DC term a0 c0 0.8 (render_3dmm.py:149,161)
    out = pr.sh9_illumination(torch.full((1, 5, 3), 100.0),
                              torch.tensor([0.0, 0.0, 1.0]).expand(1, 5, 3),
                              torch.zeros(1, 27)).numpy()
    np.testing.assert_allclose(out, 100.0 * np.pi / np.sqrt(4 * np.pi) * 0.8,
                               rtol=1e-5)


def test_bfm_config_capacity_scales_with_resolution():
    assert pr.RasterConfig.bfm(450, 450) == jr.RasterConfig.bfm(450, 450)
    assert pr.RasterConfig.bfm(128, 128) == jr.RasterConfig.bfm(128, 128)
    assert pr.RasterConfig.bfm(450, 450).max_faces_per_tile == 256


# -------------------------------------------------------------- tracker


def _pose_case():
    """tests/test_pipeline.py:202-226's synthetic pose: 6 frames of a
    200-vertex model at z -7, seen by a focal-1000 camera at 450²."""
    jm = jt.Face3DMM.synthetic(n_vertices=200, n_id=8, n_exp=4, seed=0)
    rng = np.random.RandomState(1)
    n = 6
    euler = (rng.randn(n, 3) * 0.05).astype(np.float32)
    trans = np.tile([0.0, 0.0, -7.0], (n, 1)).astype(np.float32)
    trans[:, :2] += rng.randn(n, 2) * 0.05
    lan3d = np.asarray(jm.landmarks(jnp.zeros((1, 8)), jnp.zeros((n, 4))))
    gt = np.asarray(jt.forward_transform(
        jnp.asarray(lan3d), jnp.asarray(euler), jnp.asarray(trans), 1000.0,
        (225.0, 225.0)))[..., :2]
    return jm, gt, euler


def test_fit_stage_matches_jax():
    """50 Adam steps of the contour-aware landmark loss with the temporal
    Laplacian on, from one start."""
    jm = jt.Face3DMM.synthetic(with_contours=True, seed=3)
    pm = bridge.face3dmm_from_jax(jm)
    rng = np.random.RandomState(2)
    n = 5
    jtr = jt.FaceTracker(jm, 450, 450)
    ptr = pt.FaceTracker(pm, 450, 450)
    gt = (rng.uniform(150, 300, (n, 68, 2))).astype(np.float32)
    start = {k: np.asarray(v) for k, v in jtr._init_params(n).items()}
    start["euler"] = (rng.randn(n, 3) * 0.05).astype(np.float32)
    want, want_loss = jtr._fit_stage(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(gt),
        900.0, 50, 0.03, 1e-3, 1e-2)
    got, got_loss = ptr._fit_stage({k: _t(v) for k, v in start.items()},
                                   _t(gt), 900.0, 50, 0.03, 1e-3, 1e-2)
    for k in start:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)


def _window_case():
    """Five frames of a 24x32 shell at 48² (two windows of 3, the second
    with its wrapped previous frames), its images rendered from a pose
    the start is perturbed from. They are rendered at the default bin
    capacity unchecked, so about 1,000 (tile, face) pairs drop out of
    them; both sides fit the same images, through renderers whose
    capacity is checked."""
    jm = jt.Face3DMM.synthetic(n_id=4, n_exp=3, n_lat=24, n_lon=32,
                               shell=True, with_contours=True, seed=1)
    pm = bridge.face3dmm_from_jax(jm)
    rng = np.random.RandomState(6)
    n, hw, focal = 5, 48, 120.0
    gt = {"id": (rng.randn(4) * 0.3).astype(np.float32),
          "exp": (rng.randn(n, 3) * 0.3).astype(np.float32),
          "euler": (rng.randn(n, 3) * 0.05).astype(np.float32),
          "trans": np.tile([0.0, 0.0, -7.0], (n, 1)).astype(np.float32)}
    tex = (rng.randn(pm.n_tex) * 0.5).astype(np.float32)
    light = np.zeros((n, 27), np.float32)
    light[:, ::9] = 0.3
    ptr = pt.FaceTracker(pm, hw, hw, focal_candidates=[focal])
    with torch.no_grad():
        r = ptr._make_renderer(focal)
        imgs = ptr._render_window(r, _t(gt["id"]), _t(gt["exp"]),
                                  _t(gt["euler"]), _t(gt["trans"]), _t(tex),
                                  _t(light))[..., :3].numpy()
        lms = pt.forward_transform(
            pm.get_3dlandmarks(_t(gt["id"])[None], _t(gt["exp"]),
                               _t(gt["euler"]), _t(gt["trans"]), focal,
                               ptr.cxy), _t(gt["euler"]), _t(gt["trans"]),
            focal, ptr.cxy)[..., :2].numpy()
    start = dict(gt, exp=gt["exp"] + 0.1,
                 euler=gt["euler"] + np.float32(0.01),
                 trans=gt["trans"] + np.array([0.02, -0.01, 0.05],
                                              np.float32))
    return jm, pm, start, tex, light, imgs, lms, focal, hw


def test_photometric_window_step_matches_jax():
    """The sliding refine's loss and gradient on the second window (its
    previous frames wrapped around the 5-frame clip), the JAX loss
    composed from the JAX tracker's pieces as its _photometric_refine
    composes it, then _photometric_refine's one step on both sides."""
    jm, pm, start, tex, light, imgs, lms, focal, hw = _window_case()
    jtr = jt.FaceTracker(jm, hw, hw, focal_candidates=[focal])
    ptr = pt.FaceTracker(pm, hw, hw, focal_candidates=[focal])
    jren, pren = jtr._make_renderer(focal), ptr._make_renderer(focal)
    rigid = jm.rigid_ids
    ids, pids = np.arange(2, 5), np.arange(-3, 2)
    step = 31     # past the landmark weight's switch
    q = {"exp": start["exp"][ids], "euler": start["euler"][ids],
         "trans": start["trans"][ids], "light": light[ids]}
    pre = {k: start[k][pids] for k in ("exp", "euler", "trans")}
    id_c = start["id"]

    def jax_loss(q):
        proj = jtr._project_landmarks(
            {"id": jnp.asarray(id_c), "exp": q["exp"], "euler": q["euler"],
             "trans": q["trans"]}, focal)
        loss_lan = jt.landmark_loss(proj, jnp.asarray(lms[ids]))
        regexp = jnp.mean(q["exp"] ** 2)
        img = jtr._render_window(jren, jnp.asarray(id_c), q["exp"],
                                 q["euler"], q["trans"], jnp.asarray(tex),
                                 q["light"])
        mask = jax.lax.stop_gradient(img[..., 3]) > 0.0
        loss_col = jt.masked_color_loss(img[..., :3], jnp.asarray(imgs[ids]),
                                        mask)
        exp, euler, trans = (jnp.concatenate([jnp.asarray(pre[k]), q[k]])
                             for k in ("exp", "euler", "trans"))
        geo = jm.geometry_sub(jnp.asarray(id_c)[None], exp, rigid)
        rott = jt.rot_trans_pts(geo, jt.euler2rot(euler), trans)
        loss_lap = jt.lap_loss(rott.reshape(rott.shape[0], -1))
        return 0.5 * loss_col + 1.5 * loss_lan + 1e5 * loss_lap + regexp

    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(
        {k: jnp.asarray(v) for k, v in q.items()})
    leaves = {k: _t(v).requires_grad_(True) for k, v in q.items()}
    got = ptr._window_loss(pren, focal, _t(id_c), _t(tex), rigid, leaves,
                           {k: _t(v) for k, v in pre.items()},
                           _t(imgs[ids]), _t(lms[ids]), step)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in q:
        assert _norm_rel(leaves[k].grad.numpy(), want_g[k]) <= 1e-3, k

    # one step of each side's window loop over both windows
    jp, jl = jtr._photometric_refine(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(tex),
        jnp.asarray(light), imgs, lms, focal, batch=3, steps=1)
    pp, pl = ptr._photometric_refine(
        {k: _t(v) for k, v in start.items()}, _t(tex), _t(light), imgs, lms,
        focal, batch=3, steps=1)
    for k in ("exp", "euler", "trans"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


def test_adam_loop_matches_optax_schedules():
    """_adam_loop's two parameter groups and its decay against the JAX
    tracker's optax chain (tracker.py:190-202): multi_transform of two
    Adams on piecewise_constant_schedule(lr, {50: 0.2}), 60 steps of a
    quadratic whose weight changes after step 50, its minimum farther
    than the steps reach, so no gradient comes near 0.
    Parameters within 1e-5 + 2e-5 relative: each update of about the
    rate is added to values near 6 with one rounding, on each side its
    own (7.2e-6 relative measured after 60); a decay one update late
    moves them 8e-2."""
    import optax

    from idealnerf_tpu_torch.pipeline.tracking.tracker import _adam_loop

    rng = np.random.RandomState(3)
    start = {"p": rng.randn(4).astype(np.float32),
             "t": rng.randn(3, 2).astype(np.float32)}
    target = {k: v + 10.0 for k, v in start.items()}
    scale = {k: rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
             for k, v in start.items()}

    def loss(q, step, xp, to):
        w = xp.where(step > 50, 0.5, 2.0)
        return sum(w * xp.sum(to(scale[k]) * (q[k] - to(target[k])) ** 2)
                   for k in q)

    opt = optax.multi_transform(
        {"p": optax.adam(optax.piecewise_constant_schedule(0.01,
                                                           {50: 0.2})),
         "t": optax.adam(optax.piecewise_constant_schedule(0.1,
                                                           {50: 0.2}))},
        {"p": "p", "t": "t"})
    q = {k: jnp.asarray(v) for k, v in start.items()}
    state = opt.init(q)
    grad = jax.jit(jax.value_and_grad(lambda q, s: loss(q, s, jnp,
                                                         jnp.asarray)))
    for step in range(60):
        want_loss, g = grad(q, step)
        updates, state = opt.update(g, state, q)
        q = optax.apply_updates(q, updates)
    leaves = {k: _t(v).requires_grad_(True) for k, v in start.items()}
    got_loss = _adam_loop(leaves, [(["p"], 0.01), (["t"], 0.1)], 60,
                          lambda step: loss(leaves, torch.tensor(step),
                                            torch, _t), decay_at=50)
    for k in start:
        np.testing.assert_allclose(leaves[k].detach().numpy(),
                                   np.asarray(q[k]), rtol=2e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("step", [50, 51])
def test_initial_photometric_loss_matches_jax(step):
    """_initial_loss, the initial photometric fit's loss, on either side
    of its weight switch (after step 50: landmarks 3 -> 0.05, id 2 -> 1,
    exp 1 -> 0.8), against the JAX tracker's loss_fn (tracker.py:207-225)
    composed from its pieces: the loss within 1e-5 relative, each leaf's
    gradient within 3e-3 norm-relative. After the switch the colour term
    leads the pose's gradient, and the jitted JAX rasterizer's edge
    rounding (ROADMAP.md C7) puts euler's 2.1e-3 from the port's; JAX
    run op by op is 3.8e-6 from it (a minute more of CPU time)."""
    jm, pm, start, tex, light, imgs, lms, focal, hw = _window_case()
    jtr = jt.FaceTracker(jm, hw, hw, focal_candidates=[focal])
    ptr = pt.FaceTracker(pm, hw, hw, focal_candidates=[focal])
    jren, pren = jtr._make_renderer(focal), ptr._make_renderer(focal)
    sel = np.arange(3)
    q = {"id": start["id"], "exp": start["exp"][sel],
         "euler": start["euler"][sel], "trans": start["trans"][sel],
         "tex": tex * 0.5, "light": light[sel] + 0.05}

    def jax_loss(q):
        proj = jtr._project_landmarks(
            {k: q[k] for k in ("id", "exp", "euler", "trans")}, focal)
        loss_lan = jt.landmark_loss(proj, jnp.asarray(lms[sel]))
        regid = jnp.mean(q["id"] ** 2)
        regexp = jnp.mean(q["exp"] ** 2)
        img = jtr._render_window(jren, q["id"], q["exp"], q["euler"],
                                 q["trans"], q["tex"], q["light"])
        mask = jax.lax.stop_gradient(img[..., 3]) > 0.0
        loss_col = jt.masked_color_loss(img[..., :3], jnp.asarray(imgs[sel]),
                                        mask)
        late = step > 50
        return (loss_col + jnp.where(late, 0.05, 3.0) * loss_lan
                + jnp.where(late, 1.0, 2.0) * regid
                + jnp.where(late, 0.8, 1.0) * regexp)

    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(
        {k: jnp.asarray(v) for k, v in q.items()})
    leaves = {k: _t(v).requires_grad_(True) for k, v in q.items()}
    got = ptr._initial_loss(pren, focal, leaves, _t(imgs[sel]),
                            _t(lms[sel]), step)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in q:
        assert _norm_rel(leaves[k].grad.numpy(), want_g[k]) <= 3e-3, k


class _LossLog:
    """Stands in for a tracker module's logger and keeps the loss that
    ``_photometric_initial`` logs."""

    def __init__(self):
        self.losses = []

    def info(self, msg, *args):
        if msg.startswith("photometric initial"):
            self.losses.append(args[0])

    def warning(self, *args):
        pass


def test_photometric_initial_matches_jax(monkeypatch):
    """_photometric_initial on both sides from one start: a batch of 3 of
    the window case's 5 frames and 52 steps, so that the run crosses the
    rates' 0.2 decay (from the update of 0-based count 50, both groups)
    and the loss weights' switch (step > 50), on 8-px tiles (the same
    image as the default 16-px ones, at less than half the CPU time).
    id, exp, euler and trans, written back through the frame batch,
    within 3e-5 (1.9e-5 measured, trans z at -7); the texture and the
    averaged light within 3e-3 (6.3e-4 and 1.4e-3 measured): their rate
    is 0.1, and Adam's first steps carry the rasterizer's ~1e-3 gradient
    difference from the jitted JAX (ROADMAP.md C7, C9) into them. A
    decay one update late moves them 1.8e-2 and the pose 9e-4, a weight
    switch one step early the pose 1.2e-4. The last step's loss within
    2e-5 relative (8.0e-6 measured)."""
    import idealnerf_tpu.pipeline.tracking.tracker as jtrk
    import idealnerf_tpu_torch.pipeline.tracking.tracker as ptrk

    jm, pm, start, _, _, imgs, lms, focal, hw = _window_case()
    logs = _LossLog(), _LossLog()
    monkeypatch.setattr(jtrk, "logger", logs[0])
    monkeypatch.setattr(ptrk, "logger", logs[1])
    tiles = dict(height=hw, width=hw, tile=8, max_faces_per_tile=256,
                 span=3)
    jtr = jt.FaceTracker(jm, hw, hw, focal_candidates=[focal],
                         raster_cfg=jr.RasterConfig(**tiles))
    ptr = pt.FaceTracker(pm, hw, hw, focal_candidates=[focal],
                         raster_cfg=pr.RasterConfig(**tiles))
    jp, jtex, jl = jtr._photometric_initial(
        {k: jnp.asarray(v) for k, v in start.items()}, imgs, lms, focal,
        batch=3, steps=52)
    pp, ptex, pl = ptr._photometric_initial(
        {k: _t(v) for k, v in start.items()}, imgs, lms, focal, batch=3,
        steps=52)
    for k in start:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=3e-5, err_msg=k)
    np.testing.assert_allclose(ptex.numpy(), np.asarray(jtex), rtol=0,
                               atol=3e-3)
    assert pl.shape == (5, 27)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=3e-3)
    # the frames outside the batch keep their start
    for k in ("exp", "euler", "trans"):
        np.testing.assert_array_equal(pp[k].numpy()[3:], start[k][3:])
    (want,), (got,) = logs[0].losses, logs[1].losses
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_photometric_stages_cut_the_render_error():
    """tests/test_rasterizer.py:219-281 on the port: ground truth rendered
    from a synthetic 3DMM with texture and light, landmarks with 2 px of
    noise; fit(images=...) runs the photometric stages after the landmark
    ones and must cut the render error (both fits rendered with the true
    texture and light) by at least 5 %, with the texture and a light per
    frame returned. 8-px tiles: the same images as the default 16-px
    ones, at two thirds of the CPU time."""
    rng = np.random.RandomState(0)
    model = pt.Face3DMM.synthetic(with_contours=True, seed=5, device="cpu")
    n_id, n_exp = model.dims
    n, hw, focal = 4, 64, 100.0

    def smooth(a, b):
        s = np.linspace(0.0, 1.0, n)[:, None]
        return _t((1 - s) * a + s * b)

    gt = {"id": _t(rng.randn(n_id) * 0.3),
          "exp": smooth(rng.randn(n_exp) * 0.3, rng.randn(n_exp) * 0.3),
          "euler": smooth(rng.uniform(-0.12, 0.12, 3),
                          rng.uniform(-0.12, 0.12, 3)),
          "trans": _t([0.0, 0.0, -7.0]) + smooth(
              rng.uniform(-0.08, 0.08, 3), rng.uniform(-0.08, 0.08, 3))}
    tex_gt = _t(rng.randn(model.n_tex) * 0.5)
    light_gt = torch.zeros(n, 27)
    light_gt[:, ::9] += 0.3
    cfg = pr.RasterConfig(height=hw, width=hw, tile=8)
    renderer = pr.Render3DMM(focal, hw, hw, model.tris, cfg)

    @torch.no_grad()
    def render(id_c, exp, euler, trans):
        geo = model.geometry(_t(id_c)[None], _t(exp))
        rott = pt.rot_trans_pts(geo, pt.euler2rot(_t(euler)), _t(trans))
        texture = model.texture(tex_gt[None]).expand(geo.shape)
        return renderer(rott, texture, light_gt)[..., :3]

    gt_imgs = render(gt["id"], gt["exp"], gt["euler"], gt["trans"])
    with torch.no_grad():
        lan3d = model.get_3dlandmarks(gt["id"][None], gt["exp"],
                                      gt["euler"], gt["trans"], focal,
                                      (hw / 2, hw / 2))
        lms = pt.forward_transform(lan3d, gt["euler"], gt["trans"], focal,
                                   (hw / 2, hw / 2))[..., :2].numpy()
    lms_noisy = lms + rng.randn(*lms.shape).astype(np.float32) * 2.0

    def render_err(res):
        img = render(res.id_coef, res.exp, res.euler, res.trans)
        return float(torch.mean((img - gt_imgs) ** 2))

    tracker = pt.FaceTracker(model, hw, hw, focal_candidates=[focal],
                             raster_cfg=cfg)
    base = tracker.fit(lms_noisy, steps_focal=1, steps_global=300,
                       steps_refine=100)
    refined = tracker.fit(lms_noisy, images=gt_imgs.numpy(), steps_focal=1,
                          steps_global=300, steps_refine=100,
                          photo_batch=4, photo_steps=40,
                          photo_refine_steps=25)
    e_base, e_ref = render_err(base), render_err(refined)
    assert refined.tex is not None and refined.light is not None
    assert refined.light.shape == (n, 27)
    assert e_ref < e_base * 0.95, (
        f"photometric should cut render error: {e_base} -> {e_ref}")


def test_renderer_bumps_capacity_on_overflow():
    """_renderer_checked raises an undersized capacity until a probe frame
    renders without overflow, to the capacity JAX's picks."""
    jm = jt.Face3DMM.synthetic(n_id=4, n_exp=3, n_lat=24, n_lon=32,
                               shell=True, with_contours=True, seed=1)
    tiny = dict(height=48, width=48, tile=8, max_faces_per_tile=8, span=3)
    caps = []
    for mod, model, cfg, arr in (
            (pt, bridge.face3dmm_from_jax(jm), pr.RasterConfig(**tiny), _t),
            (jt, jm, jr.RasterConfig(**tiny), jnp.asarray)):
        tracker = mod.FaceTracker(model, 48, 48, focal_candidates=[120.0],
                                  raster_cfg=cfg)
        r = tracker._renderer_checked(
            120.0, arr(np.zeros(4)), arr(np.zeros((2, 3))),
            arr(np.zeros((2, 3))), arr(np.tile([0.0, 0.0, -7.0], (2, 1))),
            arr(np.zeros(model.n_tex)), arr(np.zeros((1, 27))))
        caps.append(r.cfg.max_faces_per_tile)
    assert caps[0] == caps[1] > 8


def test_fit_recovers_the_synthetic_pose():
    """tests/test_pipeline.py:202-226 on the port: the focal, a
    reprojection loss under 2 and the euler angles within 0.05."""
    jm, gt, euler = _pose_case()
    tracker = pt.FaceTracker(bridge.face3dmm_from_jax(jm), 450, 450,
                             focal_candidates=[800, 1000, 1200])
    res = tracker.fit(gt, steps_focal=150, steps_global=500,
                      steps_refine=100, lap_weight=0.0)
    assert res.focal == 1000.0, res.focal
    assert res.loss < 2.0, res.loss
    np.testing.assert_allclose(res.euler, euler, atol=0.05)


def test_track_bench_smoke(tmp_path):
    """The port's track_bench at its CPU size: zero overflow, finite
    times, its JSON written."""
    from idealnerf_tpu_torch.scripts import track_bench

    out = str(tmp_path / "track_bench.json")
    res = track_bench.main(["--device", "cpu", "--smoke", "--out", out])
    assert res["overflow"] == 0 and res["hw"] == 96
    assert res["vertices"] == 300 and res["tris"] == 560
    assert all(np.isfinite(res[k]) and res[k] > 0 for k in (
        "raster_forward_s", "photometric_window_1step_s",
        "s_per_photometric_step"))
    with open(out) as fh:
        assert json.load(fh) == res


def test_photo_spread_smoke(tmp_path):
    """scripts.photo_spread at its CPU size: the reference run against
    itself at one thread and from a perturbed start, its JSON written."""
    from idealnerf_tpu_torch.scripts import photo_spread

    out = str(tmp_path / "spread.json")
    res = photo_spread.main(["--device", "cpu", "--smoke", "--threads",
                             "1", "--out", out])
    assert res["steps"] == 3 and set(res["runs"]) == {
        "host_1_threads", "host_start_x(1+1e-06)"}
    for gap in res["runs"].values():
        assert np.isfinite(gap["pose"]) and np.isfinite(gap["tex_light"])
        assert gap["first_mask_step"] is None or gap["first_mask_step"] >= 0
    with open(out) as fh:
        assert json.load(fh) == res
