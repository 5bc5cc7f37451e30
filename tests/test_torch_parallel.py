"""The port's multi-device layer (idealnerf_tpu_torch/parallel/) against
the JAX package's on the conftest's 8-device CPU mesh, and against the
port's own single-device paths, on gloo ranks of the CPU.

Each mesh shape is spawned once a module (``torch_parallel_ranks.run``:
the ranks build their inputs from seeds and return CPU tensors), under a
join timeout of its own (``parallel.launch``'s ``timeout``).

Tolerances:
- sharded frames, composites and videos against the JAX package's
  ``make_sharded_*``: 3e-2 plus a correlation above 0.999, the bound of
  the port's single-device frame tests (the port's frame route rounds to
  bf16 as its kernels do; JAX's sharded renderers are unfused f32);
  against the port's single-device frame: 1e-6 (each ray is the same
  computation on fewer rows);
- the sharded head step on fixed coords against ``jax.value_and_grad`` of
  the frame-averaged JAX ``make_frame_loss``: loss 1e-5 relative,
  gradients 1e-4 norm-relative per leaf, latent gradients rtol 1e-4
  (``test_torch_train.py::test_train_steps_match_jax``'s);
- the distributed steps against the port's single-device steps on the
  same draws: loss 1e-6 relative, gradients 1e-5 norm-relative per
  tensor, before any update (each rank sums half the rays; Adam's first
  update is g/|g|, so the updates are not held);
- ranks after training: bitwise equal parameters.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks as R
from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_sharded_composite_renderer as jax_composite,
    make_sharded_composite_video_renderer as jax_composite_video,
    make_sharded_frame_renderer as jax_frame,
    make_sharded_video_renderer as jax_video,
)
from idealnerf_tpu.train.head import make_frame_loss as jax_frame_loss
from idealnerf_tpu.train.torso import torso_nerf_config as jax_torso_config
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.core.render import (
    RenderConfig, render_draws, render_rays,
)
from idealnerf_tpu_torch.core.sampling import Replay
from idealnerf_tpu_torch.eval.renderer import (
    make_composite_frame_renderer, make_frame_renderer,
)
from idealnerf_tpu_torch.parallel import launch, mesh_shape
from idealnerf_tpu_torch.parallel.dryrun import dryrun_multichip
from idealnerf_tpu_torch.parallel.mesh import Mesh
from idealnerf_tpu_torch.parallel.sharded import (
    make_sharded_frame_renderer, make_sharded_video_renderer, tile_rows,
)
from idealnerf_tpu_torch.train.head import make_frame_loss, make_head_sampler
from idealnerf_tpu_torch.train.second_stage import make_second_stage_loss
from idealnerf_tpu_torch.train.torso import (
    make_torso_frame_loss, make_torso_sampler, torso_nerf_config,
)

TIMEOUT = 180  # seconds a spawned mesh may take, well past its ~10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensor ops on one thread: under the suite's parallel workers
    a thread pool per op made such tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(n_data, n_ray, checks):
    n, tf32 = torch.get_num_threads(), torch.backends.cudnn.allow_tf32
    torch.set_num_threads(1)  # each rank then takes one thread
    # off its default, to see the ranks take it (no effect on the CPU)
    torch.backends.cudnn.allow_tf32 = False
    try:
        return launch(R.run, n_data, n_ray, device="cpu", args=(checks,),
                      timeout=TIMEOUT)
    finally:
        torch.set_num_threads(n)
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.fixture(scope="module")
def mesh_1x2():
    return _spawn(1, 2, [
        ("frames", "frames", {}),
        ("fixed", "head_grads", {"indices": [1], "with_draws": False}),
        ("drawn", "head_grads", {"indices": [1], "with_draws": True}),
        ("torso", "torso_grads", {"indices": [2]}),
        ("crop", "second_stage_grads", {"tile": 48}),
        ("bad_mesh", "bad_mesh", {}),
    ])


@pytest.fixture(scope="module")
def mesh_2x1():
    return _spawn(2, 1, [
        ("fixed", "head_grads", {"indices": [0, 2], "with_draws": False}),
        ("drawn", "head_grads", {"indices": [0, 2], "with_draws": True}),
        ("torso", "torso_grads", {"indices": [1, 3]}),
    ])


@pytest.fixture(scope="module")
def mesh_2x2():
    return _spawn(2, 2, [
        ("frames", "frames", {}),
        ("fixed", "head_grads", {"indices": [0, 1, 2, 3],
                                 "with_draws": False}),
        ("drawn", "head_grads", {"indices": [0, 1], "with_draws": True}),
        ("remat", "head_grads", {"indices": [0, 1], "with_draws": True,
                                 "remat": True}),
        ("trainer", "trainer_params", {}),
    ])


@pytest.fixture
def meshes(request, mesh_1x2, mesh_2x1, mesh_2x2):
    return {"1x2": mesh_1x2, "2x1": mesh_2x1, "2x2": mesh_2x2}


def _agree(got, want, atol=3e-2):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol)
    c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert c > 0.999, c


def _render_inputs():
    cfg = ExperimentConfig(**R.RENDER)
    ds = R.dataset(with_torso=True)
    head = R.head_state(cfg).params
    torso = R.torso_params(cfg)
    auds, exprs, lats = R.conditioning(cfg, R.N_FRAMES)
    from idealnerf_tpu_torch.train.torso import torso_signal

    poses = torch.from_numpy(ds.poses)
    sigs = torch.stack([torso_signal(auds[i], poses[i], cfg.dim_aud_body)
                        for i in range(R.N_FRAMES)])
    bc = torch.from_numpy(ds.bc_img).float() / 255.0
    return cfg, ds, head, torso, poses, bc, auds, exprs, lats, sigs


def _jax_view(ds, jcfg, mesh):
    return dict(mesh=mesh, H=R.HW, W=R.HW, focal=ds.focal, near=ds.near,
                far=ds.far, render_cfg=jcfg.render_config(), cx=ds.cx,
                cy=ds.cy, tile=R.TILE)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_sharded_frame_and_composite_match_jax_and_one_device(meshes, shape):
    """Every rank holds the whole frame: the JAX package's ray-sharded
    frame and composite on a mesh with the same 'ray' axis, and the port's
    single-device frame and composite, ray for ray."""
    ranks = meshes[shape]
    cfg, ds, head, torso, poses, bc, auds, exprs, lats, sigs = (
        _render_inputs())
    jcfg = JaxConfig(**R.RENDER)
    n_data, n_ray = map(int, shape.split("x"))
    jmesh = jax_make_mesh(n_data=n_data, n_ray=n_ray,
                          devices=jax.devices()[:n_data * n_ray])
    jhead = jax.tree.map(jnp.asarray, bridge.params_to_jax(head))
    jtorso = jax.tree.map(jnp.asarray, bridge.torso_params_to_jax(torso))
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    view = _jax_view(ds, jcfg, jmesh)
    ref = jax_frame(jcfg.face_nerf_config(), **view)(
        jhead, j(poses[1]), j(bc), j(auds[1]), j(exprs[1]), j(lats[1]))
    ref_c = jax_composite(jcfg.face_nerf_config(), jax_torso_config(jcfg),
                          **view)(
        jhead, jtorso, j(poses[1]), j(poses[0]), j(bc), j(auds[1]),
        j(sigs[1]), j(exprs[1]), j(lats[1]))
    args = (R.HW, R.HW, ds.focal, ds.near, ds.far, cfg.render_config())
    one = make_frame_renderer(cfg.face_nerf_config(), *args, cx=ds.cx,
                              cy=ds.cy)(head, poses[1], bc, auds[1], exprs[1],
                                        lats[1])
    one_c = make_composite_frame_renderer(
        cfg.face_nerf_config(), torso_nerf_config(cfg), *args, cx=ds.cx,
        cy=ds.cy)(head, torso, poses[1], poses[0], bc, auds[1], sigs[1],
                  exprs[1], lats[1])
    for rank in ranks:
        _agree(rank["frames"]["frame"], ref)
        _agree(rank["frames"]["composite"], ref_c)
        np.testing.assert_allclose(rank["frames"]["frame"], one, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(rank["frames"]["composite"], one_c,
                                   atol=1e-6, rtol=0)


def test_sharded_videos_match_jax(mesh_2x2):
    """Four frames over 'data' 2 x 'ray' 2, each frame's conditioning with
    it, against the JAX package's frame-batched renderers."""
    cfg, ds, head, torso, poses, bc, auds, exprs, lats, sigs = (
        _render_inputs())
    jcfg = JaxConfig(**R.RENDER)
    jmesh = jax_make_mesh(n_data=2, n_ray=2, devices=jax.devices()[:4])
    jhead = jax.tree.map(jnp.asarray, bridge.params_to_jax(head))
    jtorso = jax.tree.map(jnp.asarray, bridge.torso_params_to_jax(torso))
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    view = _jax_view(ds, jcfg, jmesh)
    ref = jax_video(jcfg.face_nerf_config(), **view)(
        jhead, j(poses), j(bc), j(auds), j(exprs), j(lats))
    ref_c = jax_composite_video(jcfg.face_nerf_config(),
                                jax_torso_config(jcfg), **view)(
        jhead, jtorso, j(poses), j(poses[0]), j(bc), j(auds), j(sigs),
        j(exprs), j(lats))
    for rank in mesh_2x2:
        _agree(rank["frames"]["video"], ref)
        _agree(rank["frames"]["composite_video"], ref_c)


def _jax_batch_grads(indices):
    """jax.value_and_grad of the frame-averaged JAX make_frame_loss on the
    fixed coords, from the bridged weights -> (loss, param grads by port
    parameter order, latent grads)."""
    cfg = ExperimentConfig(**R.STEP)
    jcfg = JaxConfig(**R.STEP, flat_optimizer=False)
    st = R.head_state(cfg)
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_jax(st.params))
    jlatent = jnp.asarray(st.latent_codes.detach().numpy())
    jds = jax_synthetic(n_frames=R.N_FRAMES, H=R.HW, W=R.HW, dim_expr=8)
    coords = jnp.asarray(R.fixed_coords(R.N_FRAMES, cfg.N_rand).numpy(),
                         jnp.int32)
    grad_fn = _jax_grad_fn(jcfg, jds)
    data = jds.to_device()
    loss, g, g_lat = 0.0, None, 0.0
    with jax.default_matmul_precision("highest"):
        for i in indices:  # the frame-averaged loss, frame by frame
            (li, _), (gi, gi_lat) = grad_fn((jparams, jlatent), data, i,
                                            coords[i], None)
            loss += float(li) / len(indices)
            gi = jax.tree.map(lambda x: np.asarray(x) / len(indices), gi)
            g = gi if g is None else jax.tree.map(np.add, g, gi)
            g_lat = g_lat + np.asarray(gi_lat) / len(indices)
    holder = bridge.params_from_jax(g, cfg)
    return loss, [p.detach() for p in holder.parameters()], g_lat


_JAX_GRAD = {}


def _jax_grad_fn(jcfg, jds):
    """One jitted value_and_grad of the JAX frame loss (frame index and
    coords traced), shared by the cases."""
    if not _JAX_GRAD:
        _JAX_GRAD["fn"] = jax.jit(jax.value_and_grad(
            jax_frame_loss(jcfg, jds, False), has_aux=True),
            static_argnums=(4,))
    return _JAX_GRAD["fn"]


@pytest.mark.parametrize("shape,indices", [("1x2", [1]), ("2x1", [0, 2]),
                                           ("2x2", [0, 1, 2, 3])])
def test_sharded_step_matches_jax_on_fixed_coords(meshes, shape, indices):
    loss, ref, ref_lat = _jax_batch_grads(indices)
    floor = 1e-6 * max(float(r.norm()) for r in ref)
    for rank in meshes[shape]:
        got = rank["fixed"]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        for i, (g, r) in enumerate(zip(got["grads"][:-1], ref)):
            err = float((g - r).norm()) / max(float(r.norm()), floor)
            assert err < 1e-4, (shape, i, err)
        np.testing.assert_allclose(got["grads"][-1].numpy(), ref_lat,
                                   rtol=1e-4, atol=1e-9)


def _hold(got, want_loss, want_grads, tag):
    assert abs(got["loss"] - want_loss) <= 1e-6 * abs(want_loss), (
        tag, got["loss"], want_loss)
    floor = 1e-6 * max(float(w.norm()) for w in want_grads)
    for i, (g, w) in enumerate(zip(got["grads"], want_grads)):
        err = float((g - w).norm()) / max(float(w.norm()), floor)
        assert err < 1e-5, (tag, i, err)


def _grads_of(tensors):
    return [p.grad.detach().clone() if p.grad is not None
            else torch.zeros_like(p) for p in tensors]


def _single_head(indices):
    """The port's single-device head loss of ``indices`` on one generator
    (seed 7), frame by frame as one device draws: coords, then render."""
    cfg = ExperimentConfig(**R.STEP)
    ds = R.dataset()
    st, data = R.head_state(cfg), ds.to_device("cpu")
    g = torch.Generator().manual_seed(7)
    sample = make_head_sampler(cfg, R.HW, R.HW)
    loss_fn = make_frame_loss(cfg, ds, False)
    total = 0.0
    for i in indices:
        loss, _ = loss_fn(st.params, st.latent_codes, data, i,
                          sample(g, data, i), g)
        (loss / len(indices)).backward()
        total += float(loss.detach()) / len(indices)
    return total, _grads_of(st.trainable())


def _single_torso(indices):
    cfg = ExperimentConfig(**R.STEP)
    ds = R.dataset(with_torso=True)
    head, tp = R.head_state(cfg), R.torso_params(cfg)
    g = torch.Generator().manual_seed(7)
    sample = make_torso_sampler(cfg, R.HW, R.HW)
    loss_fn = make_torso_frame_loss(cfg, ds)
    total = 0.0
    for i in indices:
        loss, _ = loss_fn(tp, head.params, head.latent_codes.detach(),
                          ds.to_device("cpu"), i, sample(g), g)
        (loss / len(indices)).backward()
        total += float(loss.detach()) / len(indices)
    return total, _grads_of(tp.parameters())


@pytest.mark.parametrize("shape,indices", [("1x2", [1]), ("2x1", [0, 2])])
def test_distributed_head_step_matches_one_device(meshes, shape, indices):
    """The all-reduced gradients of one step on the draws of generator
    seed 7 against the single-device step's, every rank."""
    loss, grads = _single_head(indices)
    for rank in meshes[shape]:
        _hold(rank["drawn"], loss, grads, shape)


@pytest.mark.parametrize("shape,indices", [("1x2", [2]), ("2x1", [1, 3])])
def test_distributed_torso_step_matches_one_device(meshes, shape, indices):
    loss, grads = _single_torso(indices)
    for rank in meshes[shape]:
        _hold(rank["torso"], loss, grads, shape)


def test_sharded_crop_counts_the_aux_term_once(mesh_1x2):
    """The second stage's crop split over two ranks (3 tiles of 48 rays,
    the last padded) with an aux term on the assembled crop: the reduced
    gradients are the single-device step's. A gather whose backward
    all-reduced the crop's gradient would count the aux term twice."""
    cfg = ExperimentConfig(**R.STEP)
    ds = R.dataset()
    st = R.head_state(cfg)
    loss_fn = make_second_stage_loss(cfg, ds, 12, aux_loss=R.crop_aux,
                                     tile=48)
    loss, aux = loss_fn(st.params, st.latent_codes, ds.to_device("cpu"), 1,
                        torch.Generator().manual_seed(9))
    loss.backward()
    want = _grads_of(st.trainable())
    # the aux term moves the gradients well past the bound: counted twice,
    # they would miss it
    assert float(aux["aux_loss"].detach()) > 1e-3
    for rank in mesh_1x2:
        _hold(rank["crop"], float(loss.detach()), want, "crop")
        want_aux = float(aux["aux_loss"].detach())
        assert abs(rank["crop"]["aux"] - want_aux) <= 1e-6 * want_aux


def test_remat_step_is_the_step(mesh_2x2):
    """``remat`` recomputes each frame's forward in the backward from the
    same drawn numbers: the same loss and gradients, bit for bit."""
    for rank in mesh_2x2:
        assert rank["remat"]["loss"] == rank["drawn"]["loss"]
        for a, b in zip(rank["remat"]["grads"], rank["drawn"]["grads"]):
            assert torch.equal(a, b)


def test_ranks_stay_equal_through_training(mesh_2x2):
    """One epoch (two steps of two frames) of ShardedHeadTrainer: every
    rank holds the same parameters, bit for bit."""
    first = mesh_2x2[0]["trainer"]
    assert first["step"] == 2
    for rank in mesh_2x2[1:]:
        assert rank["trainer"]["step"] == 2
        for a, b in zip(rank["trainer"]["params"], first["params"]):
            assert torch.equal(a, b)


def test_ranks_take_their_place_backend_and_device(meshes):
    """Each rank's place in the mesh, gloo on the CPU, and the caller's
    precision settings (a spawned process does not inherit them)."""
    for shape, ranks in meshes.items():
        n_data, n_ray = map(int, shape.split("x"))
        assert [r["rank"] for r in ranks] == [
            (k, k // n_ray, k % n_ray, "gloo", "cpu")
            for k in range(n_data * n_ray)]
        assert all(r["precision"] == (torch.get_float32_matmul_precision(),
                                      False) for r in ranks)
    assert "does not cover" in meshes["1x2"][0]["bad_mesh"]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    out = dryrun_multichip(n, timeout=TIMEOUT)
    assert np.isfinite(out["loss"])
    assert out["mesh"] == {"data": 2, "ray": n // 2}


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails"):
        launch(R.fail_on_rank_1, 1, 2, device="cpu", timeout=TIMEOUT)


def test_a_hung_rank_times_out():
    with pytest.raises(TimeoutError):
        launch(R.hang, 1, 2, device="cpu", timeout=5)


@pytest.mark.parametrize("n_tiles,tile,n_ray", [(3, 96, 2), (3, 96, 4),
                                               (3, 48, 3)])
def test_tile_rows_cover_every_row_once(n_tiles, tile, n_ray):
    """Each tile's rows split into n_ray blocks: every row of the padded
    frame on exactly one rank, a rank's rows in tile order."""
    parts = [tile_rows(n_tiles * tile, tile, n_ray, r) for r in range(n_ray)]
    assert all(torch.equal(p, p.sort().values) for p in parts)
    assert torch.equal(torch.cat(parts).sort().values,
                       torch.arange(n_tiles * tile))
    assert torch.equal(parts[1][:tile // n_ray],
                       torch.arange(tile // n_ray, 2 * (tile // n_ray)))


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_replayed_rows_render_as_the_whole_call(noise):
    """render_draws draws what render_rays draws, in its order: rows of
    the replayed numbers render bit for bit as those rows of the whole
    call, and the generator ends where the whole call leaves it."""
    cfg = RenderConfig(n_samples=8, n_importance=6, raw_noise_std=noise)
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))

    def field(p, _):
        return torch.tanh(p @ w) * 3.0

    g = torch.Generator().manual_seed(1)
    o, d, b = (torch.randn(20, 3, generator=g) for _ in range(3))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    whole = render_rays(field, o, d, b, 0.5, 2.0, cfg, generator=g1)
    draws = render_draws(g2, 20, cfg)
    assert torch.equal(g1.get_state(), g2.get_state())
    part = render_rays(field, o[5:13], d[5:13], b[5:13], 0.5, 2.0, cfg,
                       generator=Replay([t[5:13] for t in draws]))
    assert torch.equal(part["rgb_map"], whole["rgb_map"][5:13])
    with pytest.raises(ValueError, match="more draws"):
        render_rays(field, o, d, b, 0.5, 2.0, cfg, generator=Replay([]))


def test_mesh_shape_and_tile_refusals():
    """The CLIs' axis rules, and the JAX package's refusals of a tile or a
    frame batch the mesh does not divide."""
    assert mesh_shape(0, 0, "cpu") is None
    assert mesh_shape(0, 2, "cpu") == (1, 2)
    assert mesh_shape(2, 0, "cpu") == (2, 1)
    assert mesh_shape(3, 0, "cpu", fill=False) == (3, 1)
    mesh = Mesh(n_data=2, n_ray=2, rank=0, device=torch.device("cpu"),
                backend="gloo")
    cfg = ExperimentConfig(**R.RENDER)
    view = (R.HW, R.HW, 1.0, 0.5, 2.0, cfg.render_config())
    with pytest.raises(ValueError, match="not divisible by 'ray'"):
        make_sharded_frame_renderer(cfg.face_nerf_config(), mesh, *view,
                                    tile=95)
    video = make_sharded_video_renderer(cfg.face_nerf_config(), mesh, *view,
                                        tile=96)
    with pytest.raises(ValueError, match="not divisible by 'data'"):
        video(None, torch.zeros(3, 3, 4), torch.zeros(R.HW, R.HW, 3))
