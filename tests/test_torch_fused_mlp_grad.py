"""The training path of the port's fused point MLP
(kernels/fused_mlp_grad.py: autograd Function = fused forward +
rematerialising backward) against the JAX package's custom VJP
(fused_point_mlp_train, Pallas in interpret mode) and against f32 autograd
of the plain MLP. On the CPU both passes run their plain versions, which
round at the kernels' points. Bounds, as tests/test_fused_mlp_grad.py:
1e-4 norm-relative per leaf for the f32 backward, 0.15 for the bf16 one;
conditioning gradients within 0.05 of their maximum, and nonzero."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idealnerf_tpu.core.embedding import positional_encoding as jax_pe
from idealnerf_tpu.kernels.fused_mlp_grad import (
    fused_point_mlp_train as jax_train,
)
from idealnerf_tpu.models import face_nerf as jax_fn
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.kernels.fused_render import (
    HEADS, PackedNet, model_leaves, pack_leaves,
)
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, apply_folded, fold_conditioning,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 0.15}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DIMS = dict(depth=8, width=256, dim_aud=16, dim_expr=8, dim_latent=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensor ops on one thread: under the suite's parallel workers
    a thread pool per op made these emulations many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, n=128):
    jcfg, cfg = jax_fn.FaceNeRFConfig(**DIMS), FaceNeRFConfig(**DIMS)
    jparams = jax_fn.init_face_nerf(jax.random.PRNGKey(seed), jcfg)
    model = bridge.load_module_(FaceNeRF(cfg),
                                jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(seed + 10)
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cond = (rng.randn(16).astype(np.float32) * 0.3,
            rng.randn(8).astype(np.float32) * 0.3,
            np.full(4, 0.1, np.float32))
    # a fixed non-uniform cotangent so every output lane matters
    w = (np.linspace(0.5, 1.5, n)[:, None]
         * np.asarray([1.0, -0.7, 0.3, 0.05])).astype(np.float32)
    return jcfg, jparams, cfg, model, pts, dirs, cond, w


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_grads(cfg, model, pts, dirs, cond, w, grad_dtype=None):
    """Parameter gradients of sum(raw * w) in the JAX tree layout: through
    fused_point_mlp_train, or through f32 autograd with grad_dtype=None."""
    model.zero_grad(set_to_none=True)
    folded = fold_conditioning(model, cfg, *map(_t, cond))
    if grad_dtype is None:
        raw = apply_folded(model, folded, cfg,
                           positional_encoding(_t(pts), cfg.multires),
                           positional_encoding(_t(dirs), cfg.multires_views))
    else:
        raw = fmg.fused_point_mlp_train(cfg, model, folded, _t(pts),
                                        _t(dirs), grad_dtype)
    (raw * _t(w)).sum().backward()
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), model.parameters()):
            p.copy_(q.grad)
    return bridge.module_to_tree(holder)


def _jax_grads(jcfg, jparams, pts, dirs, cond, w, grad_dtype):
    def loss(params):
        folded = jax_fn.fold_conditioning(params, jcfg,
                                          *map(jnp.asarray, cond))
        raw = jax_train(jcfg, params, folded, jnp.asarray(pts),
                        jnp.asarray(dirs), 128, True, grad_dtype)
        return jnp.sum(raw * jnp.asarray(w))

    with jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, jax.grad(loss)(jparams))


def _norm_rel(got, ref):
    out = {}
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        r, g = np.asarray(r, np.float32).ravel(), np.asarray(g).ravel()
        out[jax.tree_util.keystr(path)] = (np.linalg.norm(g - r)
                                           / (np.linalg.norm(r) + 1e-9))
    return out


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_matches_jax_vjp_and_autograd(grad_dtype):
    jcfg, jparams, cfg, model, pts, dirs, cond, w = _setup()
    got = _port_grads(cfg, model, pts, dirs, cond, w, grad_dtype)
    ref_autograd = _port_grads(cfg, model, pts, dirs, cond, w)
    ref_jax = _jax_grads(jcfg, jparams, pts, dirs, cond, w,
                         JAX_DTYPE[grad_dtype])
    for ref, what in ((ref_jax, "JAX VJP"), (ref_autograd, "f32 autograd")):
        assert jax.tree.structure(ref) == jax.tree.structure(got)
        for name, err in _norm_rel(got, ref).items():
            assert err < TOL[grad_dtype], f"{name} vs {what}: {err:.3e}"


def test_conditioning_gradients_flow():
    """d(loss)/d(aud, expr, latent) reaches the conditioning through the
    folded biases and matches the JAX package's plain path."""
    jcfg, jparams, cfg, model, pts, dirs, cond, w = _setup(seed=1)

    def jax_loss(c):
        folded = jax_fn.fold_conditioning(jparams, jcfg, *c)
        raw = jax_fn.apply_folded(jparams, folded, jcfg,
                                  jax_pe(jnp.asarray(pts), jcfg.multires),
                                  jax_pe(jnp.asarray(dirs),
                                         jcfg.multires_views))
        return jnp.sum(raw * jnp.asarray(w))

    with jax.default_matmul_precision("highest"):
        refs = jax.grad(jax_loss)(tuple(map(jnp.asarray, cond)))
    for grad_dtype in (torch.float32, torch.bfloat16):
        c = [_t(x).requires_grad_(True) for x in cond]
        folded = fold_conditioning(model, cfg, *c)
        raw = fmg.fused_point_mlp_train(cfg, model, folded, _t(pts),
                                        _t(dirs), grad_dtype)
        (raw * _t(w)).sum().backward()
        for x, ref, name in zip(c, refs, ("aud", "expr", "latent")):
            ref = np.asarray(ref)
            scale = np.abs(ref).max() + 1e-6
            assert np.abs(x.grad.numpy() - ref).max() / scale < 0.05, name
            assert np.abs(x.grad.numpy()).max() > 0, f"{name} is zero"


def test_points_and_directions_get_no_gradient():
    _, _, cfg, model, pts, dirs, cond, _ = _setup(seed=2, n=64)
    p, d = _t(pts).requires_grad_(True), _t(dirs).requires_grad_(True)
    folded = fold_conditioning(model, cfg, *map(_t, cond))
    raw = fmg.fused_point_mlp_train(cfg, model, folded, p, d)
    (raw ** 2).mean().backward()
    assert p.grad is None and d.grad is None
    assert float(model.pts_linears[0].weight.grad.abs().max()) > 0


def test_unpack_puts_each_packed_gradient_on_its_leaf():
    """Each packed operand's gradient lands on its nn.Linear weight (as a
    transpose) or folded bias; conditioning columns stay zero."""
    cfg = FaceNeRFConfig(depth=6, width=32, dim_aud=5, dim_expr=3,
                         dim_latent=2)
    model = FaceNeRF(cfg, torch.Generator().manual_seed(0))
    folded = fold_conditioning(model, cfg, torch.ones(5), torch.ones(3),
                               torch.ones(2))
    leaves = model_leaves(model, folded, cfg)
    shape_net = pack_leaves(cfg, leaves, torch.float32)
    counter = iter(range(1, 10 ** 6))

    def marked(x):
        return torch.full(x.shape, float(next(counter)))

    g = PackedNet(
        w=[marked(x) for x in shape_net.w], b=[marked(x) for x in shape_net.b],
        wskip={i: marked(x) for i, x in shape_net.wskip.items()},
        wv=[marked(x) for x in shape_net.wv],
        bv=[marked(x) for x in shape_net.bv], wv0d=marked(shape_net.wv0d),
        w_alpha=marked(shape_net.w_alpha), w_rgb=marked(shape_net.w_rgb),
        b_heads=torch.arange(HEADS, dtype=torch.float32),
        multires=10, multires_views=4, softplus=False)
    out = fmg.unpack_grads(g, cfg, leaves)
    assert [o.shape for o in out] == [x.shape for x in leaves]
    pe, in_all, W, D = cfg.input_ch, cfg.input_ch_all, cfg.width, cfg.depth
    assert torch.all(out[0][:, :pe] == g.w[0][0, 0])
    assert torch.all(out[0][:, pe:] == 0)                 # conditioning
    skip = 1 + cfg.skips[0]
    assert torch.all(out[skip][:, :pe] == g.wskip[skip][0, 0])
    assert torch.all(out[skip][:, pe:in_all] == 0)
    assert torch.all(out[skip][:, in_all:] == g.w[skip][0, 0])
    assert torch.all(out[1] == g.w[1][0, 0])
    for i in range(D):
        assert torch.equal(out[D + i], g.b[i])
    nv = 1 + D // 4
    v0 = out[2 * D]
    assert torch.all(v0[:, :W] == g.wv[0][0, 0])
    assert torch.all(v0[:, W:W + cfg.input_ch_views] == g.wv0d[0, 0])
    assert torch.all(v0[:, W + cfg.input_ch_views:] == 0)  # expr/3 slice
    assert torch.equal(out[2 * D + nv], g.bv[0])
    wa, ba, wr, br = out[2 * D + 2 * nv:]
    assert torch.all(wa == g.w_alpha[0, 0]) and ba.tolist() == [3.0]
    assert torch.all(wr == g.w_rgb[0, 0]) and br.tolist() == [0.0, 1.0, 2.0]

    layout, size = fmg._grad_layout(shape_net)
    spans = sorted((off, off + int(np.prod(shape)))
                   for off, shape in layout.values())
    assert all(off % 64 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= size


# ------------------------------------------- the two passes of the backward

def _packed(grad_dtype, n=500, seed=3):
    """A packed paper-width net and n seeded points, directions and a
    cotangent (n is not a multiple of the 64-point tile)."""
    cfg = FaceNeRFConfig(**DIMS)
    model = FaceNeRF(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    folded = fold_conditioning(model, cfg, _t(rng.randn(16) * 0.3).float(),
                               _t(rng.randn(8) * 0.3).float(),
                               torch.full((4,), 0.1))
    net = pack_leaves(cfg, model_leaves(model, folded, cfg), grad_dtype)
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = (rng.randn(n, 4) / n).astype(np.float32)
    return net, _t(pts), _t(dirs), _t(g)


def _flat(p):
    return [*p.w, *p.b, *p.wskip.values(), *p.wv, *p.bv, p.wv0d, p.w_alpha,
            p.w_rgb, p.b_heads]


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / (want.norm() + 1e-30))


def _one_pass_reference(net, pts, dirs, g):
    """The backward as one pass in torch ops, as the port had it before the
    split: every product over all points at once, bias gradients summed
    directly over the points."""
    dt = net.w[0].dtype

    def rnd(x):
        return x.to(dt).float()

    relu = torch.relu
    W = [x.float() for x in net.w]
    WV = [x.float() for x in net.wv]
    pe, ped = fmg.encode_points(net, pts, dirs)
    hs = [rnd(relu(pe @ W[0] + net.b[0]))]
    for i in range(1, len(W)):
        acc = hs[-1] @ W[i]
        if i in net.wskip:
            acc = pe @ net.wskip[i].float() + acc
        hs.append(rnd(relu(acc + net.b[i])))
    hvs = [rnd(relu(hs[-1] @ WV[0] + ped @ net.wv0d.float() + net.bv[0]))]
    for v in range(1, len(WV)):
        hvs.append(rnd(relu(hvs[-1] @ WV[v] + net.bv[v])))
    g16 = torch.nn.functional.pad(g.float(), (0, HEADS - 4))
    gb = rnd(g16)
    d_alpha, d_rgb, d_bheads = hs[-1].T @ gb, hvs[-1].T @ gb, g16.sum(0)
    dh = g16 @ net.w_alpha.float().T
    dv = g16 @ net.w_rgb.float().T
    dwv, dbv = [None] * len(WV), [None] * len(WV)
    for v in range(len(WV) - 1, 0, -1):
        dv = dv * (hvs[v] > 0)
        dc = rnd(dv)
        dwv[v], dbv[v] = hvs[v - 1].T @ dc, dv.sum(0)
        dv = dc @ WV[v].T
    dv = dv * (hvs[0] > 0)
    dc = rnd(dv)
    dwv[0], dwv0d, dbv[0] = hs[-1].T @ dc, ped.T @ dc, dv.sum(0)
    dh = dh + dc @ WV[0].T
    dw, db, dskip = [None] * len(W), [None] * len(W), {}
    for i in range(len(W) - 1, 0, -1):
        dh = dh * (hs[i] > 0)
        dc = rnd(dh)
        dw[i], db[i] = hs[i - 1].T @ dc, dh.sum(0)
        if i in net.wskip:
            dskip[i] = pe.T @ dc
        dh = dc @ W[i].T
    dh = dh * (hs[0] > 0)
    dc = rnd(dh)
    dw[0], db[0] = pe.T @ dc, dh.sum(0)
    return PackedNet(w=dw, b=db, wskip=dskip, wv=dwv, bv=dbv, wv0d=dwv0d,
                     w_alpha=d_alpha, w_rgb=d_rgb, b_heads=d_bheads,
                     multires=net.multires,
                     multires_views=net.multires_views, softplus=net.softplus)


@pytest.mark.parametrize("grad_dtype,tol", [(torch.float32, 1e-6),
                                            (torch.bfloat16, 1e-5)],
                         ids=["f32", "bf16"])
def test_two_passes_compose_to_the_one_pass_reference(grad_dtype, tol):
    """Pass A then pass B equals the one-pass backward up to the order of
    the sums (bias gradients go through per-tile sums)."""
    net, pts, dirs, g = _packed(grad_dtype)
    got = fmg.grad_pass_b_reference(
        net, fmg.grad_pass_a_reference(net, pts, dirs, g))
    want = _one_pass_reference(net, pts, dirs, g)
    assert len(_flat(got)) == len(_flat(want))
    for a, b in zip(_flat(got), _flat(want)):
        assert a.shape == b.shape
        assert _rel(a, b) < tol
    for a, b in zip(_flat(fmg.point_mlp_grad_reference(net, pts, dirs, g)),
                    _flat(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_chunks", [3, 8])
def test_pass_b_chunkings_agree(n_chunks):
    """Summing the points in chunks of tiles (the kernel's partials) moves
    the f32 gradients by rounding only."""
    net, pts, dirs, g = _packed(torch.float32)
    bufs = fmg.grad_pass_a_reference(net, pts, dirs, g)
    assert bufs.bias.shape[0] == 8  # 500 points in tiles of 64
    one = fmg.grad_pass_b_reference(net, bufs, 1)
    many = fmg.grad_pass_b_reference(net, bufs, n_chunks)
    for a, b in zip(_flat(many), _flat(one)):
        assert _rel(a, b) < 1e-6


def test_chunks_cover_the_tiles_in_order():
    for n_tiles, sms in ((8192, 132), (6144, 132), (5, 132), (1, 132),
                         (100, 3)):
        n_chunks = fmg.grad_chunks(n_tiles, sms)
        spans = fmg.chunk_bounds(n_tiles, n_chunks)
        assert 1 <= n_chunks <= n_tiles and len(spans) == n_chunks
        assert spans[0][0] == 0 and spans[-1][1] == n_tiles
        assert all(a < b for a, b in spans)
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    assert fmg.grad_chunks(8192, 132) == 33


def test_operand_planes_layout():
    """The offsets, widths and swizzled order that csrc/fused_mlp_grad.cuh
    assumes: planes in the order pe, ped, gb, h, hv, dc, dv, packed back
    to back; every tile image and 64-lane block 1,024-byte aligned (so
    128-byte aligned for the bulk copies, and whole swizzle atoms); within
    a block, each point's 8-lane chunk is 16 contiguous bytes at chunk
    c ^ (p % 8) of the point's 128-byte row."""
    net, _, _, _ = _packed(torch.bfloat16, n=64)
    D, V, W, WV = len(net.w), len(net.wv), net.width, net.width // 2
    n_tiles = 5
    offs, widths, total = fmg.grad_planes(net, n_tiles)
    assert widths == ([64, 64, 64] + [W] * D + [WV] * V + [W] * D
                      + [WV] * V)
    assert offs[0] == 0
    ends = [o + n_tiles * 64 * w for o, w in zip(offs, widths)]
    assert offs[1:] == ends[:-1] and total == ends[-1]
    assert all(w % 64 == 0 for w in widths)
    assert all((2 * o) % 1024 == 0 for o in offs)
    for width in (64, 128, 256):
        idx = fmg.swizzle_index(width)
        assert idx.shape == (64, width)
        assert torch.equal(idx.reshape(-1).sort().values,
                           torch.arange(64 * width))
        p = torch.arange(64)[:, None]
        f = torch.arange(width)[None, :]
        assert torch.equal(idx // 64, (f // 64) * 64 + p)  # 128-byte rows
        assert torch.equal(idx % 8, (f % 8).expand(64, -1))  # 16-B chunks
        assert torch.equal((idx % 64) // 8, ((f % 64) // 8) ^ (p % 8))


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_planes_round_trip_to_pass_b(grad_dtype):
    """Pass A's buffers written into the planes in the swizzled order and
    read back (buffers_from_planes, as a check on the card does with the
    kernel's planes) give pass B the same gradients."""
    net, pts, dirs, g = _packed(grad_dtype)
    bufs = fmg.grad_pass_a_reference(net, pts, dirs, g)
    n, n_tiles = pts.shape[0], bufs.bias.shape[0]
    offs, widths, total = fmg.grad_planes(net, n_tiles)
    planes = torch.zeros(total)
    for off, width, x in zip(offs, widths, [bufs.pe, bufs.ped, bufs.gb,
                                             *bufs.hs, *bufs.hvs, *bufs.dcs,
                                             *bufs.dvs]):
        x = torch.nn.functional.pad(
            x, (0, width - x.shape[1], 0, n_tiles * 64 - n))
        img = torch.zeros(n_tiles, 64 * width)
        img[:, fmg.swizzle_index(width).reshape(-1)] = x.reshape(
            n_tiles, 64 * width)
        planes[off:off + img.numel()] = img.reshape(-1)
    back = fmg.buffers_from_planes(net, planes, offs, bufs.bias, n)
    for a, b in zip([back.pe, back.ped, back.gb, *back.hs, *back.dcs],
                    [bufs.pe, bufs.ped, bufs.gb, *bufs.hs, *bufs.dcs]):
        assert torch.equal(a, b)
    for a, b in zip(_flat(fmg.grad_pass_b_reference(net, back, 3)),
                    _flat(fmg.grad_pass_b_reference(net, bufs, 3))):
        assert torch.equal(a, b)


# ------------------------------- pass A on the wgmma chain, emulated here

# the paper model, and 2-layer nets of the kernel's width with and without
# a skip layer (layer 1 takes the PE again when 0 is in skips)
NETS = {"paper": dict(depth=8), "d2-skip": dict(depth=2, skips=(0,)),
        "d2-noskip": dict(depth=2, skips=())}


def _net(name, n, seed=5):
    """A packed bf16 net of NETS and n seeded points, unit directions and a
    cotangent."""
    cfg = FaceNeRFConfig(**{**DIMS, **NETS[name]})
    model = FaceNeRF(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + n)
    folded = fold_conditioning(model, cfg, _t(rng.randn(16) * 0.3).float(),
                               _t(rng.randn(8) * 0.3).float(),
                               torch.full((4,), 0.1))
    net = pack_leaves(cfg, model_leaves(model, folded, cfg))
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = (rng.randn(n, 4) / 64).astype(np.float32)
    return net, _t(pts), _t(dirs), _t(g)


def _expected_grad_order(net):
    """The stage order of csrc/fused_mlp_grad.cuh's note: K4's forward
    stages (layer 0, each later layer's skip pe-part before its h-part,
    view layer 0 and its dir-PE stage, the other view layers) without the
    heads, then WV_v^T for v = V-1..1 in 64-row stages, WV_0^T in 32-row
    stages and W_i^T for i = D-1..1."""
    order = [("w0", 0), ("w0", 32)]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            order += [(f"wskip{i}", 0), (f"wskip{i}", 32)]
        order += [(f"w{i}", k) for k in range(0, 256, 32)]
    order += [("wv0", k) for k in range(0, 256, 64)] + [("wv0d", 0)]
    for v in range(1, len(net.wv)):
        order += [(f"wv{v}", 0), (f"wv{v}", 64)]
    for v in range(len(net.wv) - 1, 0, -1):
        order += [(f"wv{v}T", 0), (f"wv{v}T", 64)]
    order += [("wv0T", k) for k in range(0, 128, 32)]
    for i in range(len(net.w) - 1, 0, -1):
        order += [(f"w{i}T", k) for k in range(0, 256, 32)]
    return order


@pytest.mark.parametrize("name", list(NETS))
def test_pass_a_stream_round_trips_and_follows_the_kernel_header(name):
    """Pass A's weight stream reads back bitwise into every matrix it holds
    (the backward's as the transposes of the net's), its stages lie in the
    header's order, its forward stages are K4's stream less the heads, and
    its count is the kernel's check, chain_stages + grad_back_stages: 69 +
    64 = 133 for the paper model."""
    net, _, _, _ = _net(name, 1)
    stream, order = fmg.grad_weight_stream(net)
    assert stream.dtype == torch.bfloat16
    assert order == _expected_grad_order(net)
    assert stream.numel() == len(order) * fr.STAGE_ELEMS
    back = fmg.grad_stream_matrices(stream, net)
    want = {f"w{i}": w for i, w in enumerate(net.w)}
    want.update({f"wskip{i}": w for i, w in net.wskip.items()})
    want.update({f"wv{v}": w for v, w in enumerate(net.wv)})
    want.update({f"w{i}T": w.T for i, w in enumerate(net.w) if i})
    want.update({f"wv{v}T": w.T for v, w in enumerate(net.wv)})
    want["wv0d"] = net.wv0d
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k
    k4, k4_order = fr.chain_weight_stream(net, dir_stage=True)
    n_fwd = len(k4_order) - 1
    assert order[:n_fwd] == k4_order[:-1]
    assert torch.equal(stream[:n_fwd * fr.STAGE_ELEMS],
                       k4[:n_fwd * fr.STAGE_ELEMS])
    D, V = len(net.w), len(net.wv)
    chain_stages = (2 + sum(8 + 2 * (i in net.wskip) for i in range(1, D))
                    + 4 + 2 * (V - 1) + 1)
    back_stages = 2 * (V - 1) + 4 + 8 * (D - 1)
    assert len(order) == chain_stages + back_stages
    if name == "paper":
        assert (n_fwd, len(order) - n_fwd) == (69, 64)


def _emulate_pass_a(net, pts, dirs, g, acc):
    """Pass A's stage walk in plain torch, in ``acc``: 128-point tiles
    (zeros past N), every product summed one stage at a time with B read
    from the stage's swizzled image of grad_weight_stream, the forward
    (bf16 after every relu, relu' kept), then d_h from the heads' K = 4
    products with the unrounded cotangent, masked, rounded and multiplied
    back through the transposed stages; bias rows per 64-point half tile.
    -> GradBuffers of N rows."""
    stream, _ = fmg.grad_weight_stream(net)
    img = stream.reshape(-1, fr.STAGE_ELEMS)
    stages = []
    for _, m, kr in fmg._grad_stream_parts(net):
        idx = fr.swizzle_image_index(kr, m.shape[1]).reshape(-1)
        for k0 in range(0, m.shape[0], kr):
            stages.append(img[len(stages)][idx].reshape(kr, -1).to(acc))
    n = pts.shape[0]
    tiles = -(-n // fr.CHAIN_TILE)
    pad = tiles * fr.CHAIN_TILE - n
    pe, ped = (torch.nn.functional.pad(x.to(acc), (0, 64 - x.shape[1], 0, pad))
               for x in fmg.encode_points(net, pts, dirs))
    g4 = torch.nn.functional.pad(g.to(acc), (0, 0, 0, pad))
    wa, wr = net.w_alpha[:, :4].to(acc), net.w_rgb[:, :4].to(acc)
    D, V = len(net.w), len(net.wv)

    def rnd(x):
        return x.to(torch.bfloat16).to(acc)

    def halves(d):
        return d.reshape(2, 64, d.shape[1]).sum(1)

    out = {k: [] for k in ("pe", "ped", "gb", "hs", "hvs", "dcs", "dvs",
                           "bias")}
    for t0 in range(0, n + pad, fr.CHAIN_TILE):
        q = 0

        def prod(a, lanes, out_=None):
            nonlocal q
            s = torch.zeros(a.shape[0], lanes, dtype=acc) if out_ is None \
                else out_
            kr = stages[q].shape[0]
            for k0 in range(0, a.shape[1], kr):
                s = s + a[:, k0:k0 + kr] @ stages[q]
                q += 1
            return s

        x, xd, gt = (v[t0:t0 + fr.CHAIN_TILE] for v in (pe, ped, g4))
        hs = [rnd(torch.relu(prod(x, 256) + net.b[0].to(acc)))]
        for i in range(1, D):
            s = prod(x, 256) if i in net.wskip else None
            hs.append(rnd(torch.relu(prod(hs[-1], 256, s)
                                     + net.b[i].to(acc))))
        s = prod(xd, 128, prod(hs[-1], 128))
        hvs = [rnd(torch.relu(s + net.bv[0].to(acc)))]
        for v in range(1, V):
            hvs.append(rnd(torch.relu(prod(hvs[-1], 128)
                                      + net.bv[v].to(acc))))
        dvs, dcs, bv, bs = [None] * V, [None] * D, [None] * V, [None] * D
        dv = gt @ wr.T
        for v in range(V - 1, -1, -1):
            dv = torch.where(hvs[v] > 0, dv, torch.zeros_like(dv))
            dvs[v], bv[v] = rnd(dv), halves(dv)
            if v:
                dv = prod(dvs[v], 128)
        dh = prod(dvs[0], 256) + gt @ wa.T
        for i in range(D - 1, -1, -1):
            dh = torch.where(hs[i] > 0, dh, torch.zeros_like(dh))
            dcs[i], bs[i] = rnd(dh), halves(dh)
            if i:
                dh = prod(dcs[i], 256)
        assert q == len(stages)
        g16 = torch.nn.functional.pad(gt, (0, HEADS - 4))
        for k, v in (("pe", x), ("ped", xd[:, :fr.PED_PAD]), ("gb", rnd(g16)),
                     ("hs", hs), ("hvs", hvs), ("dcs", dcs), ("dvs", dvs),
                     ("bias", torch.cat([*bs, *bv, halves(g16)], dim=1))):
            out[k].append(v)
    cat = (lambda k: torch.cat(out[k])[:n])
    layers = (lambda k, L: [torch.cat([t[j] for t in out[k]])[:n]
                            for j in range(L)])
    return fmg.GradBuffers(
        pe=cat("pe"), ped=cat("ped"), gb=cat("gb"), hs=layers("hs", D),
        hvs=layers("hvs", V), dcs=layers("dcs", D), dvs=layers("dvs", V),
        bias=torch.cat(out["bias"])[:-(-n // fmg.GRAD_TILE)])


def _buffers(b):
    return {"pe": b.pe, "ped": b.ped, "gb": b.gb, "bias": b.bias,
            **{f"h{i}": x for i, x in enumerate(b.hs)},
            **{f"hv{v}": x for v, x in enumerate(b.hvs)},
            **{f"dc{i}": x for i, x in enumerate(b.dcs)},
            **{f"dv{v}": x for v, x in enumerate(b.dvs)}}


@pytest.mark.parametrize("name,n", [
    ("paper", 1), ("paper", 127), ("paper", 1001), ("d2-skip", 127),
    ("d2-noskip", 1001)])
def test_pass_a_emulation_matches_grad_pass_a_reference(name, n):
    """The emulation of pass A's stage walk against grad_pass_a_reference,
    every plane and the bias rows: within 1e-5 norm-relative in f64, where
    the order of the sums leaves no trace; in f32 within twice the
    reference's own distance from f64 (at least 1e-5), since a sum one ulp
    apart may round an activation or a d_h to the neighbouring bf16 value.
    Ragged N (one point in a tile of zeros, a ragged last tile, a ragged
    last 64-point half) leaves the valid rows and the bias rows as they
    are."""
    net, pts, dirs, g = _net(name, n)
    want64 = _buffers(fmg.grad_pass_a_reference(net, pts, dirs, g,
                                                torch.float64))
    want32 = _buffers(fmg.grad_pass_a_reference(net, pts, dirs, g))
    got64 = _buffers(_emulate_pass_a(net, pts, dirs, g, torch.float64))
    got32 = _buffers(_emulate_pass_a(net, pts, dirs, g, torch.float32))
    assert want64["bias"].shape[0] == -(-n // 64)
    for k, w in want64.items():
        assert got64[k].shape == got32[k].shape == w.shape, k
        assert _rel(got64[k], w) <= 1e-5, (k, _rel(got64[k], w))
        own = _rel(want32[k], w)
        assert _rel(got32[k], w) <= max(2 * own, 1e-5), (k, own)


def test_pass_a_emulation_composes_to_the_jax_vjp(monkeypatch):
    """The emulated pass A, then grad_pass_b_reference, through the
    training autograd Function: every parameter gradient within the bf16
    bound of test_backward_matches_jax_vjp_and_autograd of the JAX VJP."""
    jcfg, jparams, cfg, model, pts, dirs, cond, w = _setup()

    def composed(net, p, d, g):
        return fmg.grad_pass_b_reference(
            net, _emulate_pass_a(net, p, d, g, torch.float32))

    monkeypatch.setattr(fmg, "point_mlp_grad_reference", composed)
    got = _port_grads(cfg, model, pts, dirs, cond, w, torch.bfloat16)
    ref = _jax_grads(jcfg, jparams, pts, dirs, cond, w, jnp.bfloat16)
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for name, err in _norm_rel(got, ref).items():
        assert err < TOL[torch.bfloat16], f"{name}: {err:.3e}"


def _pass_a_smem_bytes(ring, depth, n_views):
    """csrc/fused_mlp_grad.cuh pass_a_smem_bytes: 1,024 bytes of alignment,
    the ring, two warpgroups' PE / trunk / view tiles (the dir-PE tile
    shares the view tile) and relu' bits (16 bytes a thread per trunk
    layer, 8 per view layer), the ring's mbarriers, then the store
    mailboxes: two full and two empty mbarriers and two 48-byte Mails."""
    tiles = 2 * 64 * (fr.PE_PAD + 256 + 128)
    masks = 128 * (16 * depth + 8 * n_views)
    return (1024 + ring * 2 * fr.STAGE_ELEMS + 2 * (tiles + masks) + 128
            + 32 + 2 * 48)


class _PassALib:
    """The library calls pass A's plan makes, from the layout above."""

    fr_grad_pass_a_smem_bytes = staticmethod(_pass_a_smem_bytes)
    fr_grad_pass_a_smem_bytes_w256 = fr_grad_pass_a_smem_bytes


@pytest.mark.parametrize("N,plan", [
    (131072, (8, 128)), (393216, (24, 128)), (524288, (32, 128)),
    (1001, (1, 8)), (1, (1, 1))])
def test_pass_a_plans_cover_every_point_once_in_one_wave(N, plan):
    """Pass A's plan on a 132-SM card at the paper depth: the point
    kernels' plan (the step's coarse and fine passes, both at once, a
    ragged 1,001, one point), every point covered exactly once by at most
    one wave of blocks, at a 4-stage ring whose shared memory fits and a
    5-stage one that would not; deeper nets take 3 or 2 stages (the
    deepest the operand table allows, 16 layers, 2), and a net whose
    relu' bits leave no room for 2 is refused."""
    per_block, blocks, ring = fmg.pass_a_plan(_PassALib(), N, 132, 8, 3)
    assert (per_block, blocks, ring) == (*plan, 4)
    assert _pass_a_smem_bytes(4, 8, 3) == 220416 <= fr.SMEM_LIMIT
    assert _pass_a_smem_bytes(5, 8, 3) > fr.SMEM_LIMIT
    seen = torch.zeros(N, dtype=torch.int32)
    for b in range(blocks):
        p0 = b * per_block * fr.CHAIN_TILE
        assert p0 < N
        seen[p0:min(p0 + per_block * fr.CHAIN_TILE, N)] += 1
    assert torch.all(seen == 1)
    assert fmg.pass_a_plan(_PassALib(), N, 132, 12, 4)[2] == 3
    assert fmg.pass_a_plan(_PassALib(), N, 132, 16, 5)[2] == 2
    with pytest.raises(ValueError, match="shared memory"):
        fmg.pass_a_plan(_PassALib(), N, 132, 40, 11)
