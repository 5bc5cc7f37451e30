"""The wgmma chain's weight stream and layer chain (kernels/fused_render.py:
chain_weight_stream, csrc/chain.cuh chain_mlp, which the render, coarse and
delta kernels run, and with view layer 0's dir-PE stage the point kernels
K4 and K5 of kernels/fused_mlp.py), on the CPU.

The kernels themselves run only on the card (chip_smoke.py phases 2, 6, 9
and 11 hold them against their plain versions there). Here: the stream
round-trips bitwise through its plain inverse, its stages lie where the
kernels' header says, each net's stream holds that net, a plain emulation
of the chain (128-row tiles over each block's points, one 16 KB stage at a
time, bf16 after every relu; for points the dir-PE product in view layer
0) equals the plain MLP the kernels' plain versions use, and the render
and point kernels' launch plans fit the shared memory. The JAX agreement
of the kernels as a whole is tests/test_torch_fused_render.py's and
tests/test_torch_fused_mlp.py's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.kernels import fused_mlp as fm
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF, fold_conditioning

# the paper model, and 2-layer nets of the kernel's width with and without
# a skip layer (layer 1 takes the PE again when 0 is in skips)
NETS = {"paper": dict(depth=8), "d2-skip": dict(depth=2, skips=(0,)),
        "d2-noskip": dict(depth=2, skips=())}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensor ops on one thread: under the suite's parallel workers
    a thread pool per op made these emulations many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(name: str, seed: int = 0) -> fr.PackedNet:
    cfg = ExperimentConfig(dim_aud=16, dim_expr=8, dim_latent=4)
    ncfg = dataclasses.replace(cfg.face_nerf_config(), **NETS[name])
    gen = torch.Generator().manual_seed(seed)
    model = FaceNeRF(ncfg, gen)
    rng = np.random.RandomState(seed)
    cond = [torch.from_numpy(rng.randn(n).astype(np.float32))
            for n in (16, 8, 4)]
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, *cond)
    return fr.pack_operands(model, folded, ncfg)


def _expected_order(net: fr.PackedNet, dir_stage: bool = False):
    """The stage order of the kernels' header comment: layer 0 in 32-row
    stages, each later layer's skip pe-part before its h-part, the view
    layers in 64-row stages (the point kernels' dir-PE stage after view
    layer 0's h-part), the heads last."""
    order = [("w0", 0), ("w0", 32)]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            order += [(f"wskip{i}", 0), (f"wskip{i}", 32)]
        order += [(f"w{i}", k) for k in range(0, 256, 32)]
    order += [("wv0", k) for k in range(0, 256, 64)]
    order += [("wv0d", 0)] * dir_stage
    for v in range(1, len(net.wv)):
        order += [(f"wv{v}", 0), (f"wv{v}", 64)]
    return order + [("heads", 0)]


@pytest.mark.parametrize("name", list(NETS))
def test_delta_stream_round_trips(name):
    """The plain inverse gives back every PackedNet matrix bitwise."""
    net = _packed(name)
    stream, _ = fr.chain_weight_stream(net)
    assert stream.dtype == torch.bfloat16
    back = fr.chain_stream_matrices(stream, net)
    want = {f"w{i}": w for i, w in enumerate(net.w)}
    want.update({f"wskip{i}": w for i, w in net.wskip.items()})
    want.update({f"wv{v}": w for v, w in enumerate(net.wv)})
    want.update(w_alpha=net.w_alpha, w_rgb=net.w_rgb)
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k


@pytest.mark.parametrize("name", list(NETS))
def test_delta_stream_stages_follow_the_kernel_header(name):
    """Fixed 16 KB stages, each at a multiple of 1,024 bytes, in the order
    of fused_render.cuh's header; the heads' stage is zero past its 12 KB;
    the paper model streams 69 stages (1.13 MB)."""
    net = _packed(name)
    stream, order = fr.chain_weight_stream(net)
    assert order == _expected_order(net)
    assert stream.numel() == len(order) * fr.STAGE_ELEMS
    stage_bytes = 2 * fr.STAGE_ELEMS
    assert stage_bytes == 16384
    assert all(q * stage_bytes % 1024 == 0 for q in range(len(order)))
    heads = stream.reshape(-1, fr.STAGE_ELEMS)[-1]
    assert torch.all(heads[16 * (256 + 128):] == 0)
    if name == "paper":
        assert len(order) == 69
        assert abs(stream.numel() * 2 / 1e6 - 1.13) < 0.01


def test_swizzle_image_matches_the_kernels_swz():
    """At 64 rows the image is csrc/hopper.cuh's swz (the delta kernel's
    activation tiles, the gradient kernel's planes), written out here
    bit by bit; each image is a permutation of its (rows, lanes)
    elements."""
    p = torch.arange(64)[:, None]
    for lanes in (64, 128, 256):
        f = torch.arange(lanes)[None, :]
        swz = (((f >> 6) << 12) + ((p >> 3) << 9) + ((p & 7) << 6)
               + ((((f >> 3) & 7) ^ (p & 7)) << 3) + (f & 7))
        assert torch.equal(fr.swizzle_image_index(64, lanes), swz)
    for rows, lanes in ((32, 256), (64, 128), (16, 256), (16, 128)):
        idx = fr.swizzle_image_index(rows, lanes).reshape(-1)
        assert torch.equal(torch.sort(idx)[0], torch.arange(rows * lanes))


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _emulate(stream: torch.Tensor, net: fr.PackedNet, pe, pv, tile=128,
             block=None, ped=None):
    """The kernel's chain in plain torch over blocks of ``block`` points
    (all of them by default; the last block may be short): each block's
    points in tiles of ``tile`` rows (zeros past the block's last point);
    every layer sums its products one stage (K-chunk) at a time in pe's
    dtype, reading B from the stage's swizzled image; bf16 after every
    relu; the skip layer's PE product first, in the same sum; with ``ped``
    (the point kernels: per-point dir-PE rows, pv then the bias bv[0])
    view layer 0's dir-PE product after its h-part, in the same sum, from
    a 64-lane tile; the heads from their one stage."""
    n = pe.shape[0]
    block = block or n
    if n > block:
        return torch.cat([_emulate(stream, net, pe[b:b + block],
                                   pv[b:b + block], tile,
                                   ped=None if ped is None
                                   else ped[b:b + block])
                          for b in range(0, n, block)])
    dt = pe.dtype
    img = stream.reshape(-1, fr.STAGE_ELEMS).to(dt)
    pad = (-n) % tile
    pe, pv = F.pad(pe, (0, 0, 0, pad)), F.pad(pv, (0, 0, 0, pad))
    if ped is not None:
        ped = F.pad(ped, (0, 64 - ped.shape[1], 0, pad))
    W, WV = net.w_alpha.shape[0], net.w_rgb.shape[0]
    outs = []
    for t0 in range(0, n + pad, tile):
        q = 0

        def prod(acc, a, lanes):
            nonlocal q
            kr = fr.STAGE_ELEMS // lanes
            idx = fr.swizzle_image_index(kr, lanes).reshape(-1)
            for k0 in range(0, a.shape[1], kr):
                acc = acc + a[:, k0:k0 + kr] @ img[q][idx].reshape(kr, lanes)
                q += 1
            return acc

        x = pe[t0:t0 + tile]
        h = _bf16(torch.relu(prod(torch.zeros(tile, W, dtype=dt), x, W)
                             + net.b[0]))
        for i in range(1, len(net.w)):
            acc = torch.zeros(tile, W, dtype=dt)
            if i in net.wskip:
                acc = prod(acc, x, W)
            h = _bf16(torch.relu(prod(acc, h, W) + net.b[i]))
        acc = prod(torch.zeros(tile, WV, dtype=dt), h, WV)
        if ped is not None:
            acc = prod(acc, ped[t0:t0 + tile], WV)
        hv = _bf16(torch.relu(acc + pv[t0:t0 + tile]))
        for v in range(1, len(net.wv)):
            acc = prod(torch.zeros(tile, WV, dtype=dt), hv, WV)
            hv = _bf16(torch.relu(acc + net.bv[v]))
        ia = fr.swizzle_image_index(fr.HEADS, W).reshape(-1)
        ir = fr.swizzle_image_index(fr.HEADS, WV).reshape(-1)
        wa = img[q][ia].reshape(fr.HEADS, W).T
        wr = img[q][ia.numel() + ir].reshape(fr.HEADS, WV).T
        assert q + 1 == img.shape[0]
        outs.append((h @ wa + hv @ wr + net.b_heads)[:, :4])
    return torch.cat(outs)[:n]


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("name,n_rays,S", [
    ("paper", 16, 16), ("paper", 7, 17), ("d2-skip", 9, 16),
    ("d2-noskip", 5, 33), ("paper", 1, 5), ("paper", 3, 96),
    ("d2-skip", 40, 16), ("d2-noskip", 8, 32)])
def test_tiled_emulation_matches_mlp_reference(name, n_rays, S):
    """The emulation of the kernel's chain against _mlp_reference on the
    same bf16 weights and rounding points. In f64 the order of the sums
    leaves no trace: within 1e-5 norm-relative. In f32 a sum that lands
    one ulp apart can round an activation to the neighbouring bf16 value,
    and deep chains carry it on: the f32 reference itself lies about 3e-4
    from the f64 one at paper depth, so the f32 emulation is held to
    twice that distance (and 1e-3). Ragged point counts (rays straddling
    128-row tiles at S = 17, 33 and 96, one ray in a tile of zeros) and
    whole tiles (640 and 256 points) leave the valid rows unchanged."""
    _check_emulation(name, n_rays, S, n_rays)


def _check_emulation(name, n_rays, S, rb):
    """The emulation over blocks of rb rays against _mlp_reference, at
    the bounds of test_tiled_emulation_matches_mlp_reference."""
    net = _packed(name, seed=3)
    rng = np.random.RandomState(n_rays)
    n = n_rays * S
    pe = _bf16(torch.from_numpy(rng.uniform(-1, 1, (n, fr.PE_PAD))
                                .astype(np.float32)))
    pe[:, 63:] = 0.0
    pv_ray = torch.from_numpy(rng.randn(n_rays, 128).astype(np.float32))
    pv = pv_ray.repeat_interleave(S, 0)
    stream, _ = fr.chain_weight_stream(net)
    want64 = fr._mlp_reference(net, pe.double(), pv.double())
    got64 = _emulate(stream, net, pe.double(), pv.double(), block=rb * S)
    assert got64.shape == want64.shape == (n, 4)
    assert _rel(got64, want64) <= 1e-5, _rel(got64, want64)
    got = _emulate(stream, net, pe, pv, block=rb * S)
    want = fr._mlp_reference(net, pe, pv)
    assert got.dtype == want.dtype == torch.float32
    own = _rel(want.double(), want64)
    assert _rel(got.double(), want64) <= max(2 * own, 1e-5), own
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("name,n_rays,S,rb", [
    ("paper", 8, 192, 8), ("paper", 12, 192, 12), ("paper", 19, 192, 8),
    ("paper", 16, 64, 14), ("paper", 37, 32, 35), ("paper", 41, 16, 40),
    ("d2-skip", 23, 64, 22), ("d2-noskip", 5, 5, 51)])
def test_render_block_emulation_matches_mlp_reference(name, n_rays, S, rb):
    """The chain at the render and coarse kernels' shapes: the fine pass's
    192 depths in blocks of 8 rays (12 whole tiles) and of 12 (ring 3),
    and 19 rays in blocks of 8, 8 and 3, whose tiles straddle rays (a ray
    is 1.5 tiles) and whose last block ends in a part-filled tile; the
    coarse pass's 64 depths in blocks of 14 and a short one; the 16 + 16
    sampling's union of 32 in blocks of 35 and the coarse 16 in blocks of
    40, each with a short last block; the non-hierarchical fine pass at 64
    and a handful of depths. Held to _mlp_reference as the delta shapes
    are."""
    _check_emulation(name, n_rays, S, rb)


def _chain_smem_bytes(rb, S, n_cdf, n_union, n_prev, ring):
    """csrc/fused_render.cuh chain_smem_bytes: 1,024 bytes of alignment,
    the ring, two warpgroups' PE / trunk / view tiles, the mbarriers, then
    the per-ray state, each region rounded up to 128 bytes."""
    regions = [3, 3, 1, fr.PED_PAD, 128, S, 4 * S, S, n_cdf, n_union,
               n_prev, n_prev]
    state = sum(-(-4 * rb * x // 128) * 128 for x in regions)
    tiles = 2 * 2 * 64 * (fr.PE_PAD + 256 + 128)
    return 1024 + ring * 2 * fr.STAGE_ELEMS + tiles + 128 + state


class _Lib:
    """The library call the launch plans make, from the layout above."""

    fr_chain_smem_bytes = staticmethod(_chain_smem_bytes)
    fr_chain_smem_bytes_w256 = fr_chain_smem_bytes


@pytest.mark.parametrize("S,n_imp,plan,smem", [
    (192, 0, (12, 3), 228608), (64, 128, (20, 3), 229632),
    (32, 0, (44, 3), 228480), (16, 16, (48, 3), 224768),
    (64, 0, (30, 3), 231168), (5, 0, (51, 3), 205312)])
def test_render_plans_fill_their_tiles_and_the_shared_memory(S, n_imp, plan,
                                                             smem):
    """The render (n_imp 0) and coarse kernels' plans: a 3-stage ring, the
    most rays that fit beside it but for a last tile that would leave more
    than 1/32 of the block's tile rows empty; one more ray does not fit or
    would leave such a tile. (The card's library gave these bytes, and
    those of the 4-stage plans, from its own layout.)"""
    widths = fr._state_widths(S, n_imp)
    rb, ring = fr._render_plan(_Lib(), S, *widths)
    assert (rb, ring) == plan
    assert _chain_smem_bytes(rb, S, *widths, 0, ring) == smem
    assert smem <= fr.SMEM_LIMIT

    def tail(r):
        rows = -(-r * S // fr.CHAIN_TILE) * fr.CHAIN_TILE
        return (rows - r * S) / rows

    assert tail(rb) <= fr._MAX_TAIL
    assert (_chain_smem_bytes(rb + 1, S, *widths, 0, ring) > fr.SMEM_LIMIT
            or tail(rb + 1) > fr._MAX_TAIL)


def test_render_plan_gives_up_ring_stages_before_it_refuses():
    """Depths too many for one ray beside a 3-stage ring take fewer
    stages (down to 2); more than fit beside 2 raise."""
    rb, ring = fr._render_plan(_Lib(), 3000, 0, 0)
    assert (rb, ring) == (1, 2)
    assert _chain_smem_bytes(1, 3000, 0, 0, 0, ring) <= fr.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        fr._render_plan(_Lib(), 4000, 0, 0)


def test_each_net_streams_its_own_weights():
    """The operands a chain kernel gets from one net hold that net's
    matrices: the coarse net's stream reads back to the coarse net and
    not to the fine one."""
    coarse, fine = _packed("paper", seed=1), _packed("paper", seed=2)
    for net, other in ((coarse, fine), (fine, coarse)):
        _, keep, ptr, n_stages = fr._chain_args(net, "cpu")
        stream = keep[1]
        assert ptr == stream.data_ptr() and n_stages == 69
        back = fr.chain_stream_matrices(stream, net)
        assert all(torch.equal(back[f"w{i}"], w) for i, w in
                   enumerate(net.w))
        assert torch.equal(back["w_alpha"], net.w_alpha)
        assert not torch.equal(back["w1"], other.w[1])


def test_render_rays_fused_hands_each_net_to_its_pass(monkeypatch):
    """The coarse kernel gets the coarse net and the fine kernel the fine
    one, in the hierarchical branch and the plain-sampler one (lindisp),
    where both passes are fine-kernel launches."""
    cfg = ExperimentConfig(dim_aud=16, dim_expr=8, dim_latent=4,
                           netdepth=2, netwidth=64)
    ncfg = cfg.face_nerf_config()
    gen = torch.Generator().manual_seed(0)
    nets = {k: FaceNeRF(ncfg, gen) for k in ("coarse", "fine")}
    cond = (torch.ones(16), torch.ones(8), torch.ones(4))
    with torch.no_grad():
        folded = {k: fold_conditioning(m, ncfg, *cond)
                  for k, m in nets.items()}
    seen = []
    for name in ("fused_render_coarse_hier", "fused_render_rays"):
        real = getattr(fr, name)

        def spy(params, *a, _real=real, _name=name, **kw):
            seen.append((_name, params))
            return _real(params, *a, **kw)

        monkeypatch.setattr(fr, name, spy)
    rng = np.random.RandomState(0)
    ro = torch.from_numpy(np.tile([[0.0, 0.0, 1.5]], (4, 1)).astype(
        np.float32))
    rd = torch.from_numpy((rng.randn(4, 3) * 0.08 + [0, 0, -1]).astype(
        np.float32))
    bc = torch.from_numpy(rng.uniform(0, 1, (4, 3)).astype(np.float32))
    with torch.no_grad():
        for lindisp, first in ((False, "fused_render_coarse_hier"),
                               (True, "fused_render_rays")):
            seen.clear()
            fr.render_rays_fused(nets["coarse"], folded["coarse"], ncfg, ro,
                                 rd, bc, 0.6, 1.2, 8, 8, nets["fine"],
                                 folded["fine"], lindisp=lindisp)
            assert seen == [(first, nets["coarse"]),
                            ("fused_render_rays", nets["fine"])]


# ------------------------------------------------- the point kernels K4, K5

@pytest.mark.parametrize("name", list(NETS))
def test_point_stream_round_trips_with_its_dir_stage(name):
    """The point kernels' stream holds view layer 0's dir-PE part as one
    more stage after its h-part: it reads back bitwise with every other
    matrix, the stage is zero past the net's PED_PAD rows (and past the
    27 dir-PE lanes of the paper widths), the rest of the stream is the
    ray kernels' stream stage for stage, and the order is the header's:
    70 stages for the paper model, whose ray stream stays 69."""
    net = _packed(name)
    stream, order = fr.chain_weight_stream(net, dir_stage=True)
    assert order == _expected_order(net, dir_stage=True)
    back = fr.chain_stream_matrices(stream, net, dir_stage=True)
    assert torch.equal(back["wv0d"], net.wv0d)
    assert set(back) == set(fr.chain_stream_matrices(
        fr.chain_weight_stream(net)[0], net)) | {"wv0d"}
    img = stream.reshape(-1, fr.STAGE_ELEMS)
    q = order.index(("wv0d", 0))
    idx = fr.swizzle_image_index(64, 128)
    stage = img[q][idx]
    assert torch.all(stage[27:] == 0) and torch.equal(stage[:fr.PED_PAD],
                                                      net.wv0d)
    ray, ray_order = fr.chain_weight_stream(net)
    keep = torch.ones(len(order), dtype=torch.bool)
    keep[q] = False
    assert torch.equal(img[keep], ray.reshape(-1, fr.STAGE_ELEMS))
    if name == "paper":
        assert (len(order), len(ray_order)) == (70, 69)


def _point_inputs(n: int, seed: int):
    """n points in [-1, 1]^3 and unit directions (the training field's
    dirs are the rays' unit view directions), seeded with numpy."""
    rng = np.random.RandomState(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pts, torch.from_numpy(d)


@pytest.mark.parametrize("name,n", [
    ("paper", 1), ("paper", 127), ("paper", 1001), ("paper", 4096),
    ("d2-skip", 127), ("d2-skip", 1001), ("d2-noskip", 1),
    ("d2-noskip", 4096)])
@pytest.mark.parametrize("encoded", [False, True])
def test_point_emulation_matches_point_mlp_references(name, n, encoded):
    """The chain at the point kernels' shape, per-point PE (built from the
    points as K4 builds it, or the PE rows K5 is given) and the dir-PE
    product in view layer 0 with bv[0] as its bias, in runs of 3 tiles
    per block (a ragged last tile at N = 127 and 1,001, one point in a
    tile of zeros at N = 1), against point_mlp_reference (K4) or
    point_mlp_pe_reference (K5) at the ray emulation's bounds: 1e-5
    norm-relative in f64, and in f32 twice the reference's own distance
    from f64 (at least 1e-5) and 1e-3."""
    net = _packed(name, seed=5)
    pts, dirs = _point_inputs(n, seed=n)
    pe, ped = fm.encode_points(net, pts, dirs)
    if encoded:
        want = fm.point_mlp_pe_reference(net, pe.to(torch.bfloat16),
                                         ped.to(torch.bfloat16))
    else:
        want = fm.point_mlp_reference(net, pts, dirs)
    stream, _ = fr.chain_weight_stream(net, dir_stage=True)
    block = 3 * fr.CHAIN_TILE
    bv0 = net.bv[0].expand(n, -1)
    want64 = fr._mlp_reference(net, pe.double(), ped.double()
                               @ net.wv0d.double() + net.bv[0].double())
    got64 = _emulate(stream, net, pe.double(), bv0.double(), block=block,
                     ped=ped.double())
    assert got64.shape == want64.shape == want.shape == (n, 4)
    assert _rel(got64, want64) <= 1e-5, _rel(got64, want64)
    got = _emulate(stream, net, pe, bv0, block=block, ped=ped)
    assert got.dtype == want.dtype == torch.float32
    own = _rel(want.double(), want64)
    assert _rel(got.double(), want64) <= max(2 * own, 1e-5), own
    assert _rel(got, want) <= 1e-3


def _point_smem_bytes(ring):
    """csrc/fused_mlp.cuh point_smem_bytes: 1,024 bytes of alignment, the
    ring, two warpgroups' PE / trunk / view / dir-PE tiles, the
    mbarriers."""
    tiles = 2 * 2 * 64 * (fr.PE_PAD + 256 + 128 + 64)
    return 1024 + ring * 2 * fr.STAGE_ELEMS + tiles + 128


class _PointLib:
    """The library call the point plan makes, from the layout above."""

    fr_point_smem_bytes = staticmethod(_point_smem_bytes)
    fr_point_smem_bytes_w256 = fr_point_smem_bytes


@pytest.mark.parametrize("N,plan", [
    (131072, (8, 128)), (393216, (24, 128)), (524288, (32, 128)),
    (1 << 21, (125, 132)), (1001, (1, 8)), (1, (1, 1)),
    (128 * 132 + 1, (2, 67))])
def test_point_plans_cover_every_point_once_in_one_wave(N, plan):
    """The point kernels' plan on a 132-SM card: tiles per block =
    ceil(tiles / 132), each block a contiguous run of them, at most one
    wave of blocks; the coarse (2,048 x 64) and fine (2,048 x 192) passes
    of the training step, both of phase 6's 524,288, and K5's 2^21 as
    named, every point covered exactly once; the ring's shared memory
    fits beside the tiles."""
    per_block, blocks, ring = fm._point_plan(_PointLib(), N, 132)
    assert (per_block, blocks) == plan
    assert blocks <= 132 and ring == fm._POINT_RING
    assert _point_smem_bytes(ring) <= fr.SMEM_LIMIT
    seen = torch.zeros(N, dtype=torch.int32)
    for b in range(blocks):
        p0 = b * per_block * fr.CHAIN_TILE
        assert p0 < N
        seen[p0:min(p0 + per_block * fr.CHAIN_TILE, N)] += 1
    assert torch.all(seen == 1)


def test_point_plan_refuses_a_ring_the_shared_memory_cannot_hold():
    """Six 16 KB stages fit beside the point tiles (230,528 bytes), seven
    do not."""
    assert fm._point_plan(_PointLib(), 1000, 132, ring=6)[2] == 6
    assert _point_smem_bytes(6) == 230528
    with pytest.raises(ValueError, match="shared memory"):
        fm._point_plan(_PointLib(), 1000, 132, ring=7)
