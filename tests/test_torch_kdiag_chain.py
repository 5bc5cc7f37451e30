"""The kernel-diagnosis probes on the wgmma chain, on the CPU: the bf16
chain (kernels/kdiag.py ``chain``, csrc/kdiag.cu ``k_chain_wg``), the
ladder's rungs v0-v2 (``ladder``, K5's chain stopped after its trunk or
view branch), render probe A (``render_probe_a``, K1's chain on given PE
rows) and render probe B (``render_probe_b``, K1's chain without
compositing).

The kernels run only on the card (chip_smoke.py phase 11 holds them against
their plain versions there). Here: the chain's weight stream round-trips
through its plain inverse, eight 16 KB stages a layer in layer order, and is
built once per weights; a plain emulation of the kernel's order of work
(64-row warpgroup tiles with zeros past the last row, each layer summed one
32-row K-stage at a time from the stream's swizzled images in f32, the mode's
epilogue rounded to bf16 into the tile; ``sum`` multiplying the input by
every layer into one accumulator) agrees with ``chain_reference`` and with
the JAX package's probe kernels (scripts/kdiag.py, kdiag4.py) under
``pl.pallas_call(..., interpret=True)`` on ragged rows, for every bf16 mode;
and probe B's launch plan is K1's, covers every ray once, fills its tiles
and fits the shared memory. The ladder's streams are prefixes of K5's
stream (v0's of the net without its skip pe-part), and an emulation of
the chain over each prefix (csrc/chain.cuh: ActivationTile's fill, the
stages, the un-swizzled copy out) agrees with ``ladder_reference``; probe
A's tile source (PeRayTile's fill of the PE rows, pv per ray in the
kernel's order) agrees with ``render_probe_a_reference`` over K1's plan,
which is probe A's.

Bounds, as tests/test_torch_kdiag.py's: within 3e-2 of the output's max abs
with a correlation above 0.999 (every layer rounds to bf16 on both sides,
and a sum taken in another order can land one ulp apart).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.kernels import fused_mlp as fm
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF, fold_conditioning
from scripts import kdiag, kdiag4, kdiag5

ATOL = 3e-2
MIN_CORR = 0.999
W = 256
KC = 32  # K-rows per stage of a 256-wide layer
BF16_MODES = kd.CHAIN_MODES[torch.bfloat16]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensor ops on one thread: under the suite's parallel workers
    a thread pool per op made these emulations many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rows, depth, seed):
    """x ~ N(0, 1) and weights ~ 0.05 N(0, 1) from numpy, rounded to bf16
    -> (x, ws) as bf16 tensors."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(rows, W).astype(np.float32))
    ws = torch.from_numpy((rng.randn(depth, W, W) * 0.05).astype(np.float32))
    return x.to(torch.bfloat16), ws.to(torch.bfloat16)


def _bias(mode, depth):
    """kdiag4 V6's bias (li + 1 in layer li) for bias_relu, a small random
    one for relu2 (kdiag.py's k_relu2 takes any), none otherwise."""
    if mode == "bias_relu":
        return (torch.arange(depth, dtype=torch.float32)[:, None]
                + 1.0).expand(depth, W).contiguous()
    if mode == "relu2":
        return torch.from_numpy((np.random.RandomState(depth).randn(depth, W)
                                 * 0.02).astype(np.float32))
    return None


def _rel_close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=ATOL)
    r = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert r > MIN_CORR, r


# ------------------------------------------------------------ the stream

@pytest.mark.parametrize("depth", [2, 8, 16])
def test_chain_stream_round_trips_eight_stages_a_layer(depth):
    """chain_weight_stream is weight_stream of chain_stream_parts: 8
    stages of 32 K-rows a layer, layers in order, each stage the swizzled
    image of its rows; stream_matrices gives every layer back bitwise."""
    _, ws = _inputs(4, depth, seed=depth)
    stream, order = fr.weight_stream(kd.chain_stream_parts(ws))
    assert torch.equal(stream, kd.chain_weight_stream(ws))
    assert stream.dtype == torch.bfloat16
    assert stream.numel() == depth * (W // KC) * fr.STAGE_ELEMS
    assert order == [(f"w{li}", k) for li in range(depth)
                     for k in range(0, W, KC)]
    back = fr.stream_matrices(stream, kd.chain_stream_parts(ws))
    assert sorted(back) == sorted(f"w{li}" for li in range(depth))
    for li in range(depth):
        assert torch.equal(back[f"w{li}"], ws[li])
    img = stream.reshape(-1, fr.STAGE_ELEMS)
    idx = fr.swizzle_image_index(KC, W).reshape(-1)
    q = 8 * (depth - 1) + 3
    assert torch.equal(img[q][idx].reshape(KC, W), ws[depth - 1, 96:128])


def test_chain_stream_is_built_once_per_weights():
    """The wrapper's stream cache: the same weights give the same stream
    object; weights changed in place (a new version) or other weights give
    their own; the cache stays bounded."""
    kd._STREAM_CACHE.clear()
    _, ws = _inputs(4, 2, seed=1)
    first = kd._cached_stream(ws)
    assert kd._cached_stream(ws) is first
    ws.mul_(2)
    again = kd._cached_stream(ws)
    assert again is not first
    assert torch.equal(again, kd.chain_weight_stream(ws))
    for seed in range(2, 2 + 2 * kd._STREAM_CACHE_SIZE):
        kd._cached_stream(_inputs(4, 1, seed)[1])
    assert len(kd._STREAM_CACHE) == kd._STREAM_CACHE_SIZE
    kd._STREAM_CACHE.clear()


# ------------------------------------------------------- the emulation

def _epilogue(acc, mode, b):
    """The kernel's epilogue_pair per mode, as values rounded to bf16."""
    rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    if mode in ("cast", "sum"):
        return rnd(acc)
    if mode == "select":
        return rnd(torch.where(acc > 0, acc, torch.zeros_like(acc)))
    if mode == "cast_max":
        return rnd(acc).clamp_min(0)
    if mode in ("bias_relu", "relu2"):
        return rnd(torch.clamp_min(acc + b, 0))
    return rnd(torch.clamp_min(acc, 0))


def _emulate(x, stream, depth, mode, bias):
    """k_chain_wg's order of work in plain torch -> (rows, 256) f32 of bf16
    values: rows in 64-row warpgroup tiles, zeros past the last row; per
    layer the f32 accumulator takes the layer's 8 stages one at a time,
    each read back from its swizzled image (A's 32 K-columns times the
    stage's 32 K-rows), then the mode's epilogue goes into the tile; sum
    multiplies the input tile by every layer's stages into one accumulator
    and runs the epilogue once."""
    rows = x.shape[0]
    xp = F.pad(x.float(), (0, 0, 0, (-rows) % 64))
    img = stream.reshape(-1, fr.STAGE_ELEMS).float()
    idx = fr.swizzle_image_index(KC, W).reshape(-1)
    stages = [img[q][idx].reshape(KC, W) for q in range(depth * (W // KC))]
    outs = []
    for t0 in range(0, xp.shape[0], 64):
        tile = h = xp[t0:t0 + 64]
        acc = torch.zeros(64, W)
        for li in range(depth):
            if mode != "sum" or li == 0:
                acc = torch.zeros(64, W)
            a = tile if mode == "sum" else h
            for k in range(W // KC):
                acc = acc + a[:, KC * k:KC * (k + 1)] @ stages[8 * li + k]
            if mode == "sum" and li + 1 < depth:
                continue
            h = _epilogue(acc, mode, None if bias is None else bias[li])
        outs.append(h)
    return torch.cat(outs)[:rows]


def _jax_chain(mode, x, ws, bias):
    """The JAX package's probe kernel of the mode under interpret mode on
    the same bf16 inputs -> (rows, 256) f32, or None where no kernel of
    that depth exists (kdiag.py's kernels are 8 layers)."""
    rows, depth = x.shape[0], ws.shape[0]
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jws = [jnp.asarray(w.float().numpy(), jnp.bfloat16) for w in ws]
    if mode == "sum":
        acc = sum(jnp.dot(jx, w, preferred_element_type=jnp.float32)
                  for w in jws)
        return np.asarray(acc.astype(jnp.bfloat16).astype(jnp.float32))
    if mode == "relu2":
        if depth != kdiag.L:
            return None
        out = pl.pallas_call(
            kdiag.k_relu2, out_shape=jax.ShapeDtypeStruct((rows, W),
                                                          jnp.bfloat16),
            interpret=True)(jx, jnp.stack(jws),
                            jnp.asarray(bias.numpy()[:, None, :]))
        return np.asarray(out).astype(np.float32)
    v = {"cast": "V2", "relu": "V0", "bias_relu": "V6", "select": "V5",
         "cast_max": "V7"}[mode]
    with jax.default_matmul_precision("highest"):
        out = pl.pallas_call(
            functools.partial(kdiag4.chain_kernel, v),
            out_shape=jax.ShapeDtypeStruct((rows, W), jnp.float32),
            interpret=True)(jx, *jws)
    return np.asarray(out)


@pytest.mark.parametrize("depth", [2, 8, 16])
@pytest.mark.parametrize("mode", BF16_MODES)
def test_chain_emulation_matches_plain_and_jax(mode, depth):
    """The emulation of the wgmma chain on 100 rows (a part-filled second
    tile) against chain_reference and against the JAX probe of the mode
    (kdiag4.chain_kernel's V0/V2/V5/V6/V7 at any depth, kdiag.py's k_relu2
    at its 8 layers, the JAX sum of the layers' products)."""
    rows = 100
    x, ws = _inputs(rows, depth, seed=10 + depth)
    bias = _bias(mode, depth)
    got = _emulate(x, kd.chain_weight_stream(ws), depth, mode, bias)
    assert got.shape == (rows, W)
    want = kd.chain_reference(x, ws, mode, bias)
    _rel_close(got.numpy(), want.numpy())
    ref = _jax_chain(mode, x, ws, bias)
    if ref is not None:
        _rel_close(got.numpy(), ref)
    assert torch.equal(kd.chain(x, ws, mode, bias, 128), want)


# ------------------------------------------------- probe B's launch plan

def _k1_smem_bytes(rb, S, n_cdf, n_union, n_prev, ring):
    """csrc/fused_render.cu chain_smem_bytes (K1's): 1,024 bytes of
    alignment, the ring, two warpgroups' PE / trunk / view tiles, the
    mbarriers, then the per-ray state, each region rounded up to 128
    bytes."""
    regions = [3, 3, 1, fr.PED_PAD, 128, S, 4 * S, S, n_cdf, n_union,
               n_prev, n_prev]
    state = sum(-(-4 * rb * x // 128) * 128 for x in regions)
    tiles = 2 * 2 * 64 * (fr.PE_PAD + 256 + 128)
    return 1024 + ring * 2 * fr.STAGE_ELEMS + tiles + 128 + state


def _probe_b_smem_bytes(rb, S, ring):
    """csrc/kdiag.cu probe_b_smem: K1's layout without the raw and weight
    rows (ro, rd, |d|, dir-PE, pv, z)."""
    regions = [3, 3, 1, fr.PED_PAD, 128, S]
    state = sum(-(-4 * rb * x // 128) * 128 for x in regions)
    tiles = 2 * 2 * 64 * (fr.PE_PAD + 256 + 128)
    return 1024 + ring * 2 * fr.STAGE_ELEMS + tiles + 128 + state


def _probe_a_smem_bytes(rb, S, ring):
    """csrc/kdiag_pe.cu probe_a_smem: K1's ring, tiles and mbarriers, then
    the dir-PE and pv of each ray."""
    state = sum(-(-4 * rb * x // 128) * 128 for x in (fr.PED_PAD, 128))
    tiles = 2 * 2 * 64 * (fr.PE_PAD + 256 + 128)
    return 1024 + ring * 2 * fr.STAGE_ELEMS + tiles + 128 + state


class _Lib:
    """The library calls the probes' plans make, from the layouts above."""

    fr_chain_smem_bytes = staticmethod(_k1_smem_bytes)
    kd_render_a_smem_bytes = staticmethod(_probe_a_smem_bytes)
    kd_render_b_smem_bytes = staticmethod(_probe_b_smem_bytes)


@pytest.mark.parametrize("S,plan,smem", [
    (192, (12, 3), 182528), (64, (30, 3), 192768), (8, (64, 3), 209792)])
@pytest.mark.parametrize("R", [1001, 8192, 202500])
def test_probe_b_plan_is_k1s_and_covers_every_ray(S, plan, smem, R):
    """Probe B's plan at the fine pass's 192 depths, the coarse pass's 64
    and a handful: K1's rays per block and ring (so K1 less the probe is
    K1's per-ray code and compositing), its shared memory (the card's
    library gave these bytes) below K1's and the limit, every ray of R in
    exactly one block, and the last 128-point tile of a block at most
    1/32 empty."""
    lib = _Lib()
    rb, ring = kd._render_probe_plan(lib, S, "b")
    assert (rb, ring) == plan == fr._render_plan(lib, S, 0, 0)
    assert _probe_b_smem_bytes(rb, S, ring) == smem
    assert smem < _k1_smem_bytes(rb, S, 0, 0, 0, ring) <= fr.SMEM_LIMIT
    rows = -(-rb * S // fr.CHAIN_TILE) * fr.CHAIN_TILE
    assert rows - rb * S <= fr._MAX_TAIL * rows
    seen = torch.zeros(R, dtype=torch.int32)
    for b in range(-(-R // rb)):
        ray0 = b * rb
        assert ray0 < R
        seen[ray0:min(ray0 + rb, R)] += 1
    assert torch.all(seen == 1)


@pytest.mark.parametrize("S,plan,smem", [
    (192, (12, 3), 172672), (64, (30, 3), 184192), (16, (64, 3), 205952),
    (8, (64, 3), 205952)])
@pytest.mark.parametrize("R", [1001, 8192, 202500])
def test_probe_a_plan_is_k1s_and_covers_every_ray(S, plan, smem, R):
    """Probe A's plan is probe B's, K1's rays per block and ring (so B
    less A is the PE built in the kernel); its per-ray state (dir-PE and
    pv) leaves its shared memory (the card's library gave these bytes)
    below probe B's and the limit; every ray of R lies in exactly one
    block."""
    lib = _Lib()
    rb, ring = kd._render_probe_plan(lib, S, "a")
    assert (rb, ring) == plan == kd._render_probe_plan(lib, S, "b")
    assert _probe_a_smem_bytes(rb, S, ring) == smem
    assert smem < _probe_b_smem_bytes(rb, S, ring) <= fr.SMEM_LIMIT
    seen = torch.zeros(R, dtype=torch.int32)
    for ray0 in range(0, R, rb):
        seen[ray0:min(ray0 + rb, R)] += 1
    assert torch.all(seen == 1)


# ------------------------------------------ the ladder and probe A's tiles

# the paper model, and a 2-layer net of the kernel's width whose layer 1
# takes the PE again (its skip)
NETS = {"paper": dict(depth=8), "d2-skip": dict(depth=2, skips=(0,))}


def _packed(name: str, seed: int = 0) -> fr.PackedNet:
    cfg = ExperimentConfig(dim_aud=16, dim_expr=8, dim_latent=4)
    ncfg = dataclasses.replace(cfg.face_nerf_config(), **NETS[name])
    model = FaceNeRF(ncfg, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    cond = [torch.from_numpy(rng.randn(n).astype(np.float32))
            for n in (16, 8, 4)]
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, *cond)
    return fr.pack_operands(model, folded, ncfg)


def _swz(p, f):
    """csrc/hopper.cuh swz: element offset of (row p, lane f) in a 64-row
    K-major swizzled tile."""
    return (((f >> 6) << 12) + ((p >> 3) << 9) + ((p & 7) << 6)
            + ((((f >> 3) & 7) ^ (p & 7)) << 3) + (f & 7))


@functools.lru_cache(maxsize=None)
def _tile_image(lanes):
    """The offsets of a 64-row tile's (row, lane) in its image."""
    return _swz(torch.arange(64)[:, None], torch.arange(lanes)[None])


@functools.lru_cache(maxsize=None)
def _copy_plan(tile_lanes):
    """copy_rows' work for a tile of tile_lanes lanes: thread t copies the
    16-byte chunks t // 64 + 2 j of row t % 64 -> (row, chunk, lanes of
    the chunk, their offsets in the image); every element once."""
    t = torch.arange(128)
    row = (t & 63)[:, None]
    c = (t >> 6)[:, None] + 2 * torch.arange(tile_lanes // 16)[None]
    lane = 8 * c[..., None] + torch.arange(8)
    dest = _swz(row[..., None], lane)
    assert torch.unique(dest).numel() == dest.numel() == 64 * tile_lanes
    return row, c, lane, dest


def _copy_rows(rows, row0, n_pts, tile_lanes):
    """chain.cuh copy_rows for one warpgroup: each thread's chunks of
    rows (zeros at or past n_pts and past the rows' lanes) into the
    swizzled image -> the image read back as the (64, tile_lanes) A
    operand."""
    lanes = rows.shape[1]
    row, c, lane, dest = _copy_plan(tile_lanes)
    src = F.pad(rows.float(), (0, tile_lanes - lanes, 0,
                               max(0, row0 + 64 - rows.shape[0])))
    live = ((row0 + row < n_pts) & (c < lanes // 8))[..., None]
    img = torch.full((64 * tile_lanes,), float("nan"))
    img[dest] = torch.where(live, src[(row0 + row)[..., None], lane], 0.0)
    return img[_tile_image(tile_lanes)]


@functools.lru_cache(maxsize=None)
def _store_plan(width):
    """ActivationTile::store's work: element e copies 16-byte chunk e %
    (width / 8) of row e // (width / 8) -> (row, its lanes, their offsets
    in the image)."""
    e = torch.arange(64 * width // 8)
    row, c = e // (width // 8), e % (width // 8)
    lane = 8 * c[:, None] + torch.arange(8)
    return row, lane, _swz(row[:, None], lane)


def _store_rows(act, row0, n_pts, out):
    """ActivationTile::store for one warpgroup: act (64, width) written
    into its swizzled tile (relu_store's image), then each chunk copied
    to out's row row0 + row where that row is below n_pts."""
    width = act.shape[1]
    img = torch.empty(64 * width)
    img[_tile_image(width)] = act
    row, lane, src = _store_plan(width)
    live = row0 + row < n_pts
    out[(row0 + row)[live][:, None], lane[live]] = img[src[live]]


def _emulate_chain(stream, net, pe, ped, view_bias, last, mats=None):
    """The chain's order of work on one block's points in plain torch:
    128-point tiles of two 64-row warpgroups, each filled by copy_rows
    from the PE rows (and, with ``ped``, the dir-PE rows into a 64-lane
    tile); every layer sums one stage at a time from the stream's
    swizzled images in f32, bf16 after every relu, the skip layers where
    the net has them; view layer 0 adds the dir-PE product (with ``ped``)
    and view_bias(rows), then stops after the trunk or the view branch
    (``last``, the rows copied out by _store_rows) or runs the heads ->
    the block's output rows and the stages consumed per tile. ``mats``
    keeps the stages read back, for the stream's next block."""
    n = pe.shape[0]
    img = stream.reshape(-1, fr.STAGE_ELEMS).float()
    mats = {} if mats is None else mats
    width = {"trunk": 256, "view": 128, "heads": 4}[last]
    out = torch.full((n, width), float("nan"))
    for t0 in range(0, n, 128):
        q = 0

        def prod(acc, a, lanes):
            nonlocal q
            kr = fr.STAGE_ELEMS // lanes
            for k0 in range(0, a.shape[1], kr):
                if q not in mats:
                    mats[q] = img[q][fr.swizzle_image_index(
                        kr, lanes).reshape(-1)].reshape(kr, lanes)
                acc = acc + a[:, k0:k0 + kr] @ mats[q]
                q += 1
            return acc

        halves = (t0, t0 + 64)
        x = torch.cat([_copy_rows(pe, r0, n, 64) for r0 in halves])
        h = _bf16(torch.relu(prod(torch.zeros(128, 256), x, 256) + net.b[0]))
        for i in range(1, len(net.w)):
            acc = prod(torch.zeros(128, 256), x, 256) if i in net.wskip \
                else torch.zeros(128, 256)
            h = _bf16(torch.relu(prod(acc, h, 256) + net.b[i]))
        act = h
        if last != "trunk":
            acc = prod(torch.zeros(128, 128), h, 128)
            if ped is not None:
                acc = prod(acc, torch.cat([_copy_rows(ped, r0, n, 64)
                                           for r0 in halves]), 128)
            hv = _bf16(torch.relu(acc + view_bias(torch.arange(t0,
                                                               t0 + 128))))
            for v in range(1, len(net.wv)):
                hv = _bf16(torch.relu(prod(torch.zeros(128, 128), hv, 128)
                                      + net.bv[v]))
            act = hv
        if last == "heads":
            ia = fr.swizzle_image_index(fr.HEADS, 256).reshape(-1)
            ir = fr.swizzle_image_index(fr.HEADS, 128).reshape(-1)
            wa = img[q][ia].reshape(fr.HEADS, 256).T
            wr = img[q][ia.numel() + ir].reshape(fr.HEADS, 128).T
            q += 1
            raw = (h @ wa + hv @ wr + net.b_heads)[:, :4]
            m = min(128, n - t0)
            out[t0:t0 + m] = raw[:m]
        else:
            for wg, r0 in enumerate(halves):
                _store_rows(act[64 * wg:64 * wg + 64], r0, n, out)
    return out, q


def _bf16(x):
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("name,stages", [("paper", (58, 60, 69)),
                                         ("d2-skip", (10, 12, 17))])
def test_ladder_streams_are_prefixes_of_k5s_stream(name, stages):
    """v1's stream is the trunk's stages of K5's stream, v2's all of it
    but the heads' stage, v0's the trunk's stages of the stream of the net
    without its skip pe-part (58, 60 and 69 for the paper model); each
    ends where the next part of K5's stream begins."""
    net = _packed(name, seed=3)
    k5, order = fr.chain_weight_stream(net, dir_stage=True)
    skipless, order0 = fr.chain_weight_stream(kd.ladder_net(net, 0),
                                              dir_stage=True)
    assert kd.ladder_net(net, 0).wskip == {} and net.wskip
    for stage, want in enumerate(stages):
        stream, n = kd.ladder_stream(net, stage)
        assert n == want
        full, names = (skipless, order0) if stage == 0 else (k5, order)
        assert torch.equal(stream, full[:n * fr.STAGE_ELEMS])
        assert names[n][0] == ("wv0" if stage < 2 else "heads")
        assert all(nm.startswith("w") for nm, _ in names[:n])
        assert any(nm.startswith("wskip") for nm, _ in names[:n]) == (
            stage > 0)
    assert len(order) == stages[2] + 1


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_ladder_emulation_matches_ladder_reference(name, stage):
    """The chain over each rung's stream, stopped at the rung, on 100
    points (the second warpgroup's tile part-filled), its last activation
    copied out through the swizzled tile: every stage consumed once, and
    within 3e-2 of ladder_reference's max abs, correlation > 0.999."""
    net = _packed(name, seed=4)
    rng = np.random.RandomState(stage)
    pts = torch.from_numpy(rng.uniform(-1, 1, (100, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.randn(100, 3).astype(np.float32))
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    pe, ped = (x.to(torch.bfloat16) for x in fm.encode_points(net, pts,
                                                              dirs))
    stream, n_stages = kd.ladder_stream(net, stage)
    got, q = _emulate_chain(
        stream, kd.ladder_net(net, stage), pe, ped if stage == 2 else None,
        lambda rows: net.bv[0], ("trunk", "trunk", "view")[stage])
    assert q == n_stages
    want = kd.ladder_reference(net, pe, ped, stage)
    assert got.shape == want.shape == (100, 256 if stage < 2 else 128)
    _rel_close(got.numpy(), want.float().numpy())
    assert torch.equal(kd.ladder(net, pe, ped, stage), want)


def _view_terms(ped, wv0d, bv0):
    """render_body.cuh view_terms: pv = ped @ wv0d + bv0, the sum over the
    dir-PE lanes in order, one f32 rounding a step."""
    a = torch.zeros(ped.shape[0], wv0d.shape[1])
    for k in range(ped.shape[1]):
        a = a + ped[:, k:k + 1].float() * wv0d[k].float()
    return a + bv0


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("R", [77, 130])
def test_probe_a_tile_source_matches_plain(S, R):
    """Probe A over K1's plan (64 rays a block at S 8 and 16; the last
    block ragged): each block's pv in view_terms' order (within 1e-5 of
    ped @ wv0d + bv0), tiles filled from the block's PE rows by
    copy_rows, view layer 0's bias the row's ray's pv (clamped to the
    block's last ray), the heads' raw rows, against
    render_probe_a_reference: 3e-2 absolute and correlation > 0.999 per
    lane."""
    net = _packed("paper", seed=6)
    rng = np.random.RandomState(R + S)
    o = torch.from_numpy(rng.rand(R, 3).astype(np.float32))
    d = torch.from_numpy(rng.randn(R, 3).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.linspace(0.58, 1.18, S)[None].expand(R, S).contiguous()
    pe, ped = kd.encode_rays(net, o, d, z)
    rb, _ = kd._render_probe_plan(_Lib(), S, "a")
    stream, order = fr.chain_weight_stream(net)
    parts, mats = [], {}
    for ray0 in range(0, R, rb):
        nr = min(rb, R - ray0)
        pv = _view_terms(ped[ray0:ray0 + nr], net.wv0d, net.bv[0])
        np.testing.assert_allclose(
            pv.numpy(), (ped[ray0:ray0 + nr].float() @ net.wv0d.float()
                         + net.bv[0]).numpy(), atol=1e-5)
        raw, q = _emulate_chain(
            stream, net, pe[ray0 * S:(ray0 + nr) * S], None,
            lambda rows: pv[torch.clamp(rows // S, max=nr - 1)], "heads",
            mats)
        assert q == len(order)
        parts.append(raw)
    got = torch.cat(parts).reshape(R, S * 4)
    want = kd.render_probe_a_reference(net, pe, ped, S)
    for c in range(4):
        g, w = got.reshape(-1, 4)[:, c], want.reshape(-1, 4)[:, c]
        assert float((g - w).abs().max()) <= ATOL
        assert np.corrcoef(g.numpy(), w.numpy())[0, 1] > MIN_CORR
    assert torch.equal(kd.render_probe_a(net, pe, ped, S), want)


# ------------------------------------------- the f32 and int8 chains

I8 = kd.I8_STAGE_ROWS  # N rows and K bytes of an int8 stage
F32_KS = 16  # K-rows of a 256-wide f32 stage (16 KB)


def _int8_inputs(rows, depth, seed):
    """kdiag5.py's int8 inputs from numpy: x uniform in [-127, 127],
    weights in [-4, 4]."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (rows, W)).astype(np.int8)
    ws = rng.randint(-4, 5, (depth, W, W)).astype(np.int8)
    return torch.from_numpy(x), torch.from_numpy(ws)


def _swizzled(linear):
    """wgmma's 128-byte swizzle on byte offsets from a 1,024-byte aligned
    base: the 16-byte chunk bits 4-6 XOR the row bits 7-9."""
    return linear ^ (((linear >> 7) & 7) << 4)


def _k_major(rows, nbytes):
    """Byte offsets a K-major 128-byte-swizzled descriptor (SBO 1,024)
    reads for (row, byte) of a rows x nbytes operand at its start
    address: groups of 8 rows 1,024 bytes apart, 128 bytes a row."""
    p = torch.arange(rows)[:, None]
    k = torch.arange(nbytes)[None, :]
    return ((p >> 3) << 10) + ((p & 7) << 7) + k


@pytest.mark.parametrize("depth", [2, 8, 16])
def test_int8_stream_is_each_layers_transpose_stage_by_stage(depth):
    """chain_weight_stream_i8: 4 stages of 16 KB a layer, (N half, K half)
    = (0, 0), (0, 1), (1, 0), (1, 1); a stage read back through the
    hardware's swizzle from its K-major image is 128 rows of W_l^T (N) by
    128 of its bytes (K), and the stream holds every weight byte exactly
    once."""
    _, ws = _int8_inputs(4, depth, seed=depth)
    stream = kd.chain_weight_stream_i8(ws)
    assert stream.dtype == torch.int8 and stream.numel() == depth * 4 * 16384
    img = stream.reshape(depth * 4, 16384)
    read = _swizzled(_k_major(I8, I8))
    for q in range(4 * depth):
        li, h, kb = q // 4, (q >> 1) & 1, q & 1
        want = ws[li].T[I8 * h:I8 * (h + 1), I8 * kb:I8 * (kb + 1)]
        assert torch.equal(img[q][read], want), q
    gather = kd._i8_stream_gather("cpu")
    assert torch.equal(torch.sort(gather).values, torch.arange(W * W))


def test_int8_stream_is_built_once_per_weights():
    """The wrapper's stream cache takes int8 weights as bf16 ones: the
    same weights give the same stream object, changed weights their own."""
    kd._STREAM_CACHE.clear()
    _, ws = _int8_inputs(4, 2, seed=1)
    first = kd._cached_stream(ws)
    assert torch.equal(first, kd.chain_weight_stream_i8(ws))
    assert kd._cached_stream(ws) is first
    ws.add_(1)
    assert torch.equal(kd._cached_stream(ws), kd.chain_weight_stream_i8(ws))
    kd._STREAM_CACHE.clear()


def test_int8_requant_through_magic_is_the_plain_requant():
    """The int8 kernel's I0 requant without I2F or F2I (kdiag_dtype.cu
    requant, mirrored in numpy f32): relu(acc) as the float of bits
    0x4B000000 | a less 2^23, the scale and +0.5 rounded apart, then 2^23
    + min(q, 127) rounded toward zero, whose low byte is the result; and
    the copy-out's byte as the float of 0x4B0000bb less 2^23. Bitwise the
    plain requant for every relu(acc) an int8 chain can give (0..2^22) at
    every layer's scale."""
    acc = np.arange(0, 2 ** 22 + 1, dtype=np.int64)
    a = acc.astype(np.uint32)
    f = (a | np.uint32(0x4B000000)).view(np.float32) - np.float32(2 ** 23)
    assert np.array_equal(f, acc.astype(np.float32))
    for li in range(0, 64, 3):
        q = f * kd.i0_scale(li).numpy() + np.float32(0.5)
        v = np.minimum(q, np.float32(127)).astype(np.float64)
        rz = np.floor(v + 2 ** 23).astype(np.float32)  # exact below 2^24
        got = (rz.view(np.uint32) & 0xFF).astype(np.int8)
        want = kd._requant(torch.from_numpy(acc), "i0", li).numpy()
        assert np.array_equal(got, want), li
    b = np.arange(128, dtype=np.uint32)
    out = (b | np.uint32(0x4B000000)).view(np.float32) - np.float32(2 ** 23)
    assert np.array_equal(out, b.astype(np.float32))


def _fragment():
    """wgmma's accumulator fragment of a 64 x 128 N half, as the requant
    writes it: (row, column) of value i of thread t of the warpgroup (warp
    t / 32, lane l): rows 16 w + l / 4 (+ 8 for i % 4 >= 2), columns
    8 (i / 4) + 2 (l % 4) + i % 2 -> two (128, 64) index tensors."""
    t = torch.arange(128)[:, None]
    i = torch.arange(64)[None, :]
    w, lane = t >> 5, t & 31
    row = 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1)
    col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
    return row, col


def _emulate_i8(x, stream, depth, mode):
    """k_chain_i8_wg's order of work in plain torch -> (rows, 256) f32:
    64-row warpgroup tiles, zeros past the last row, written into the
    tile's K-major image at swz8 (``swizzle_image_index_i8``); per layer
    each N half sums its two stages' four k32 products, A and B read at
    the descriptors' start addresses through the hardware's swizzle, in
    s32 (exact in f64); the requant goes into the image in the
    accumulator's fragment order; the last image's rows go out."""
    rows = x.shape[0]
    tile_img = kd.swizzle_image_index_i8(64)
    stages = stream.reshape(-1, 16384).double()
    a_read = _k_major(64, 32)  # a k32 slice of A from its start address
    f_row, f_col = _fragment()
    cover = torch.zeros(64, W, dtype=torch.int32)
    for half in (0, 1):
        cover.index_put_((f_row, f_col + I8 * half),
                         torch.ones_like(f_row, dtype=torch.int32),
                         accumulate=True)
    assert torch.all(cover == 1)
    outs = []
    for t0 in range(0, rows, 64):
        n = min(64, rows - t0)
        tile = torch.zeros(2 * 8192, dtype=torch.float64)
        vals = torch.zeros(64, W, dtype=torch.float64)
        vals[:n] = x[t0:t0 + n].double()
        tile[tile_img] = vals
        for li in range(depth):
            acc = torch.zeros(64, W, dtype=torch.float64)
            for s in range(4):
                half, kb = s >> 1, s & 1
                st = stages[4 * li + s]
                for j in range(4):
                    start = 8192 * kb + 32 * j
                    a = tile[_swizzled(start + a_read)]
                    b = st[_swizzled(32 * j + _k_major(I8, 32))]
                    acc[:, I8 * half:I8 * (half + 1)] += a @ b.T
            assert acc.abs().max() < 2 ** 24  # s32 -> f32 exact
            q = kd._requant(acc.long(), mode, li).double()
            for half in (0, 1):
                r, c = f_row, f_col + I8 * half
                tile[tile_img[r, c]] = q[r, c]
        outs.append(tile[tile_img][:n])
    return torch.cat(outs).float()


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("mode", ["i0", "i1"])
def test_int8_emulation_is_bitwise_plain_and_jax(mode, depth):
    """The emulation of the int8 wgmma chain on 1,001 rows (a part-filled
    last tile) is bitwise chain_reference and the JAX package's kdiag5.py
    chain_kernel (I0 or I1) under interpret mode."""
    rows = 1001
    x, ws = _int8_inputs(rows, depth, seed=20 + depth)
    got = _emulate_i8(x, kd.chain_weight_stream_i8(ws), depth, mode)
    want = kd.chain_reference(x, ws, mode)
    assert torch.equal(got, want)
    v = "I1" if mode == "i1" else "I0"
    ref = pl.pallas_call(
        functools.partial(kdiag5.chain_kernel, v),
        out_shape=jax.ShapeDtypeStruct((rows, W), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()),
                        *[jnp.asarray(w.numpy()) for w in ws])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if depth == 2:
        assert float(want.mean()) > 1.0  # the requant keeps a signal


def _emulate_f32(x, ws, rpb=128):
    """k_chain_f32_ring's order of work in plain torch: the stream is ws
    itself, 16-row K-slabs in order; per tile of rpb rows (zeros past the
    last row) and layer, each output the FFMAs of its row and column, k
    ascending (an f64 sum of the exact product rounded to f32 stands in
    for the fused one), relu in place, the last layer's rows out."""
    rows, depth = x.shape[0], ws.shape[0]
    slabs = ws.reshape(-1, F32_KS * W)  # the stages, 16 KB each
    assert slabs.shape[0] == depth * (W // F32_KS)
    xp = F.pad(x, (0, 0, 0, (-rows) % rpb))
    outs = []
    for t0 in range(0, xp.shape[0], rpb):
        h = xp[t0:t0 + rpb]
        for li in range(depth):
            acc = torch.zeros(rpb, W)
            for q in range(W // F32_KS):
                slab = slabs[li * (W // F32_KS) + q].reshape(F32_KS, W)
                for kk in range(F32_KS):
                    k = F32_KS * q + kk
                    acc = (acc.double() + h[:, k:k + 1].double()
                           * slab[kk].double()).float()
            h = torch.clamp_min(acc, 0)
        outs.append(h)
    return torch.cat(outs)[:rows]


@pytest.mark.parametrize("rows", [100, 150])
def test_f32_slab_order_matches_plain_and_jax(rows):
    """The emulation of the f32 FFMA ring on its 128-row tiles, at 100
    rows (one part-filled tile) and 150 (a full one and a part-filled
    one), 8 layers, within 1e-5 of the output's max abs of
    chain_reference and of kdiag4.py's V3 under interpret mode (f32
    products, the sums in another order)."""
    rng = np.random.RandomState(30 + rows)
    x = torch.from_numpy(rng.randn(rows, W).astype(np.float32))
    ws = torch.from_numpy((rng.randn(8, W, W) * 0.05).astype(np.float32))
    got = _emulate_f32(x, ws)
    want = kd.chain_reference(x, ws, "relu")
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    with jax.default_matmul_precision("highest"):
        ref = pl.pallas_call(
            functools.partial(kdiag4.chain_kernel, "V3"),
            out_shape=jax.ShapeDtypeStruct((rows, W), jnp.float32),
            interpret=True)(jnp.asarray(x.numpy()),
                            *[jnp.asarray(w.numpy()) for w in ws])
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) <= 1e-5 * scale


SM_BYTES = 233472  # shared memory of an SM, 1,024 bytes kept per block


@pytest.mark.parametrize("rows", [1, 63, 1001, (1 << 20) + 77])
@pytest.mark.parametrize("dtype,rpb", [(d, r) for d in kd.CHAIN_PLANS
                                       for r in kd.CHAIN_PLANS[d]])
def test_chain_plans_cover_every_row_once_in_one_wave(dtype, rpb, rows):
    """The chains' plans (kd.chain_plan, which chip_smoke.py holds against
    the card's library) on an H100's 132 SMs: every row in exactly one
    block's run of tiles, at most one wave of blocks, each block's shared
    memory under the limit and a wave's blocks on an SM under its 228
    KB; f32 128 rows a tile (16 x 8 a thread, 384 threads), int8 and bf16
    two blocks an SM at 64 and one at 128."""
    sms = 132
    plan = kd.chain_plan(rows, rpb, dtype, sms)
    ring, per_sm = kd.CHAIN_PLANS[dtype][rpb]
    assert plan["ring_stages"] == ring
    assert plan["blocks"] <= sms * per_sm
    assert plan["smem_bytes"] <= fr.SMEM_LIMIT
    assert per_sm * (plan["smem_bytes"] + 1024) <= SM_BYTES
    if dtype == torch.float32:
        assert plan["threads"] == 384 and per_sm == 1
        assert plan["smem_bytes"] == 1024 + 4 * 16384 + 4 * rpb * W + 128
    else:
        assert plan["threads"] == 2 * rpb + 32
    seen = torch.zeros(rows, dtype=torch.int32)
    span = plan["tiles_per_block"] * rpb
    for b in range(plan["blocks"]):
        assert b * span < rows  # no block without a row
        seen[b * span:(b + 1) * span] += 1
    assert torch.all(seen == 1)
