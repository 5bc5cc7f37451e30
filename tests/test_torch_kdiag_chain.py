"""The kernel-diagnosis probes on the wgmma chain, on the CPU: the bf16
chain (kernels/kdiag.py ``chain``, csrc/kdiag.cu ``k_chain_wg``) and render
probe B (``render_probe_b``, K1's chain without compositing).

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
and fits the shared memory.

Bounds, as tests/test_torch_kdiag.py's: within 3e-2 of the output's max abs
with a correlation above 0.999 (every layer rounds to bf16 on both sides,
and a sum taken in another order can land one ulp apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.kernels import kdiag as kd
from scripts import kdiag, kdiag4

ATOL = 3e-2
MIN_CORR = 0.999
W = 256
KC = 32  # K-rows per stage of a 256-wide layer
BF16_MODES = kd.CHAIN_MODES[torch.bfloat16]


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


class _Lib:
    """The library calls probe B's plan makes, from the layouts above."""

    fr_chain_smem_bytes = staticmethod(_k1_smem_bytes)
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
    rb, ring = kd._render_b_plan(lib, S)
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
