// The wgmma chain: the field MLP of a net's points on Hopper (sm_90a), run
// by every production forward kernel: the ray kernels of fused_render.cuh
// (K1-K3) and the point kernels of fused_mlp.cuh (K4, K5). A template over
// the net's widths (Layout<W>: W = 128, 256 or 512, view branch W / 2).
//
// - Weight stream. The wrapper lays the net's bf16 weights out in one
//   buffer of 16 KB stages, in the order the chain consumes them, each
//   stage already in wgmma's 128-byte-swizzled shared-memory image
//   (kernels/fused_render.py: chain_weight_stream). A stage holds KC_W =
//   8192 / W K-rows of a W-wide matrix (64 at W=128, 32 at 256, 16 at
//   512) or KC_V = 8192 / WV of a view-wide one, MN-major; a matrix with
//   fewer K-rows than a stage (W=128's 64 x 64 view layers) fills part of
//   one, its other rows zero:
//     layer 0          (64 x W)
//     layer i = 1..D-1 skip pe-part (64 x W) first if layer i is a skip
//                      layer; then (W x W)
//     view layer 0     (W x WV)
//     [dir-PE part of view layer 0 (PED_PAD x WV), one stage, rows past
//      PED_PAD zero: the point kernels' stream only]
//     view layer v     (WV x WV)
//     heads            w_alpha^T (16 x W) then w_rgb^T (16 x WV), K-major:
//                      one stage at W <= 256, two at 512
//   69 stages (1.1 MB) for the paper model at W=256 (D=8, skip at 5, 3
//   view layers), 70 with the dir-PE stage.
// - Block: 288 threads, two consumer warpgroups and one producer warp.
//   The producer's one thread keeps a ring of 2-8 stages filled by
//   cp.async.bulk on mbarriers, the stage sequence repeated for every tile
//   without draining between tiles; both warpgroups read each stage, so
//   the weights cross L2 once per tile.
// - W <= 256 (chain_tile): a tile is 128 points, 64 rows per warpgroup.
//   Per layer A is the warpgroup's activation tile in shared memory
//   (K-major, 128-byte swizzle: swz), B the stage, the accumulator (64 x W
//   f32, W / 2 registers a thread) stays in registers; one wgmma group in
//   flight, the stage before it released. The epilogue adds the bias,
//   applies relu, rounds to bf16 and writes back in place into the same
//   tile; the skip layer adds PE x W_pe into the same accumulator. The
//   heads are an n16 product whose columns 0..3 are the raw [rgb logits,
//   sigma].
// - W = 512 (chain_tile_split): a 64 x 512 f32 accumulator is 256
//   registers a thread, past the 255 a thread may hold. So a tile is 64
//   points and the two warpgroups share it: each computes one half of
//   every layer's columns (an n256 product in the trunk, n128 in the view
//   branch, 128 registers) from the whole input tile, reading its half of
//   each stage's lanes. A layer's halves cannot be written in place (the
//   other warpgroup still reads the input), so the trunk's activations
//   ping-pong between two 64 KB tiles, and the view branch's between the
//   two halves of whichever of them the trunk has finished with; one
//   barrier of both warpgroups per layer. Warpgroup 0 builds the tile's PE
//   and runs the heads (two stages, which warpgroup 1 takes and releases).
//   Each stage's weights serve 64 points, not 128. The block has a whole
//   producer warpgroup, which gives the consumers registers for the chain
//   (setmaxnreg: CHAIN_PRODUCER_REGS / CHAIN_CONSUMER_REGS) and takes its
//   own back after it.
// - What a kernel brings (the tile source Src, a template parameter, which
//   names its Layout as Src::T): the fill of a tile's xyz-PE (from ray
//   packets, from points, or from PE rows), whether view layer 0 adds a
//   per-point dir-PE product (then its bias is bv[0]) or a per-ray term,
//   where the chain stops (Src::kLast: through the heads for every
//   production kernel, or after the trunk or the view branch for kdiag.cu's
//   ladder) and where its rows go. The sources live here: RayTile (the ray
//   kernels, and kdiag.cu's probe B, whose raw rows go to global memory),
//   PeRayTile (probe A: RayTile's per-ray term, the PE rows given),
//   PointTile (K4, K5) and ActivationTile (the ladder: PointTile's encoded
//   fill, the last activation written out). The probes run at W=256 only
//   (paper.cuh).
// - The gradient kernel's pass A (fused_mlp_grad.cuh) runs the same pieces
//   (chain_begin, chain_produce, Ring, prod, relu_store with its relu'
//   bits, PointTile) forward without the heads, then backward on a second
//   stream of the transposed matrices.
#pragma once

#include "hopper.cuh"
#include "render_body.cuh"

namespace fr {

constexpr int D_THREADS = 288;     // two consumer warpgroups + producer warp
constexpr int MAX_RING = 8;        // weight ring depth at most
constexpr int CONSUMER_WARPS = 8;  // each releases a stage once
constexpr int STAGE_ELEMS = 8192;  // bf16 per stage
constexpr int STAGE_BYTES = 2 * STAGE_ELEMS;
constexpr int PE_TILE = 2 * 64 * PE_PAD;
constexpr int PED_TILE = 2 * 64 * 64;  // dir-PE, 64 K-lanes (27 used)
constexpr uint32_t NO_STAGE = 0xFFFFFFFFu;

static_assert(PE_PAD == 64 && HEADS == 16 && PED_PAD <= 64,
              "the chain's stages are laid out for 64 PE lanes");

// The chain's layout at trunk width W_ (view branch W_ / 2).
template <int W_>
struct Layout : Width<W_> {
  static_assert(W_ == 128 || W_ == 256 || W_ == 512,
                "the chain is built at W = 128, 256 and 512");
  using Width<W_>::W;
  using Width<W_>::WV;
  // the warpgroups split each layer's columns (W=512) or its rows
  static constexpr bool kSplit = W_ > 256;
  static constexpr int DT = kSplit ? 64 : 128;  // points per tile
  // threads a block: two consumer warpgroups and a producer warp, or at
  // W=512 a whole producer warpgroup, so that setmaxnreg can move its
  // registers to the consumers (ptxas gives a 288-thread block 168 a
  // thread, where the split chain spilled)
  static constexpr int THREADS = kSplit ? 384 : D_THREADS;
  // columns of a trunk / view product a warpgroup computes, and its
  // accumulator registers (a thread holds 2 of every 8 columns of 16 rows)
  static constexpr int CW = kSplit ? W_ / 2 : W_;
  static constexpr int CV = kSplit ? WV / 2 : WV;
  static constexpr int NRW = CW / 2, NRV = CV / 2;
  static constexpr int ACC = NRW;
  static constexpr int KC_W = STAGE_ELEMS / W_;  // K-rows a stage, W wide
  static constexpr int KC_V = STAGE_ELEMS / WV;  // K-rows a stage, WV wide
  // k16 steps a stage of a WV x WV matrix (it fills half a stage at
  // W=128), and K of view layer 0's dir-PE product: one stage, PED_PAD <=
  // DIR_K <= 64
  static constexpr int KS_V = (KC_V < WV ? KC_V : WV) / 16;
  static constexpr int DIR_K = KC_V < 64 ? KC_V : 64;
  // bytes into a stage of warpgroup 1's half of the lanes (W=512)
  static constexpr uint32_t HALF = STAGE_BYTES / 2;
  static constexpr int H_TILE = 2 * 64 * W_;   // a 64-row trunk tile
  static constexpr int HV_TILE = 2 * 64 * WV;  // a 64-row view tile
  static constexpr int WG_BYTES = PE_TILE + H_TILE + HV_TILE;
  // the block's tiles: per warpgroup PE, trunk and view (W <= 256), or one
  // PE tile and two trunk tiles the warpgroups share (W=512); the point
  // kernels add dir-PE tiles
  static constexpr int TILES = kSplit ? PE_TILE + 2 * H_TILE : 2 * WG_BYTES;
  static constexpr int POINT_TILES =
      kSplit ? TILES + PED_TILE : 2 * (WG_BYTES + PED_TILE);
  // the heads' stages: w_rgb^T starts RGB_OFF bytes after w_alpha^T
  static constexpr int RGB_OFF = 32 * W_;
  static constexpr int HEAD_STAGES =
      (RGB_OFF + 32 * WV + STAGE_BYTES - 1) / STAGE_BYTES;
  static_assert(!kSplit || RGB_OFF == STAGE_BYTES,
                "W=512: w_alpha^T fills the first heads' stage");
};

// Where a tile source's chain stops: after the trunk, after the view
// branch, or through the heads to raw rows (every production kernel).
enum Last { LAST_TRUNK, LAST_VIEW, LAST_HEADS };

// Stages of the trunk and of the view branch without its dir-PE stage in
// one tile's weight stream (the order in the note at the top).
template <class T>
inline int trunk_stages(const unsigned long long* slots, int depth) {
  int n = PE_PAD / T::KC_W;
  for (int i = 1; i < depth; ++i)
    n += T::W / T::KC_W + (slots[SLOT_WSKIP + i] ? PE_PAD / T::KC_W : 0);
  return n;
}
template <class T>
inline int view_stages(int n_views) {
  constexpr int rest = (T::WV + T::KC_V - 1) / T::KC_V;
  return T::W / T::KC_V + (n_views - 1) * rest;
}
// Stages of one tile's weight stream without the dir-PE stage.
template <class T>
inline int chain_stages(const unsigned long long* slots, int depth,
                        int n_views) {
  return trunk_stages<T>(slots, depth) + view_stages<T>(n_views) +
         T::HEAD_STAGES;
}

// A consumer warpgroup's view of the ring of n stages: `it` counts the
// stages taken, `pend` is the stage whose products may still be in flight.
// Stage s completes on the mbarrier at bars + 8 s and is released on the
// one at bars + 8 (MAX_RING + s), by one arrival per consumer warp (an
// arrival per thread made the barrier's atomics the kernel's floor).
struct Ring {
  uint32_t base, bars, n, it, pend;
};

__device__ __forceinline__ void ring_release(const Ring& r, uint32_t s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.bars + 8 * (MAX_RING + s));
}

__device__ __forceinline__ uint32_t ring_take(Ring& r) {
  const uint32_t s = r.it % r.n;
  mbar_wait(r.bars + 8 * s, (r.it / r.n) & 1);
  return r.base + s * STAGE_BYTES;
}
// After committing the products of the stage just taken: wait for the
// group before it and release that group's stage.
__device__ __forceinline__ void ring_step(Ring& r) {
  wgmma_wait<1>();
  if (r.pend != NO_STAGE) ring_release(r, r.pend);
  r.pend = r.it % r.n;
  ++r.it;
}
__device__ __forceinline__ void ring_drain(Ring& r) {
  wgmma_wait<0>();
  if (r.pend != NO_STAGE) ring_release(r, r.pend);
  r.pend = NO_STAGE;
}

// K-major descriptor of column k (a multiple of 16) of a 64-row tile at a
__device__ __forceinline__ uint64_t a_desc(uint32_t a, int k) {
  return desc_k(a + (k >> 6) * 8192 + (k & 63) * 2);
}

// d (64 x 2 NR) (+)= A (64 x 16) @ B (16 x 2 NR): n256, n128 or n64
template <int NR, int A>
__device__ __forceinline__ void wgmma_kmn(float (&d)[A], uint64_t a,
                                          uint64_t b, int scale_d) {
  if constexpr (NR == 128)
    wgmma_n256_kmn(d, a, b, scale_d);
  else if constexpr (NR == 64)
    wgmma_n128_kmn(d, a, b, scale_d);
  else
    wgmma_n64_kmn(d, a, b, scale_d);
}

// acc[0:NR] (+)= A (64 x K at a) @ the next K / KC stages (K-rows of a
// matrix 8192 / KC lanes wide, MN-major), their 2 NR lanes from byte boff
// of each stage; KS k16 steps a stage (fewer than KC / 16 where a matrix of
// fewer K-rows fills part of one)
template <int NR, int KC, int KS = KC / 16, int A>
__device__ __forceinline__ void prod(float (&acc)[A], Ring& r, uint32_t a,
                                     int K, bool first, uint32_t boff = 0) {
  for (int k0 = 0; k0 < K; k0 += KC) {
    const uint32_t st = ring_take(r) + boff;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS; ++j)
      wgmma_kmn<NR>(acc, a_desc(a, k0 + 16 * j),
                    desc_mn(st + 2048 * j, KC * 128),
                    first && k0 == 0 && j == 0 ? 0 : 1);
    wgmma_commit();
    ring_step(r);
  }
}

// tile (64 x 2 NR, K-major image) = bf16(relu(acc + bias)), as relu of
// the rounded pair (the same values). Thread l of warp w holds rows
// 16 w + l / 4 (lo) and + 8 (hi), columns 8 (i / 4) + 2 (l % 4) + (i & 1);
// bias_lo / bias_hi are the two rows' bias vectors. Each chunk of 32
// values loads its bias pairs before its stores: a load behind a store
// through generic pointers would wait for the store. With kMask, bit i % 32
// of mask[i / 32] is set where the stored value of acc[i] is > 0 (relu' on
// the rounded activation; mask starts zeroed).
template <int NR, bool kMask = false, int A>
__device__ __forceinline__ void relu_store(const float (&acc)[A],
                                           bf16* tile, const float* bias_lo,
                                           const float* bias_hi, int wtid,
                                           uint32_t* mask = nullptr) {
  const int l = wtid & 31;
  const int r0 = 16 * (wtid >> 5) + (l >> 2);
#pragma unroll
  for (int i0 = 0; i0 < NR; i0 += 32) {
    float2 b[2][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * ((i0 >> 2) + j) + 2 * (l & 3);
      b[0][j] = *reinterpret_cast<const float2*>(bias_lo + col);
      b[1][j] = *reinterpret_cast<const float2*>(bias_hi + col);
    }
#pragma unroll
    for (int i = i0; i < i0 + 32; i += 2) {
      const int hi = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (l & 3);
      const float2 bb = b[hi][(i - i0) >> 2];
      const __nv_bfloat162 v =
          __hmax2(__floats2bfloat162_rn(acc[i] + bb.x, acc[i + 1] + bb.y),
                  __float2bfloat162_rn(0.f));
      *reinterpret_cast<__nv_bfloat162*>(tile + swz(r0 + 8 * hi, col)) = v;
      if constexpr (kMask) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
        const uint32_t pos =
            (static_cast<int16_t>(u & 0xFFFFu) > 0 ? 1u : 0u) |
            (static_cast<int16_t>(u >> 16) > 0 ? 2u : 0u);
        mask[i >> 5] |= pos << (i & 31);
      }
    }
  }
}

// The trunk's products of layer i into acc: pe @ W_0 (i = 0), or the skip
// layer's pe @ W_pe then h @ W_i in one accumulator; the warpgroup's lanes
// of each stage from byte boff.
template <class T, int A>
__device__ __forceinline__ void trunk_prod(const Net& net, float (&acc)[A],
                                           Ring& r, uint32_t pe, uint32_t h,
                                           int i, uint32_t boff = 0) {
  if (i == 0) {
    prod<T::NRW, T::KC_W>(acc, r, pe, PE_PAD, true, boff);
  } else {
    const bool skip = net.slot[SLOT_WSKIP + i] != nullptr;
    if (skip) prod<T::NRW, T::KC_W>(acc, r, pe, PE_PAD, true, boff);
    prod<T::NRW, T::KC_W>(acc, r, h, T::W, !skip, boff);
  }
}

// View layer v's products into acc: h (the trunk's output, K = W) for v =
// 0, else hv (K = WV), then with kDir view layer 0's dir-PE product from
// the dir-PE tile at ped.
template <class T, bool kDir, int A>
__device__ __forceinline__ void view_prod(float (&acc)[A], Ring& r,
                                          uint32_t h, uint32_t hv,
                                          uint32_t ped, int v,
                                          uint32_t boff = 0) {
  if constexpr (T::KC_V <= T::WV) {  // every view matrix fills whole stages
    prod<T::NRV, T::KC_V>(acc, r, v == 0 ? h : hv, v == 0 ? T::W : T::WV,
                          true, boff);
  } else if (v == 0) {
    prod<T::NRV, T::KC_V>(acc, r, h, T::W, true, boff);
  } else {
    prod<T::NRV, T::KC_V, T::KS_V>(acc, r, hv, T::WV, true, boff);
  }
  if (kDir && v == 0)
    prod<T::NRV, T::KC_V, T::DIR_K / 16>(acc, r, ped, T::DIR_K, false, boff);
}

// The heads' raw rows of the warpgroup's 64 rows from acc[0:4] (columns
// 0..3 of the n16 product) plus b_heads; rows at or past n_pts write
// nothing.
template <int A>
__device__ __forceinline__ void heads_out(const Net& net, const float (&acc)[A],
                                          float* raw, int row0, int n_pts,
                                          int wtid) {
  const int lrow = 16 * (wtid >> 5) + ((wtid & 31) >> 2);
  const int q = wtid & 3;
  if (q < 2) {
    const float* bh = fvec(net, SLOT_BHEADS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = row0 + lrow + 8 * (i >> 1), col = 2 * q + (i & 1);
      if (p < n_pts) raw[p * 4 + col] = acc[i] + bh[col];
    }
  }
}

// The MLP of one 128-point tile at W <= 256, for warpgroup wg (rows 64 wg
// .. +64 of the tile at tile_base; rows at or past n_pts are zeros and
// write nothing): Src's PE fill -> trunk -> view branch -> heads -> Src's
// raw, or with Src::kLast the trunk's or the view branch's activation tile
// to Src's store.
// tiles: the warpgroup's PE, trunk and view tiles, 1,024-byte aligned, and
// with Src::kDirProduct its dir-PE tile after them.
template <class Src>
__device__ __forceinline__ void chain_tile(const Net& net, const Src& src,
                                           Ring& r, char* tiles,
                                           int tile_base, int n_pts, int wg,
                                           int wtid) {
  using T = typename Src::T;
  const int bar = 1 + wg;
  const int row0 = tile_base + 64 * wg;
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  bf16* h_g = pe_g + PE_TILE / 2;
  bf16* hv_g = h_g + T::H_TILE / 2;
  const uint32_t pe = smem_addr(tiles), h = pe + PE_TILE, hv = h + T::H_TILE;
  float acc[T::ACC];
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;

  // the tile's PE (and dir-PE); rows past n_pts are zeros
  named_barrier(bar, 128);
  src.fill(net, pe_g, hv_g + T::HV_TILE / 2, row0, n_pts, wtid);
  fence_proxy_async();
  named_barrier(bar, 128);

  // trunk; the skip layer is pe @ W_pe + h @ W_h in one accumulator
  for (int i = 0; i < net.depth; ++i) {
    trunk_prod<T>(net, acc, r, pe, h, i);
    ring_drain(r);
    named_barrier(bar, 128);  // every warp's products have read h
    const float* b = fvec(net, SLOT_B + i);
    relu_store<T::NRW>(acc, h_g, b, b, wtid);
    fence_proxy_async();
    named_barrier(bar, 128);
  }

  if constexpr (Src::kLast == LAST_TRUNK) {
    src.store(h_g, row0, n_pts, wtid);
  } else {
    // view branch; layer 0's bias is Src's per row (a per-ray term), or
    // bv[0] after the per-point dir-PE product in the same accumulator
    const int lrow = 16 * (wtid >> 5) + ((wtid & 31) >> 2);
    for (int v = 0; v < net.n_views; ++v) {
      view_prod<T, Src::kDirProduct>(acc, r, h, hv, hv + T::HV_TILE, v);
      ring_drain(r);
      named_barrier(bar, 128);
      if (v == 0) {
        relu_store<T::NRV>(acc, hv_g, src.view_bias(net, row0 + lrow),
                           src.view_bias(net, row0 + lrow + 8), wtid);
      } else {
        const float* b = fvec(net, SLOT_BV + v);
        relu_store<T::NRV>(acc, hv_g, b, b, wtid);
      }
      fence_proxy_async();
      named_barrier(bar, 128);
    }

    if constexpr (Src::kLast == LAST_VIEW) {
      src.store(hv_g, row0, n_pts, wtid);
    } else {
      // heads: raw = h @ w_alpha + hv @ w_rgb + b_heads, f32, columns 0..3
      {
        const uint32_t st = ring_take(r);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < T::W; k += 16)
          wgmma_n16_kk(acc, a_desc(h, k),
                       desc_k(st + (k >> 6) * 2048 + (k & 63) * 2), k > 0);
#pragma unroll
        for (int k = 0; k < T::WV; k += 16)
          wgmma_n16_kk(acc, a_desc(hv, k),
                       desc_k(st + T::RGB_OFF + (k >> 6) * 2048 +
                              (k & 63) * 2),
                       1);
        wgmma_commit();
        ring_step(r);
        ring_drain(r);
      }
      heads_out(net, acc, src.raw(), row0, n_pts, wtid);
    }
  }
}

// The MLP of one 64-point tile at W=512 (tile rows from row0; rows at or
// past n_pts are zeros and write nothing), both warpgroups on the same
// rows, warpgroup wg on columns wg CW.. of every trunk layer and wg CV.. of
// every view layer: Src's PE fill (warpgroup 0) -> trunk -> view branch ->
// heads (warpgroup 0) -> Src's raw. tiles: the PE tile, the two trunk
// tiles H[0], H[1], and with Src::kDirProduct the dir-PE tile after them.
// Trunk layer i writes H[i % 2]; the view branch ping-pongs between the
// halves of the trunk tile the last layer did not write. Barrier 1 joins
// both warpgroups.
template <class Src>
__device__ __forceinline__ void chain_tile_split(const Net& net,
                                                 const Src& src, Ring& r,
                                                 char* tiles, int row0,
                                                 int n_pts, int wg,
                                                 int wtid) {
  using T = typename Src::T;
  static_assert(Src::kLast == LAST_HEADS, "W=512 runs through the heads");
  // shared addresses (and generic pointers, the same offsets) of the PE
  // tile, trunk tile j at h0 + j H_TILE, the dir-PE tile
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  const uint32_t pe = smem_addr(tiles), h0 = pe + PE_TILE;
  const uint32_t ped = h0 + 2 * T::H_TILE;
  const uint32_t boff = wg * T::HALF;
  // the warpgroup's columns' offset in a bias, and in a tile's image
  // (swz: elements)
  const int cw = wg * T::CW, cv = wg * T::CV;
  auto at = [&](uint32_t a) {  // generic pointer of shared address a
    return pe_g + (a - pe) / 2;
  };
  float acc[T::ACC];
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;

  named_barrier(1, 256);  // the last tile's products have read its tiles
  if (wg == 0) src.fill(net, pe_g, at(ped), row0, n_pts, wtid);
  fence_proxy_async();
  named_barrier(1, 256);

  for (int i = 0; i < net.depth; ++i) {
    const uint32_t out = h0 + (i & 1) * T::H_TILE;
    trunk_prod<T>(net, acc, r, pe, h0 + ((i & 1) ^ 1) * T::H_TILE, i, boff);
    ring_drain(r);
    const float* b = fvec(net, SLOT_B + i) + cw;
    relu_store<T::NRW>(acc, at(out) + swz(0, cw), b, b, wtid);
    fence_proxy_async();
    named_barrier(1, 256);  // both halves written, both products done
  }

  // the trunk tile of the last layer, and the other one's halves, between
  // which the view branch ping-pongs
  const uint32_t hl = h0 + ((net.depth - 1) & 1) * T::H_TILE;
  const uint32_t hv0 = h0 + (((net.depth - 1) & 1) ^ 1) * T::H_TILE;
  const int lrow = 16 * (wtid >> 5) + ((wtid & 31) >> 2);
  for (int v = 0; v < net.n_views; ++v) {
    const uint32_t out = hv0 + (v & 1) * T::HV_TILE;
    view_prod<T, Src::kDirProduct>(acc, r, hl,
                                   hv0 + ((v & 1) ^ 1) * T::HV_TILE, ped, v,
                                   boff);
    ring_drain(r);
    if (v == 0) {
      relu_store<T::NRV>(acc, at(out) + swz(0, cv),
                         src.view_bias(net, row0 + lrow) + cv,
                         src.view_bias(net, row0 + lrow + 8) + cv, wtid);
    } else {
      const float* b = fvec(net, SLOT_BV + v) + cv;
      relu_store<T::NRV>(acc, at(out) + swz(0, cv), b, b, wtid);
    }
    fence_proxy_async();
    named_barrier(1, 256);
  }

  // heads: raw = h @ w_alpha (first stage) + hv @ w_rgb (second) + b_heads
  const uint32_t hvl = hv0 + ((net.n_views - 1) & 1) * T::HV_TILE;
  if (wg == 0) {
    uint32_t st = ring_take(r);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < T::W; k += 16)
      wgmma_n16_kk(acc, a_desc(hl, k),
                   desc_k(st + (k >> 6) * 2048 + (k & 63) * 2), k > 0);
    wgmma_commit();
    ring_step(r);
    st = ring_take(r);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < T::WV; k += 16)
      wgmma_n16_kk(acc, a_desc(hvl, k),
                   desc_k(st + (k >> 6) * 2048 + (k & 63) * 2), 1);
    wgmma_commit();
    ring_step(r);
    ring_drain(r);
    heads_out(net, acc, src.raw(), row0, n_pts, wtid);
  } else {
#pragma unroll
    for (int s = 0; s < T::HEAD_STAGES; ++s) {
      ring_take(r);
      ring_step(r);
    }
    ring_drain(r);
  }
}

// The block's place in dynamic shared memory: the ring at a 1,024-byte
// aligned base (shared address and generic pointer), the consumers' tiles
// after it, then the mbarriers.
struct Chain {
  uint32_t base, bars;
  char* gbase;
  int n_ring;
};

// Lays out the ring, n_tiles tiles of tile_bytes each (two warpgroups'
// by default) and the mbarriers, and initialises the ring's mbarriers, a
// stage released once by each of consumer_warps warps; every thread calls
// it, and it ends with __syncthreads.
__device__ __forceinline__ Chain chain_begin(
    char* smem_raw, int n_ring, int tile_bytes, int n_tiles = 2,
    int consumer_warps = CONSUMER_WARPS) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const Chain c{base, base + n_ring * STAGE_BYTES + n_tiles * tile_bytes,
                smem_raw + (base - raw), n_ring};
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_ring; ++s) {
      mbar_init(c.bars + 8 * s, 1);
      mbar_init(c.bars + 8 * (MAX_RING + s), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return c;
}

// The producer warp's part: its one thread (`thread`, the first after two
// consumer warpgroups by default) streams the n_stages weight stages of
// 16 KB once per tile, n_tiles times, through the ring, each stage's copy
// waiting for the consumers to release the slot it refills.
__device__ __forceinline__ void chain_produce(const Chain& c,
                                              const bf16* __restrict__ wstream,
                                              int n_stages, int n_tiles,
                                              int thread = 256) {
  if (threadIdx.x == thread) {
    const uint32_t n = static_cast<uint32_t>(c.n_ring);
    const uint32_t total = static_cast<uint32_t>(n_tiles) * n_stages;
    for (uint32_t q = 0; q < total; ++q) {
      const uint32_t s = q % n;
      if (q >= n) mbar_wait(c.bars + 8 * (MAX_RING + s), ((q / n) - 1) & 1);
      mbar_expect_tx(c.bars + 8 * s, STAGE_BYTES);
      bulk_g2s(c.base + s * STAGE_BYTES,
               wstream + static_cast<size_t>(q % n_stages) * STAGE_ELEMS,
               STAGE_BYTES, c.bars + 8 * s);
    }
  }
  __syncwarp();
}

// W=512's registers a thread while the chain runs (a 384-thread block
// starts at 168 each): the producer warpgroup's and the consumers'
constexpr int CHAIN_PRODUCER_REGS = 40, CHAIN_CONSUMER_REGS = 232;
constexpr int CHAIN_LAUNCH_REGS = 168;
static_assert(2 * 128 * CHAIN_CONSUMER_REGS + 128 * CHAIN_PRODUCER_REGS <=
                      65536 &&
                  3 * 128 * CHAIN_LAUNCH_REGS <= 65536,
              "the split chain's registers exceed the SM's");

// The field MLP of the block's n_pts points: the producer's one thread
// streams the n_stages weight stages once per tile (Src::T::DT points)
// through the ring while the two warpgroups run chain_tile (W <= 256) or
// chain_tile_split (W=512) on each tile. Every thread calls it; it ends
// with __syncthreads.
template <class Src>
__device__ __forceinline__ void chain_mlp(const Net& net, const Src& src,
                                          const Chain& c,
                                          const bf16* __restrict__ wstream,
                                          int n_stages, int n_pts) {
  using T = typename Src::T;
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    if constexpr (T::kSplit) setmaxnreg_dec<CHAIN_PRODUCER_REGS>();
    chain_produce(c, wstream, n_stages, (n_pts + T::DT - 1) / T::DT);
    if constexpr (T::kSplit) setmaxnreg_inc<CHAIN_LAUNCH_REGS>();
  } else {
    Ring ring{c.base, c.bars, static_cast<uint32_t>(c.n_ring), 0, NO_STAGE};
    if constexpr (T::kSplit) {
      setmaxnreg_inc<CHAIN_CONSUMER_REGS>();
      char* tiles = c.gbase + c.n_ring * STAGE_BYTES;
      for (int t0 = 0; t0 < n_pts; t0 += T::DT)
        chain_tile_split(net, src, ring, tiles, t0, n_pts, wg,
                         threadIdx.x & 127);
      setmaxnreg_dec<CHAIN_LAUNCH_REGS>();
    } else {
      char* tiles = c.gbase + c.n_ring * STAGE_BYTES + wg * Src::kTileBytes;
      for (int t0 = 0; t0 < n_pts; t0 += T::DT)
        chain_tile(net, src, ring, tiles, t0, n_pts, wg, threadIdx.x & 127);
    }
  }
  __syncthreads();
}

// The chain's tile source of the point kernels (fused_mlp.cuh, and the
// recompute of the gradient kernel's pass A in fused_mlp_grad.cuh) for the
// block's points (pointers offset to the block's first point); ENCODED
// reads PE rows, otherwise coordinates. kTileBytes: a warpgroup's tiles
// (W <= 256).
template <bool ENCODED, class T_>
struct PointTile {
  using T = T_;
  static constexpr int kTileBytes = T::WG_BYTES + PED_TILE;
  static constexpr bool kDirProduct = true;
  static constexpr int kLast = LAST_HEADS;
  const void* a;  // (n, 3) f32 points, or (n, PE_PAD) bf16 xyz-PE rows
  const void* b;  // (n, 3) f32 directions, or (n, PED_PAD) bf16 dir-PE rows
  float* out;     // (n, 4) f32 raw

  // The encodings of chunks C0 + 2 j of a row: xyz-PE j = 0..3 into v[j],
  // dir-PE j = 0, 1 into v[4 + j]. With C0 a template parameter every lane
  // index is known at compile time, so pe_lane's branches fold away and x
  // and d stay in registers (with lanes chosen at run time K4 took about
  // 15 % longer on an H100; PERF.md).
  template <int C0>
  __device__ __forceinline__ static void encode(const Net& net,
                                                const float (&x)[3],
                                                const float (&d)[3],
                                                uint4 (&v)[6]) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      __align__(16) bf16 lanes[8];
      const int c = C0 + 2 * (j < 4 ? j : j - 4);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        lanes[k] = __float2bfloat16(
            j < 4 ? pe_lane(x, 8 * c + k, net.multires)
                  : pe_lane(d, 8 * c + k, net.multires_views));
      v[j] = *reinterpret_cast<const uint4*>(lanes);
    }
  }

  // Thread t of the warpgroup fills row t % 64 of both tiles, its 16-byte
  // chunks (8 lanes each) c0 + 2 j, c0 = t / 64 (the same in every thread
  // of a warp): one row's inputs per thread, all loaded before the first
  // store.
  __device__ __forceinline__ void fill(const Net& net, bf16* pe_g,
                                       bf16* ped_g, int row0, int n_pts,
                                       int wtid) const {
    const int row = wtid & 63, c0 = wtid >> 6;
    const size_t p = row0 + row;
    const bool live = row0 + row < n_pts;
    uint4 v[6];  // xyz-PE chunks c0 + 0, 2, 4, 6; dir-PE chunks c0 + 0, 2
    if constexpr (ENCODED) {
      const uint4* pa = static_cast<const uint4*>(a) + p * (PE_PAD / 8);
      const uint4* pb = static_cast<const uint4*>(b) + p * (PED_PAD / 8);
#pragma unroll
      for (int j = 0; j < 6; ++j)
        v[j] = !live ? make_uint4(0, 0, 0, 0)
                     : j < 4 ? pa[c0 + 2 * j] : pb[c0 + 2 * (j - 4)];
    } else {
      float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
      if (live) {
        const float* pa = static_cast<const float*>(a) + p * 3;
        const float* pb = static_cast<const float*>(b) + p * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          x[k] = pa[k];
          d[k] = pb[k];
        }
      }
      if (c0 == 0)
        encode<0>(net, x, d, v);
      else
        encode<1>(net, x, d, v);
      if (!live) {
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] = make_uint4(0, 0, 0, 0);
      }
    }
    static_assert(PED_PAD == 32, "dir-PE rows are 4 chunks");
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 2 * j;
      *reinterpret_cast<uint4*>(pe_g + swz(row, 8 * c)) = v[j];
      *reinterpret_cast<uint4*>(ped_g + swz(row, 8 * c)) =
          j < 2 ? v[4 + j] : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ const float* view_bias(const Net& net,
                                                    int) const {
    return fvec(net, SLOT_BV);
  }
  __device__ __forceinline__ float* raw() const { return out; }
};

// Shared memory of a point kernel: 1,024 bytes to align the base, the ring
// of n_ring stages, the block's PE / trunk / view / dir-PE tiles, 128 bytes
// of mbarriers.
template <class T>
__host__ __device__ inline size_t point_smem_bytes(int n_ring) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES + T::POINT_TILES +
         128;
}

// Rows row0.. of (n, LANES) bf16 rows into a warpgroup's K-major tile of
// TILE_LANES lanes, as PointTile<true> fills its tiles: thread t copies
// the 16-byte chunks c0 + 2 j of row t % 64, c0 = t / 64, all loaded
// before the first store; lanes past LANES and rows at or past n_pts are
// zeros.
template <int LANES, int TILE_LANES>
__device__ __forceinline__ void copy_rows(const bf16* rows, bf16* tile,
                                          int row0, int n_pts, int wtid) {
  const int row = wtid & 63, c0 = wtid >> 6;
  const bool live = row0 + row < n_pts;
  const uint4* src = reinterpret_cast<const uint4*>(rows) +
                     static_cast<size_t>(row0 + row) * (LANES / 8);
  uint4 v[TILE_LANES / 16];
#pragma unroll
  for (int j = 0; j < TILE_LANES / 16; ++j) {
    const int c = c0 + 2 * j;
    v[j] = live && c < LANES / 8 ? src[c] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < TILE_LANES / 16; ++j)
    *reinterpret_cast<uint4*>(tile + swz(row, 8 * (c0 + 2 * j))) = v[j];
}

// The chain's tile source of kdiag.cu's ladder (W <= 256) for the block's
// points (pointers offset to its first point): PointTile<true>'s fill of
// the given encodings (the dir-PE tile only where the view branch runs),
// the chain stopped after the trunk (LAST_TRUNK) or the view branch
// (LAST_VIEW), and that activation tile's rows out as bf16.
template <int LAST, class T_>
struct ActivationTile {
  static_assert(LAST == LAST_TRUNK || LAST == LAST_VIEW,
                "the ladder stops after the trunk or the view branch");
  using T = T_;
  static constexpr int kTileBytes = T::WG_BYTES + PED_TILE;
  static constexpr bool kDirProduct = true;
  static constexpr int kLast = LAST;
  static constexpr int kWidth = LAST == LAST_TRUNK ? T::W : T::WV;
  const bf16* pe;   // (n, PE_PAD) xyz-PE rows
  const bf16* ped;  // (n, PED_PAD) dir-PE rows
  bf16* act;        // (n, kWidth) the last activation

  __device__ __forceinline__ void fill(const Net&, bf16* pe_g, bf16* ped_g,
                                       int row0, int n_pts, int wtid) const {
    copy_rows<PE_PAD, PE_PAD>(pe, pe_g, row0, n_pts, wtid);
    if constexpr (LAST == LAST_VIEW)
      copy_rows<PED_PAD, 64>(ped, ped_g, row0, n_pts, wtid);
  }
  __device__ __forceinline__ const float* view_bias(const Net& net,
                                                    int) const {
    return fvec(net, SLOT_BV);
  }
  // The warpgroup's rows row0.. of the activation tile (K-major image) to
  // act in 16-byte chunks, a row's chunks on neighbouring threads; rows at
  // or past n_pts write nothing.
  __device__ __forceinline__ void store(const bf16* tile, int row0,
                                        int n_pts, int wtid) const {
    constexpr int CH = kWidth / 8;
    for (int e = wtid; e < 64 * CH; e += 128) {
      const int row = e / CH, c = e % CH;
      if (row0 + row < n_pts)
        reinterpret_cast<uint4*>(act)[static_cast<size_t>(row0 + row) * CH +
                                      c] =
            *reinterpret_cast<const uint4*>(tile + swz(row, 8 * c));
    }
  }
};

// The ray kernels' pieces (fused_render.cuh K1-K3, and kdiag.cu's probe B,
// which runs K1's chain without its compositing): the producer warp's
// thread index in their per-ray phases, the offset of the per-ray state
// behind the ring, tiles and mbarriers, and their tile source.
constexpr int IDLE = 1 << 30;  // producer's thread index in ray phases

// Byte offset of the per-ray state: the ring of n_ring stages, the block's
// PE / trunk / view tiles, 128 bytes of mbarriers.
template <class T>
__host__ __device__ inline int ray_state_offset(int n_ring) {
  return n_ring * STAGE_BYTES + T::TILES + 128;
}

// The chain's tile source for a block of nr rays of S points each, point p
// on ray p / S: the PE of x = ro + z rd from the per-ray state, view layer
// 0's per-ray term pv (ped @ wv0d + bv0, load_rays), raw rows to sm.raw.
template <class T_>
struct RayTile {
  using T = T_;
  static constexpr int kTileBytes = T::WG_BYTES;
  static constexpr bool kDirProduct = false;
  static constexpr int kLast = LAST_HEADS;
  const Smem& sm;
  int S, nr;

  // 8 lanes per 16-byte chunk of a row
  __device__ __forceinline__ void fill(const Net& net, bf16* pe_g, bf16*,
                                       int row0, int n_pts, int wtid) const {
    for (int e = wtid; e < 64 * (PE_PAD / 8); e += 128) {
      const int row = e >> 3, c = e & 7, p = row0 + row;
      __align__(16) bf16 v[8];
      float x[3] = {0.f, 0.f, 0.f};
      if (p < n_pts) {
        const int ry = p / S;
        const float zz = sm.z[p];
        for (int d = 0; d < 3; ++d)
          x[d] = sm.ro[ry * 3 + d] + zz * sm.rd[ry * 3 + d];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = __float2bfloat16(
            p < n_pts ? pe_lane(x, 8 * c + k, net.multires) : 0.f);
      *reinterpret_cast<uint4*>(pe_g + swz(row, 8 * c)) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
  __device__ __forceinline__ const float* view_bias(const Net&,
                                                    int row) const {
    return sm.pv + min(row / S, nr - 1) * T::WV;
  }
  __device__ __forceinline__ float* raw() const { return sm.raw; }
};

// The chain's tile source of kdiag.cu's probe A (W <= 256) for a block of
// nr rays of S points each, from given encodings (pointers offset to the
// block's first point): the tile's xyz-PE copied from the bf16 PE rows
// (copy_rows), view layer 0's per-ray term pv from shared memory as
// RayTile's, raw rows to global memory.
template <class T_>
struct PeRayTile {
  using T = T_;
  static constexpr int kTileBytes = T::WG_BYTES;
  static constexpr bool kDirProduct = false;
  static constexpr int kLast = LAST_HEADS;
  const bf16* pe;   // (nr S, PE_PAD) xyz-PE rows
  const float* pv;  // (nr, WV) per-ray terms
  float* out;       // (nr S, 4) f32 raw
  int S, nr;

  __device__ __forceinline__ void fill(const Net&, bf16* pe_g, bf16*,
                                       int row0, int n_pts, int wtid) const {
    copy_rows<PE_PAD, PE_PAD>(pe, pe_g, row0, n_pts, wtid);
  }
  __device__ __forceinline__ const float* view_bias(const Net&,
                                                    int row) const {
    return pv + min(row / S, nr - 1) * T::WV;
  }
  __device__ __forceinline__ float* raw() const { return out; }
};

// A thread's index in the per-ray phases: the consumers' own, the
// producer warp's past every loop, so that it only joins their barriers.
__device__ __forceinline__ int ray_tid() {
  return threadIdx.x < NTHREADS ? static_cast<int>(threadIdx.x) : IDLE;
}

// A chain kernel's launch: the stream must hold the `want` stages of the
// net and the ring 2..MAX_RING of them; sets the kernel's shared memory.
template <typename K>
inline cudaError_t chain_prepare(K kernel, size_t bytes, int want,
                                 int n_stages, int n_ring) {
  if (n_stages != want || n_ring < 2 || n_ring > MAX_RING)
    return cudaErrorInvalidValue;
  return prepare(kernel, bytes);
}

}  // namespace fr
