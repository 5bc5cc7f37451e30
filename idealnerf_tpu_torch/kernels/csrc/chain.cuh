// The wgmma chain: the field MLP of 128-point tiles on Hopper (sm_90a),
// run by every production forward kernel: the ray kernels of
// fused_render.cu (K1-K3) and the point kernels of fused_mlp.cu (K4, K5).
//
// - Weight stream. The wrapper lays the net's bf16 weights out in one
//   buffer of 16 KB stages, in the order the chain consumes them, each
//   stage already in wgmma's 128-byte-swizzled shared-memory image
//   (kernels/fused_render.py: chain_weight_stream):
//     layer 0          (64 x 256)  2 stages of 32 K-rows, MN-major
//     layer i = 1..D-1 skip pe-part (64 x 256) first if layer i is a skip
//                      layer, 2 stages; then (256 x 256), 8 stages
//     view layer 0     (256 x 128) 4 stages of 64 K-rows, MN-major
//     [dir-PE part of view layer 0 (64 x 128), 1 stage, rows 27..63 zero:
//      the point kernels' stream only]
//     view layer v     (128 x 128) 2 stages each
//     heads            one stage: w_alpha^T (16 x 256) then w_rgb^T
//                      (16 x 128), K-major
//   69 stages (1.1 MB) for the paper model (D=8, skip at 5, 3 view
//   layers), 70 with the dir-PE stage.
// - Block: 288 threads, two consumer warpgroups and one producer warp.
//   The producer's one thread keeps a ring of 2-8 stages filled by
//   cp.async.bulk on mbarriers, the stage sequence repeated for every
//   128-point tile without draining between tiles; both warpgroups read
//   each stage, so the weights cross L2 once per 128 points.
// - Per layer, per warpgroup (64 rows of the tile): A is the activation tile
//   in shared memory (K-major, 128-byte swizzle: swz), B the stage, the
//   accumulator (64 x 256 f32, 128 registers a thread) stays in registers;
//   one wgmma group in flight, the stage before it released. The epilogue
//   adds the bias, applies relu, rounds to bf16 and writes back in place
//   into the same tile; the skip layer adds PE x W_pe into the same
//   accumulator. The heads are an n16 product whose columns 0..3 are the
//   raw [rgb logits, sigma].
// - What a kernel brings (the tile source Src, a template parameter): the
//   fill of a tile's xyz-PE (from ray packets, from points, or from PE
//   rows), whether view layer 0 adds a per-point dir-PE product (then its
//   bias is bv[0]) or a per-ray term, where the chain stops (Src::kLast:
//   through the heads for every production kernel, or after the trunk or
//   the view branch for kdiag.cu's ladder) and where its rows go. The
//   sources live here: RayTile (the ray kernels, and kdiag.cu's probe B,
//   whose raw rows go to global memory), PeRayTile (probe A: RayTile's
//   per-ray term, the PE rows given), PointTile (K4, K5) and
//   ActivationTile (the ladder: PointTile's encoded fill, the last
//   activation written out).
// - The gradient kernel's pass A (fused_mlp_grad.cu) runs the same pieces
//   (chain_begin, chain_produce, Ring, prod_w / prod_v, relu_store with its
//   relu' bits, PointTile) forward without the heads, then backward on a
//   second stream of the transposed matrices.
#pragma once

#include "hopper.cuh"
#include "render_body.cuh"

namespace fr {

constexpr int DT = 128;            // points per tile, 64 per warpgroup
constexpr int D_THREADS = 288;     // two consumer warpgroups + producer warp
constexpr int MAX_RING = 8;        // weight ring depth at most
constexpr int CONSUMER_WARPS = 8;  // each releases a stage once
constexpr int STAGE_ELEMS = 8192;  // bf16 per stage
constexpr int STAGE_BYTES = 2 * STAGE_ELEMS;
constexpr int KC_W = 32;           // K-rows per stage of a 256-wide layer
constexpr int KC_V = 64;           // K-rows per stage of a 128-wide layer
constexpr int PE_TILE = 2 * 64 * PE_PAD;
constexpr int H_TILE = 2 * 64 * W;
constexpr int HV_TILE = 2 * 64 * WV;
constexpr int PED_TILE = 2 * 64 * 64;  // dir-PE, 64 K-lanes (27 used)
constexpr int WG_BYTES = PE_TILE + H_TILE + HV_TILE;
constexpr uint32_t NO_STAGE = 0xFFFFFFFFu;

static_assert(W == 256 && WV == 128 && PE_PAD == 64 && HEADS == 16 &&
                  PED_PAD <= 64,
              "the chain's stages are laid out for the paper widths");

// Where a tile source's chain stops: after the trunk, after the view
// branch, or through the heads to raw rows (every production kernel).
enum Last { LAST_TRUNK, LAST_VIEW, LAST_HEADS };

// Stages of the trunk and of the view branch without its dir-PE stage in
// one tile's weight stream (the order in the note at the top).
inline int trunk_stages(const unsigned long long* slots, int depth) {
  int n = PE_PAD / KC_W;
  for (int i = 1; i < depth; ++i)
    n += W / KC_W + (slots[SLOT_WSKIP + i] ? PE_PAD / KC_W : 0);
  return n;
}
inline int view_stages(int n_views) {
  return W / KC_V + (n_views - 1) * (WV / KC_V);
}
// Stages of one tile's weight stream without the dir-PE stage.
inline int chain_stages(const unsigned long long* slots, int depth,
                        int n_views) {
  return trunk_stages(slots, depth) + view_stages(n_views) + 1;
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

// acc (+)= A (64 x K at a) @ the next K / KC_W stages (K x 256)
__device__ __forceinline__ void prod_w(float (&acc)[128], Ring& r,
                                       uint32_t a, int K, bool first) {
  for (int k0 = 0; k0 < K; k0 += KC_W) {
    const uint32_t st = ring_take(r);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC_W / 16; ++j)
      wgmma_n256_kmn(acc, a_desc(a, k0 + 16 * j),
                     desc_mn(st + 2048 * j, KC_W * 128),
                     first && k0 == 0 && j == 0 ? 0 : 1);
    wgmma_commit();
    ring_step(r);
  }
}

// acc[0:64] (+)= A (64 x K at a) @ the next K / KC_V stages (K x 128)
__device__ __forceinline__ void prod_v(float (&acc)[128], Ring& r,
                                       uint32_t a, int K, bool first) {
  for (int k0 = 0; k0 < K; k0 += KC_V) {
    const uint32_t st = ring_take(r);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC_V / 16; ++j)
      wgmma_n128_kmn(acc, a_desc(a, k0 + 16 * j),
                     desc_mn(st + 2048 * j, KC_V * 128),
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
template <int NR, bool kMask = false>
__device__ __forceinline__ void relu_store(const float (&acc)[128],
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

// The MLP of one 128-point tile, for warpgroup wg (rows 64 wg .. +64 of
// the tile at tile_base; rows at or past n_pts are zeros and write
// nothing): Src's PE fill -> trunk -> view branch -> heads -> Src's raw,
// or with Src::kLast the trunk's or the view branch's activation tile to
// Src's store.
// tiles: the warpgroup's PE, trunk and view tiles, 1,024-byte aligned, and
// with Src::kDirProduct its dir-PE tile after them.
template <class Src>
__device__ __forceinline__ void chain_tile(const Net& net, const Src& src,
                                           Ring& r, char* tiles,
                                           int tile_base, int n_pts, int wg,
                                           int wtid) {
  const int bar = 1 + wg;
  const int row0 = tile_base + 64 * wg;
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  bf16* h_g = pe_g + PE_TILE / 2;
  bf16* hv_g = h_g + H_TILE / 2;
  const uint32_t pe = smem_addr(tiles), h = pe + PE_TILE, hv = h + H_TILE;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // the tile's PE (and dir-PE); rows past n_pts are zeros
  named_barrier(bar, 128);
  src.fill(net, pe_g, hv_g + HV_TILE / 2, row0, n_pts, wtid);
  fence_proxy_async();
  named_barrier(bar, 128);

  // trunk; the skip layer is pe @ W_pe + h @ W_h in one accumulator
  for (int i = 0; i < net.depth; ++i) {
    if (i == 0) {
      prod_w(acc, r, pe, PE_PAD, true);
    } else {
      const bool skip = net.slot[SLOT_WSKIP + i] != nullptr;
      if (skip) prod_w(acc, r, pe, PE_PAD, true);
      prod_w(acc, r, h, W, !skip);
    }
    ring_drain(r);
    named_barrier(bar, 128);  // every warp's products have read h
    const float* b = fvec(net, SLOT_B + i);
    relu_store<128>(acc, h_g, b, b, wtid);
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
      prod_v(acc, r, v == 0 ? h : hv, v == 0 ? W : WV, true);
      if (Src::kDirProduct && v == 0)
        prod_v(acc, r, hv + HV_TILE, KC_V, false);
      ring_drain(r);
      named_barrier(bar, 128);
      if (v == 0) {
        relu_store<64>(acc, hv_g, src.view_bias(net, row0 + lrow),
                       src.view_bias(net, row0 + lrow + 8), wtid);
      } else {
        const float* b = fvec(net, SLOT_BV + v);
        relu_store<64>(acc, hv_g, b, b, wtid);
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
        for (int k = 0; k < W; k += 16)
          wgmma_n16_kk(acc, a_desc(h, k),
                       desc_k(st + (k >> 6) * 2048 + (k & 63) * 2), k > 0);
#pragma unroll
        for (int k = 0; k < WV; k += 16)
          wgmma_n16_kk(acc, a_desc(hv, k),
                       desc_k(st + 8192 + (k >> 6) * 2048 + (k & 63) * 2),
                       1);
        wgmma_commit();
        ring_step(r);
        ring_drain(r);
      }
      const int q = wtid & 3;
      if (q < 2) {
        const float* bh = fvec(net, SLOT_BHEADS);
        float* raw = src.raw();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = row0 + lrow + 8 * (i >> 1), col = 2 * q + (i & 1);
          if (p < n_pts) raw[p * 4 + col] = acc[i] + bh[col];
        }
      }
    }
  }
}

// The block's place in dynamic shared memory: the ring at a 1,024-byte
// aligned base (shared address and generic pointer), the two warpgroups'
// tiles after it, then the mbarriers.
struct Chain {
  uint32_t base, bars;
  char* gbase;
  int n_ring;
};

// Lays out the ring, two warpgroups' tiles of tile_bytes each and the
// mbarriers, and initialises the ring's mbarriers; every thread calls it,
// and it ends with __syncthreads.
__device__ __forceinline__ Chain chain_begin(char* smem_raw, int n_ring,
                                             int tile_bytes) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const Chain c{base, base + n_ring * STAGE_BYTES + 2 * tile_bytes,
                smem_raw + (base - raw), n_ring};
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_ring; ++s) {
      mbar_init(c.bars + 8 * s, 1);
      mbar_init(c.bars + 8 * (MAX_RING + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return c;
}

// The producer warp's part: its one thread streams the n_stages weight
// stages once per tile, n_tiles times, through the ring, each stage's copy
// waiting for the consumers to release the slot it refills.
__device__ __forceinline__ void chain_produce(const Chain& c,
                                              const bf16* __restrict__ wstream,
                                              int n_stages, int n_tiles) {
  if (threadIdx.x == 256) {
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

// The field MLP of the block's n_pts points: the producer's one thread
// streams the n_stages weight stages once per 128-point tile through the
// ring while the two warpgroups run chain_tile on each tile. Every thread
// calls it; it ends with __syncthreads.
template <class Src>
__device__ __forceinline__ void chain_mlp(const Net& net, const Src& src,
                                          const Chain& c,
                                          const bf16* __restrict__ wstream,
                                          int n_stages, int n_pts) {
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    chain_produce(c, wstream, n_stages, (n_pts + DT - 1) / DT);
  } else {
    Ring ring{c.base, c.bars, static_cast<uint32_t>(c.n_ring), 0, NO_STAGE};
    char* tiles = c.gbase + c.n_ring * STAGE_BYTES + wg * Src::kTileBytes;
    for (int t0 = 0; t0 < n_pts; t0 += DT)
      chain_tile(net, src, ring, tiles, t0, n_pts, wg, threadIdx.x & 127);
  }
  __syncthreads();
}

// The chain's tile source of the point kernels (fused_mlp.cu, and the
// recompute of the gradient kernel's pass A in fused_mlp_grad.cu) for the
// block's points (pointers offset to the block's first point); ENCODED
// reads PE rows, otherwise coordinates.
template <bool ENCODED>
struct PointTile {
  static constexpr int kTileBytes = WG_BYTES + PED_TILE;
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
// of n_ring stages, two warpgroups' PE / trunk / view / dir-PE tiles, 128
// bytes of mbarriers.
__host__ __device__ inline size_t point_smem_bytes(int n_ring) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES +
         2 * PointTile<false>::kTileBytes + 128;
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

// The chain's tile source of kdiag.cu's ladder for the block's points
// (pointers offset to its first point): PointTile<true>'s fill of the
// given encodings (the dir-PE tile only where the view branch runs), the
// chain stopped after the trunk (LAST_TRUNK) or the view branch
// (LAST_VIEW), and that activation tile's rows out as bf16.
template <int LAST>
struct ActivationTile {
  static_assert(LAST == LAST_TRUNK || LAST == LAST_VIEW,
                "the ladder stops after the trunk or the view branch");
  static constexpr int kTileBytes = WG_BYTES + PED_TILE;
  static constexpr bool kDirProduct = true;
  static constexpr int kLast = LAST;
  static constexpr int kWidth = LAST == LAST_TRUNK ? W : WV;
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

// The ray kernels' pieces (fused_render.cu K1-K3, and kdiag.cu's probe B,
// which runs K1's chain without its compositing): the producer warp's
// thread index in their per-ray phases, the offset of the per-ray state
// behind the ring, tiles and mbarriers, and their tile source.
constexpr int IDLE = 1 << 30;  // producer's thread index in ray phases

// Byte offset of the per-ray state: the ring of n_ring stages, two
// warpgroups' PE / trunk / view tiles, 128 bytes of mbarriers.
__host__ __device__ inline int ray_state_offset(int n_ring) {
  return n_ring * STAGE_BYTES + 2 * WG_BYTES + 128;
}

// The chain's tile source for a block of nr rays of S points each, point p
// on ray p / S: the PE of x = ro + z rd from the per-ray state, view layer
// 0's per-ray term pv (ped @ wv0d + bv0, load_rays), raw rows to sm.raw.
struct RayTile {
  static constexpr int kTileBytes = WG_BYTES;
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
    return sm.pv + min(row / S, nr - 1) * WV;
  }
  __device__ __forceinline__ float* raw() const { return sm.raw; }
};

// The chain's tile source of kdiag.cu's probe A for a block of nr rays of
// S points each, from given encodings (pointers offset to the block's
// first point): the tile's xyz-PE copied from the bf16 PE rows
// (copy_rows), view layer 0's per-ray term pv from shared memory as
// RayTile's, raw rows to global memory.
struct PeRayTile {
  static constexpr int kTileBytes = WG_BYTES;
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
    return pv + min(row / S, nr - 1) * WV;
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
