// Fused per-ray render kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by kernels/fused_render.py.
//
// fr_render_rays  replaces idealnerf_tpu/kernels/fused_render.py:
//                 fused_render_rays (_render_kernel -> _render_body), the
//                 fine pass of the full-fidelity frame render.
// fr_coarse_hier  replaces idealnerf_tpu/kernels/fused_render.py:
//                 fused_render_coarse_hier (_coarse_hier_kernel ->
//                 _render_body + _pdf_merge), the coarse pass plus the
//                 importance-depth placement.
// fr_render_delta replaces idealnerf_tpu/kernels/fused_render.py:
//                 fused_render_delta (_delta_kernel), the temporal delta
//                 frame: depth placement from the previous frame's per-ray
//                 (z, w) and the cached band, the fine render, and the next
//                 frame's foreground band, in one launch.
//
// What bounds them on the card: tensor-core work. A point costs about 558k
// MACs through the 8x256 trunk and the view branch against 16 bytes of
// per-point HBM traffic (a depth in, a weight out), so the kernels are far
// above the H100's ridge point; points never exist in HBM (PE is built from
// the ray packet in shared memory) and only per-ray summaries and weights
// are written.
//
// All three run their field MLP on one wgmma chain (chain_mlp):
// - Weight stream. The wrapper lays the chain's bf16 weights out in one
//   buffer of 16 KB stages, in the order the kernel consumes them, each
//   stage already in wgmma's 128-byte-swizzled shared-memory image
//   (kernels/fused_render.py: chain_weight_stream), one stream per net:
//     layer 0          (64 x 256)  2 stages of 32 K-rows, MN-major
//     layer i = 1..D-1 skip pe-part (64 x 256) first if layer i is a skip
//                      layer, 2 stages; then (256 x 256), 8 stages
//     view layer 0     (256 x 128) 4 stages of 64 K-rows, MN-major
//     view layer v     (128 x 128) 2 stages each
//     heads            one stage: w_alpha^T (16 x 256) then w_rgb^T
//                      (16 x 128), K-major
//   69 stages (1.1 MB) for the paper model (D=8, skip at 5, 3 view layers).
// - Block: 288 threads, two consumer warpgroups and one producer warp,
//   one block per group of rb rays. The producer's one thread keeps a
//   ring of 2-8 stages filled by cp.async.bulk on mbarriers, the stage
//   sequence repeated for every 128-point tile; both warpgroups read each
//   stage, so the weights cross L2 once per 128 points. Tiles run over the
//   block's rb x S points in order, so a tile may straddle rays and the
//   last one may be partial (its rows past the block's points are zeros).
// - Per layer, per warpgroup (64 rows of the tile): A is the activation tile
//   in shared memory (K-major, 128-byte swizzle: swz), B the stage, the
//   accumulator (64 x 256 f32, 128 registers a thread) stays in registers;
//   one wgmma group in flight, the stage before it released. The epilogue
//   adds the bias (view layer 0: the per-ray term pv), applies relu, rounds
//   to bf16 and writes back in place into the same tile; the skip layer adds
//   PE x W_pe into the same accumulator. The heads are an n16 product whose
//   columns 0..3 go to sm.raw.
// - Around the chain each block runs render_body.cuh's per-ray code
//   unchanged; the producer warp joins its barriers with a thread index
//   past every loop (IDLE):
//     k_render_rays   load_rays, depths read from z, chain, composite
//     k_coarse_hier   load_rays, the near/far linspace, chain, composite,
//                     hier_depths
//     k_render_delta  load_rays, delta_depths, chain, composite,
//                     fg_band_out
// Bound: tensor-core work (43.3 TFLOP for the fine pass of a 450x450 frame,
// 14.4 for its coarse pass, 2.30 for a delta frame at 129,024 rays x 16);
// the weight stream moves about 8.6 KB of L2 traffic per point.
#include "hopper.cuh"
#include "render_body.cuh"

namespace fr {

// ------------------------------------------------------------ wgmma chain

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
constexpr int WG_BYTES = PE_TILE + H_TILE + HV_TILE;
constexpr int IDLE = 1 << 30;      // producer's thread index in ray phases
constexpr uint32_t NO_STAGE = 0xFFFFFFFFu;

static_assert(W == 256 && WV == 128 && PE_PAD == 64 && HEADS == 16,
              "the chain's stages are laid out for the paper widths");

// Per-ray state of the chain kernels (f32, each region 128-byte aligned):
// ro, rd, dn, ped, pv, z, raw, w, cdf, uni, zp, wp as in Smem; regions a
// kernel does not use have no rows (n_cdf, n_union, n_prev 0).
__host__ __device__ inline size_t ray_state_layout(char* base, int rb, int S,
                                                   int n_cdf, int n_union,
                                                   int n_prev, Smem* sm) {
  const size_t n[12] = {static_cast<size_t>(rb) * 3,
                        static_cast<size_t>(rb) * 3,
                        static_cast<size_t>(rb),
                        static_cast<size_t>(rb) * PED_PAD,
                        static_cast<size_t>(rb) * WV,
                        static_cast<size_t>(rb) * S,
                        static_cast<size_t>(rb) * S * 4,
                        static_cast<size_t>(rb) * S,
                        static_cast<size_t>(rb) * n_cdf,
                        static_cast<size_t>(rb) * n_union,
                        static_cast<size_t>(rb) * n_prev,
                        static_cast<size_t>(rb) * n_prev};
  float* p[12];
  size_t total = 0;
  for (int i = 0; i < 12; ++i) {
    p[i] = base ? reinterpret_cast<float*>(base + total) : nullptr;
    total += (sizeof(float) * n[i] + 127) & ~static_cast<size_t>(127);
  }
  if (sm != nullptr) {
    *sm = Smem{};
    sm->ro = p[0];
    sm->rd = p[1];
    sm->dn = p[2];
    sm->ped = p[3];
    sm->pv = p[4];
    sm->z = p[5];
    sm->raw = p[6];
    sm->w = p[7];
    sm->cdf = p[8];
    sm->uni = p[9];
    sm->zp = p[10];
    sm->wp = p[11];
  }
  return total;
}

// Byte offset of the per-ray state: the ring of n_ring stages, two
// warpgroups' PE / trunk / view tiles, 128 bytes of mbarriers.
__host__ __device__ inline int ray_state_offset(int n_ring) {
  return n_ring * STAGE_BYTES + 2 * WG_BYTES + 128;
}

// Dynamic shared memory of a chain kernel: 1,024 bytes to align the base,
// then the ring, the tiles, the mbarriers and the per-ray state.
__host__ __device__ inline size_t chain_smem_bytes(int rb, int S, int n_cdf,
                                                   int n_union, int n_prev,
                                                   int n_ring) {
  return 1024 + ray_state_offset(n_ring) +
         ray_state_layout(nullptr, rb, S, n_cdf, n_union, n_prev, nullptr);
}

// Stages of one tile's weight stream (the order in the note at the top).
inline int chain_stages(const unsigned long long* slots, int depth,
                        int n_views) {
  int n = PE_PAD / KC_W;
  for (int i = 1; i < depth; ++i)
    n += W / KC_W + (slots[SLOT_WSKIP + i] ? PE_PAD / KC_W : 0);
  return n + W / KC_V + (n_views - 1) * (WV / KC_V) + 1;
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

// acc[0:64] = A (64 x K at a) @ the next K / KC_V stages (K x 128)
__device__ __forceinline__ void prod_v(float (&acc)[128], Ring& r,
                                       uint32_t a, int K) {
  for (int k0 = 0; k0 < K; k0 += KC_V) {
    const uint32_t st = ring_take(r);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC_V / 16; ++j)
      wgmma_n128_kmn(acc, a_desc(a, k0 + 16 * j),
                     desc_mn(st + 2048 * j, KC_V * 128),
                     k0 == 0 && j == 0 ? 0 : 1);
    wgmma_commit();
    ring_step(r);
  }
}

// tile (64 x 2 NR, K-major image) = bf16(relu(acc + bias)), as relu of
// the rounded pair (the same values). Thread l of warp w holds rows
// 16 w + l / 4 (lo) and + 8 (hi), columns 8 (i / 4) + 2 (l % 4) + (i & 1);
// bias_lo / bias_hi are the two rows' bias vectors. Each chunk of 32
// values loads its bias pairs before its stores: a load behind a store
// through generic pointers would wait for the store.
template <int NR>
__device__ __forceinline__ void relu_store(const float (&acc)[128],
                                           bf16* tile, const float* bias_lo,
                                           const float* bias_hi, int wtid) {
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
      *reinterpret_cast<__nv_bfloat162*>(tile + swz(r0 + 8 * hi, col)) =
          __hmax2(__floats2bfloat162_rn(acc[i] + bb.x, acc[i + 1] + bb.y),
                  __float2bfloat162_rn(0.f));
    }
  }
}

// The MLP of one 128-point tile, for warpgroup wg (rows 64 wg .. +64):
// PE -> trunk -> view branch -> heads -> sm.raw.
// tiles: the warpgroup's PE, trunk and view tiles, 1,024-byte aligned.
__device__ __forceinline__ void chain_tile(const Net& net, const Smem& sm,
                                           Ring& r, char* tiles,
                                           int tile_base, int n_pts, int S,
                                           int nr, int wg, int wtid) {
  const int bar = 1 + wg;
  const int row0 = tile_base + 64 * wg;
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  bf16* h_g = pe_g + PE_TILE / 2;
  bf16* hv_g = h_g + H_TILE / 2;
  const uint32_t pe = smem_addr(tiles), h = pe + PE_TILE, hv = h + H_TILE;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // the tile's PE, 8 lanes per 16-byte chunk; rows past n_pts are zeros
  named_barrier(bar, 128);
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
      v[k] = __float2bfloat16(p < n_pts ? pe_lane(x, 8 * c + k, net.multires)
                                        : 0.f);
    *reinterpret_cast<uint4*>(pe_g + swz(row, 8 * c)) =
        *reinterpret_cast<const uint4*>(v);
  }
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

  // view branch; layer 0 adds the per-ray term pv of each row's ray
  const int lrow = 16 * (wtid >> 5) + ((wtid & 31) >> 2);
  for (int v = 0; v < net.n_views; ++v) {
    prod_v(acc, r, v == 0 ? h : hv, v == 0 ? W : WV);
    ring_drain(r);
    named_barrier(bar, 128);
    if (v == 0) {
      const int r_lo = min((row0 + lrow) / S, nr - 1);
      const int r_hi = min((row0 + lrow + 8) / S, nr - 1);
      relu_store<64>(acc, hv_g, sm.pv + r_lo * WV, sm.pv + r_hi * WV, wtid);
    } else {
      const float* b = fvec(net, SLOT_BV + v);
      relu_store<64>(acc, hv_g, b, b, wtid);
    }
    fence_proxy_async();
    named_barrier(bar, 128);
  }

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
                   desc_k(st + 8192 + (k >> 6) * 2048 + (k & 63) * 2), 1);
    wgmma_commit();
    ring_step(r);
    ring_drain(r);
  }
  const int q = wtid & 3;
  if (q < 2) {
    const float* bh = fvec(net, SLOT_BHEADS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = row0 + lrow + 8 * (i >> 1), col = 2 * q + (i & 1);
      if (p < n_pts) sm.raw[p * 4 + col] = acc[i] + bh[col];
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

// Lays out the block's shared memory (the per-ray state into sm) and
// initialises the ring's mbarriers; every thread calls it, and it ends
// with __syncthreads.
__device__ __forceinline__ Chain chain_begin(char* smem_raw, int n_ring,
                                             int rb, int S, int n_cdf,
                                             int n_union, int n_prev,
                                             Smem* sm) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const Chain c{base, base + n_ring * STAGE_BYTES + 2 * WG_BYTES,
                smem_raw + (base - raw), n_ring};
  ray_state_layout(c.gbase + ray_state_offset(n_ring), rb, S, n_cdf,
                   n_union, n_prev, sm);
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

// A thread's index in the per-ray phases: the consumers' own, the
// producer warp's past every loop, so that it only joins their barriers.
__device__ __forceinline__ int ray_tid() {
  return threadIdx.x < NTHREADS ? static_cast<int>(threadIdx.x) : IDLE;
}

// The field MLP of the block's n_pts = nr x S points (sm.z, ro, rd, pv ->
// sm.raw): the producer's one thread streams the n_stages weight stages
// (chain_stages) once per 128-point tile through the ring while the two
// warpgroups run chain_tile on each tile. Every thread calls it; it ends
// with __syncthreads.
__device__ __forceinline__ void chain_mlp(const Net& net, const Smem& sm,
                                          const Chain& c,
                                          const bf16* __restrict__ wstream,
                                          int n_stages, int n_pts, int S,
                                          int nr) {
  const int wg = threadIdx.x >> 7;
  const uint32_t n = static_cast<uint32_t>(c.n_ring);
  if (wg == 2) {
    if (threadIdx.x == 256) {
      const uint32_t total = (n_pts + DT - 1) / DT * n_stages;
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
  } else {
    Ring ring{c.base, c.bars, n, 0, NO_STAGE};
    char* tiles = c.gbase + c.n_ring * STAGE_BYTES + wg * WG_BYTES;
    for (int t0 = 0; t0 < n_pts; t0 += DT)
      chain_tile(net, sm, ring, tiles, t0, n_pts, S, nr, wg,
                 threadIdx.x & 127);
  }
  __syncthreads();
}

// The fine pass: rays at given depths z (R, S).
__global__ void __launch_bounds__(D_THREADS, 1)
k_render_rays(Net net, const bf16* __restrict__ wstream, int n_stages,
              const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, const float* __restrict__ bc,
              const float* __restrict__ zin, float* __restrict__ summary,
              float* __restrict__ weights, int R, int S, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem sm;
  const Chain c = chain_begin(smem_raw, n_ring, rb, S, 0, 0, 0, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  for (int e = tid; e < n_pts; e += NTHREADS)
    sm.z[e] = zin[static_cast<size_t>(ray0) * S + e];
  __syncthreads();
  chain_mlp(net, sm, c, wstream, n_stages, n_pts, S, nr);
  composite(net, sm, bc, summary, weights, ray0, nr, S, tid);
}

// The coarse pass on the near/far linspace of S depths, then the fine
// depths z_all (R, S + n_imp) placed from its weights.
__global__ void __launch_bounds__(D_THREADS, 1)
k_coarse_hier(Net net, const bf16* __restrict__ wstream, int n_stages,
              const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, const float* __restrict__ bc,
              float near, float far, float* __restrict__ summary,
              float* __restrict__ weights, float* __restrict__ z_all, int R,
              int S, int n_imp, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem sm;
  const Chain c =
      chain_begin(smem_raw, n_ring, rb, S, S - 1, S + n_imp, 0, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  // coarse depths: the static near/far linspace, t = s / (S - 1), each
  // step rounded as core/sampling.py:stratified_sample rounds it
  for (int e = tid; e < n_pts; e += NTHREADS) {
    const float t = __fdiv_rn(static_cast<float>(e % S),
                              static_cast<float>(S - 1));
    sm.z[e] = __fadd_rn(__fmul_rn(near, __fsub_rn(1.f, t)),
                        __fmul_rn(far, t));
  }
  __syncthreads();
  chain_mlp(net, sm, c, wstream, n_stages, n_pts, S, nr);
  composite(net, sm, bc, summary, weights, ray0, nr, S, tid);
  hier_depths(sm, z_all, ray0, nr, S, n_imp, tid);
}

// The delta frame: S = s_uni + s_imp + 1 depths per ray placed from the
// previous frame's z_prev / w_prev (R, s_prev) and the cached band.
__global__ void __launch_bounds__(D_THREADS, 1)
k_render_delta(Net net, const bf16* __restrict__ wstream, int n_stages,
               const float* __restrict__ rays_o,
               const float* __restrict__ rays_d, const float* __restrict__ bc,
               const float* __restrict__ z_prev,
               const float* __restrict__ w_prev,
               const float* __restrict__ band_lo,
               const float* __restrict__ band_hi, float far, float q_lo,
               float q_hi, float* __restrict__ summary,
               float* __restrict__ weights, float* __restrict__ z_out, int R,
               int s_prev, int s_uni, int s_imp, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const int S = s_uni + s_imp + 1;
  Smem sm;
  const Chain c = chain_begin(smem_raw, n_ring, rb, S, s_prev - 2, S - 1,
                              s_prev, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  const size_t gp = static_cast<size_t>(ray0) * s_prev;
  for (int e = tid; e < nr * s_prev; e += NTHREADS) {
    sm.zp[e] = z_prev[gp + e];
    sm.wp[e] = w_prev[gp + e];
  }
  __syncthreads();
  delta_depths(sm, band_lo, band_hi, far, ray0, nr, s_prev, s_uni, s_imp,
               tid);
  chain_mlp(net, sm, c, wstream, n_stages, n_pts, S, nr);
  composite(net, sm, bc, summary, weights, ray0, nr, S, tid);
  for (int e = tid; e < n_pts; e += NTHREADS)
    z_out[static_cast<size_t>(ray0) * S + e] = sm.z[e];
  fg_band_out(sm, summary, ray0, nr, S, q_lo, q_hi, tid);
}

// A chain kernel's launch: the stream must hold the net's stages and the
// ring 2..MAX_RING of them; sets the kernel's shared memory.
template <typename K>
inline cudaError_t chain_prepare(K kernel, size_t bytes,
                                 const unsigned long long* slots, int depth,
                                 int n_views, int n_stages, int n_ring) {
  if (n_stages != chain_stages(slots, depth, n_views) || n_ring < 2 ||
      n_ring > MAX_RING)
    return cudaErrorInvalidValue;
  return prepare(kernel, bytes);
}

}  // namespace fr

extern "C" {

int fr_num_slots() { return fr::NSLOTS; }

// Shared memory of render_body.cuh's wmma ray blocks (the kdiag.cu
// render probes).
unsigned long long fr_smem_bytes(int rb, int S) {
  return fr::smem_layout(nullptr, rb, S, nullptr);
}

unsigned long long fr_chain_smem_bytes(int rb, int S, int n_cdf,
                                       int n_union, int n_prev, int n_ring) {
  return fr::chain_smem_bytes(rb, S, n_cdf, n_union, n_prev, n_ring);
}

// The chain's ring: bytes per stage, the most stages it may hold.
int fr_stage_bytes() { return fr::STAGE_BYTES; }
int fr_max_ring() { return fr::MAX_RING; }

const char* fr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chain kernels take wstream: n_stages stages of the net's weight
// stream (16-byte aligned); n_ring: stages of the shared-memory ring
// (2..MAX_RING); one block per group of rb rays.
int fr_render_rays(const float* rays_o, const float* rays_d, const float* bc,
                   const float* z, float* summary, float* weights, int R,
                   int S, int rb, const unsigned long long* slots, int depth,
                   int n_views, int multires, int multires_views,
                   int softplus, const void* wstream, int n_stages,
                   int n_ring, void* stream) {
  const size_t bytes = fr::chain_smem_bytes(rb, S, 0, 0, 0, n_ring);
  cudaError_t err = fr::chain_prepare(fr::k_render_rays, bytes, slots, depth,
                                      n_views, n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int grid = (R + rb - 1) / rb;
  fr::k_render_rays<<<grid, fr::D_THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(wstream), n_stages, rays_o, rays_d,
      bc, z, summary, weights, R, S, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

int fr_coarse_hier(const float* rays_o, const float* rays_d, const float* bc,
                   float near, float far, float* summary, float* weights,
                   float* z_all, int R, int S, int n_imp, int rb,
                   const unsigned long long* slots, int depth, int n_views,
                   int multires, int multires_views, int softplus,
                   const void* wstream, int n_stages, int n_ring,
                   void* stream) {
  const size_t bytes =
      fr::chain_smem_bytes(rb, S, S - 1, S + n_imp, 0, n_ring);
  cudaError_t err = fr::chain_prepare(fr::k_coarse_hier, bytes, slots, depth,
                                      n_views, n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int grid = (R + rb - 1) / rb;
  fr::k_coarse_hier<<<grid, fr::D_THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(wstream), n_stages, rays_o, rays_d,
      bc, near, far, summary, weights, z_all, R, S, n_imp, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

int fr_render_delta(const float* rays_o, const float* rays_d, const float* bc,
                    const float* z_prev, const float* w_prev,
                    const float* band_lo, const float* band_hi, float far,
                    float q_lo, float q_hi, float* summary, float* weights,
                    float* z_out, int R, int s_prev, int s_uni, int s_imp,
                    int rb, const unsigned long long* slots, int depth,
                    int n_views, int multires, int multires_views,
                    int softplus, const void* wstream, int n_stages,
                    int n_ring, void* stream) {
  const int S = s_uni + s_imp + 1;
  const size_t bytes =
      fr::chain_smem_bytes(rb, S, s_prev - 2, S - 1, s_prev, n_ring);
  cudaError_t err = fr::chain_prepare(fr::k_render_delta, bytes, slots,
                                      depth, n_views, n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int grid = (R + rb - 1) / rb;
  fr::k_render_delta<<<grid, fr::D_THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(wstream), n_stages, rays_o, rays_d,
      bc, z_prev, w_prev, band_lo, band_hi, far, q_lo, q_hi, summary,
      weights, z_out, R, s_prev, s_uni, s_imp, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
