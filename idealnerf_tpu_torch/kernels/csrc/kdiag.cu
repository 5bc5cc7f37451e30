// Kernel-diagnosis probes for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by kernels/kdiag.py. They take the fused MLP's time
// apart on the card, as the TPU probes under scripts/ took it apart there:
//
// kd_chain     replaces scripts/kdiag.py (k_plain, k_relu, k_relu2 at :70),
//              scripts/kdiag4.py (chain_kernel at :90) and scripts/kdiag5.py
//              (chain_kernel at :114): `depth` chained (rows, 256) @ (256,
//              256) products with one epilogue between layers:
//              - bf16 with f32 accumulation on the wgmma chain of chain.cuh
//                (k_chain_wg), the body K1-K5 run: cast only, relu, bias +
//                relu, compare + select, cast then max, bias + relu with
//                the two warpgroups skewed (relu2), and products only
//                (sum: every layer into one accumulator, the port's own
//                bisection of the epilogue from the products);
//              - f32 on FFMAs and int8 on wgmma: kdiag_dtype.cu, a
//                translation unit of its own, which kd_chain launches.
// kd_ladder    replaces scripts/kdiag2.py (:114, rungs v0-v2) and
// kd_render_a  replaces scripts/kdiag3.py (kernel_A, :269): in kdiag_pe.cu,
//              a translation unit of their own.
// kd_render_b  replaces scripts/kdiag3.py (kernel_B, :291): the fine pass
//              (K1, fr_render_rays) without its compositing: load_rays, the
//              depths from z and K1's chain with its ray tile source
//              (RayTile, chain.cuh), the raw rows written to global memory.
//              K1 less this probe is K1's per-ray code and compositing.
//              kdiag3's kernel_C (:315) is K1 itself.
//
// What bounds them on the card: tensor-core work (f32: the CUDA cores). A
// chain row costs depth x 65,536 MACs against 512 bytes in and 512-1,024
// out.
//
// The bf16 chain (k_chain_wg). The wrapper streams layer l's (256 x 256)
// matrix as 8 pre-swizzled MN-major 16 KB stages of 32 K-rows
// (kernels/kdiag.py: chain_weight_stream), depth x 8 stages; the
// producer's one thread copies them by cp.async.bulk through a ring in
// shared memory, the sequence repeated for every tile without draining.
// A consumer warpgroup owns 64 rows: it loads them from row-major x into
// its K-major 128-byte-swizzled activation tile (rows at or past `rows`
// zeros), then per layer runs the products of the layer's 8 stages
// (prod_layer, chain.cuh's prod_w unrolled: a 64 x 256 f32 accumulator
// in registers, one wgmma group in flight), drains the ring, and writes the
// mode's epilogue back into the same tile, rounded as the plain version
// rounds it; after the last layer it copies its rows out in 16-byte
// chunks (widened to f32 with out_f32). Blocks walk a contiguous run of
// tiles, at most one wave of them (as K4 does). Two plans:
//   rows_per_block 128: 288 threads, two consumer warpgroups on one
//     128-row tile a step, both reading each stage, so the weights cross
//     L2 once per 128 rows; a ring of 8 stages; one block per SM;
//   rows_per_block 64: 160 threads, one consumer warpgroup on a 64-row
//     tile a step, a ring of 4 stages; two blocks per SM, each streaming
//     its own weights: the weights cross L2 once per 64 rows.
// sum: A is the input tile for every layer and the accumulator is never
//   cleared; no drain, barrier or epilogue between layers: the chain's own
//   product-and-stream ceiling.
// relu2 (the TPU probe's two half tiles, whose epilogues may overlap each
//   other's products): at 128, warpgroup 1 starts each layer's products
//   only after warpgroup 0 has issued that layer's first 4 stages (a named
//   barrier, arrive / sync), so it runs at least half a layer behind and
//   one warpgroup's epilogue overlaps the other's wgmma; the ring (8
//   stages) holds the lead. At 64 a block has one warpgroup and relu2 is
//   bias + relu: the SM's two blocks are the independent chains.
// At the dense bf16 peak a 128-row tile's weights would cross L2 at 7.7
// TB/s (15.5 at 64 rows); `sum` against the other modes shows whether the
// stream or the epilogues bound the chain (PERF.md: neither; the
// chain draws the card's power limit).
#include "chain.cuh"
#include "kdiag.cuh"

namespace fr {
namespace kd {

// ------------------------------------------------- bf16: the wgmma chain

constexpr int SKEW_BAR = 3;  // relu2's named barrier (1 and 2: the tiles')

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
// a bf16 pair's shared-memory store by 32-bit shared address (16-byte
// ones: kdiag.cuh)
__device__ __forceinline__ void st_shared(uint32_t a, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a),
               "r"(*reinterpret_cast<uint32_t*>(&v))
               : "memory");
}

// One pair of adjacent columns through the mode's epilogue (b: their bias).
template <int MODE>
__device__ __forceinline__ __nv_bfloat162 epilogue_pair(float a0, float a1,
                                                        float2 b) {
  if constexpr (MODE == M_CAST || MODE == M_SUM) {
    return __floats2bfloat162_rn(a0, a1);
  } else if constexpr (MODE == M_SELECT) {
    return __floats2bfloat162_rn(a0 > 0.f ? a0 : 0.f, a1 > 0.f ? a1 : 0.f);
  } else if constexpr (MODE == M_CAST_MAX) {
    return __hmax2(__floats2bfloat162_rn(a0, a1), __float2bfloat162_rn(0.f));
  } else if constexpr (MODE == M_BIAS_RELU || MODE == M_RELU2) {
    return __floats2bfloat162_rn(fmaxf(a0 + b.x, 0.f), fmaxf(a1 + b.y, 0.f));
  } else {
    return __floats2bfloat162_rn(fmaxf(a0, 0.f), fmaxf(a1, 0.f));
  }
}

// tile (64 x 256, K-major image at that shared address; addresses, not
// generic pointers, keep the unrolled chain inside its registers) = the
// mode's epilogue of layer li's acc,
// in chain.cuh:relu_store's fragment order (thread l of warp w: rows 16 w
// + l / 4 and + 8, columns 8 (i / 4) + 2 (l % 4) + (i & 1)); the bias
// modes read row li of bias (depth, 256).
template <int MODE>
__device__ __forceinline__ void mode_store(const float (&acc)[128],
                                           uint32_t tile, const float* bias,
                                           int li, int wtid) {
  const int l = wtid & 31;
  const int r0 = 16 * (wtid >> 5) + (l >> 2);
#pragma unroll
  for (int i0 = 0; i0 < 128; i0 += 32) {
    float2 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (MODE == M_BIAS_RELU || MODE == M_RELU2) {
        b[j] = *reinterpret_cast<const float2*>(
            bias + li * W + 8 * ((i0 >> 2) + j) + 2 * (l & 3));
      } else {
        b[j] = make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = i0; i < i0 + 32; i += 2) {
      const int col = 8 * (i >> 2) + 2 * (l & 3);
      st_shared(tile + 2 * swz(r0 + 8 * ((i >> 1) & 1), col),
                epilogue_pair<MODE>(acc[i], acc[i + 1], b[(i - i0) >> 2]));
    }
  }
}

// acc (+)= A (64 x 256 at a) @ the layer's 8 stages: chain.cuh's prod_w
// over W, unrolled (the loop kept rolled, which also spilled, ran the
// 128-row chain 10-25 % slower in one A/B, PERF.md; the tiles'
// shared addresses, not generic pointers, keep the unrolled layer inside
// the 168 registers a thread of a 288-thread block gets), which with
// kSignal arrives on relu2's barrier once the first 4 stages are issued.
template <bool kSignal>
__device__ __forceinline__ void prod_layer(float (&acc)[128], Ring& r,
                                           uint32_t a, bool first) {
#pragma unroll
  for (int k0 = 0; k0 < W; k0 += KC_W) {
    if (kSignal && k0 == W / 2) named_arrive(SKEW_BAR, 256);
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

// Warpgroup WG's 64 rows row0.. of one tile (rows at or past `rows` are
// zeros and write nothing) through `depth` layers in its activation tile
// at shared address h, then out. WG is a template parameter: the
// warpgroup's barrier, its rows and its part in relu2's skew are
// constants.
template <int MODE, int NWG, int WG>
__device__ __forceinline__ void chain_wg_tile(
    const bf16* __restrict__ x, const float* __restrict__ bias,
    void* __restrict__ out, int out_f32, int rows, int depth, Ring& r,
    uint32_t h, int row0, int wtid) {
  constexpr int bar = 1 + WG;
  float acc[128];

  named_barrier(bar, 128);  // the previous tile's rows are out
  const uint4* xs = reinterpret_cast<const uint4*>(x);
  for (int e = wtid; e < 64 * (W / 8); e += 128) {
    const int row = e >> 5, c = e & 31;
    const size_t p = static_cast<size_t>(row0) + row;
    const uint4 v = p < static_cast<size_t>(rows) ? xs[p * (W / 8) + c]
                                                  : make_uint4(0, 0, 0, 0);
    st_shared(h + 2 * swz(row, 8 * c), v);
  }
  fence_proxy_async();
  named_barrier(bar, 128);

  constexpr bool kSkew = MODE == M_RELU2 && NWG == 2;
  for (int li = 0; li < depth; ++li) {
    // relu2: warpgroup 1 starts a layer once warpgroup 0 has issued its
    // first 4 stages
    if constexpr (kSkew && WG == 1) named_barrier(SKEW_BAR, 256);
    prod_layer<kSkew && WG == 0>(acc, r, h, MODE != M_SUM || li == 0);
    if (MODE == M_SUM && li + 1 < depth) continue;
    ring_drain(r);
    named_barrier(bar, 128);  // every warp's products have read h
    mode_store<MODE>(acc, h, bias, li, wtid);
    fence_proxy_async();
    named_barrier(bar, 128);
  }

  for (int e = wtid; e < 64 * (W / 8); e += 128) {
    const int row = e >> 5, c = e & 31;
    const size_t p = static_cast<size_t>(row0) + row;
    if (p >= static_cast<size_t>(rows)) continue;
    const uint4 v = ld_shared(h + 2 * swz(row, 8 * c));
    if (out_f32) {
      const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 f0 = __bfloat1622float2(q[0]);
      const float2 f1 = __bfloat1622float2(q[1]);
      const float2 f2 = __bfloat1622float2(q[2]);
      const float2 f3 = __bfloat1622float2(q[3]);
      float4* d = static_cast<float4*>(out) + p * (W / 4) + 2 * c;
      d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    } else {
      static_cast<uint4*>(out)[p * (W / 8) + c] = v;
    }
  }
}

// Warpgroup WG's part of the block's n_tiles tiles from row_base: its ring
// view and activation tile (after the ring, at shared address base).
template <int MODE, int NWG, int WG>
__device__ __forceinline__ void chain_wg_walk(
    const bf16* __restrict__ x, const float* __restrict__ bias,
    void* __restrict__ out, int out_f32, int rows, int depth, int n_tiles,
    int row_base, uint32_t base, uint32_t bars) {
  constexpr uint32_t n_ring = wg_ring(NWG);
  Ring ring{base, bars, n_ring, 0, NO_STAGE};
  const uint32_t h = base + n_ring * STAGE_BYTES + WG * H_TILE;
  for (int t = 0; t < n_tiles; ++t)
    chain_wg_tile<MODE, NWG, WG>(x, bias, out, out_f32, rows, depth, ring,
                                 h, row_base + t * 64 * NWG + 64 * WG,
                                 threadIdx.x & 127);
}

// The bf16 chain of NWG consumer warpgroups (64 NWG rows a tile) and one
// producer warp; the block walks tiles [blockIdx.x tiles_per_block, ...).
// Its own mbarrier init and producer loop, not kdiag.cuh wg_chain_begin
// (the int8 chain's): through wg_chain_begin this kernel kept its ptxas
// lines but ran 4-11 % slower at 128 rows in one A/B (PERF.md).
template <int MODE, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, NWG == 1 ? 2 : 1)
k_chain_wg(const bf16* __restrict__ x, const bf16* __restrict__ wstream,
           const float* __restrict__ bias, void* __restrict__ out,
           int out_f32, int rows, int depth, int tiles_per_block) {
  constexpr uint32_t n_ring = wg_ring(NWG);
  constexpr int TILE = 64 * NWG;
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + n_ring * STAGE_BYTES + NWG * H_TILE;
  if (threadIdx.x == 0) {
    for (uint32_t s = 0; s < n_ring; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (MAX_RING + s), 4 * NWG);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int row_base = blockIdx.x * tiles_per_block * TILE;
  const int n_tiles =
      min(tiles_per_block, (rows - row_base + TILE - 1) / TILE);
  const int n_stages = depth * (W / KC_W);
  if (wg == NWG) {
    // the producer's one thread: n_stages stages per tile, n_tiles times
    if (threadIdx.x == 128 * NWG) {
      const uint32_t total = static_cast<uint32_t>(n_tiles) * n_stages;
      for (uint32_t q = 0; q < total; ++q) {
        const uint32_t s = q % n_ring;
        if (q >= n_ring)
          mbar_wait(bars + 8 * (MAX_RING + s), ((q / n_ring) - 1) & 1);
        mbar_expect_tx(bars + 8 * s, STAGE_BYTES);
        bulk_g2s(base + s * STAGE_BYTES,
                 wstream + static_cast<size_t>(q % n_stages) * STAGE_ELEMS,
                 STAGE_BYTES, bars + 8 * s);
      }
    }
  } else if (wg == 0) {
    chain_wg_walk<MODE, NWG, 0>(x, bias, out, out_f32, rows, depth, n_tiles,
                                row_base, base, bars);
  } else if constexpr (NWG == 2) {
    chain_wg_walk<MODE, NWG, 1>(x, bias, out, out_f32, rows, depth, n_tiles,
                                row_base, base, bars);
  }
}

template <int MODE, int NWG>
cudaError_t launch_chain_wg(const void* x, const void* wstream,
                            const float* bias, void* out, int out_f32,
                            int rows, int depth, cudaStream_t st) {
  const size_t bytes = wg_smem(NWG, H_TILE);
  cudaError_t err = prepare(k_chain_wg<MODE, NWG>, bytes);
  if (err != cudaSuccess) return err;
  const int sms = current_sms();
  if (sms < 1) return cudaErrorInvalidDevice;
  int per_block = 0, blocks = 0;
  wg_plan(rows, NWG, sms, &per_block, &blocks);
  k_chain_wg<MODE, NWG><<<blocks, 128 * NWG + 32, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wstream), bias,
      out, out_f32, rows, depth, per_block);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_bf16(int mode, const void* x, const void* wstream,
                        const float* bias, void* out, int out_f32, int rows,
                        int depth, cudaStream_t st) {
  switch (mode) {
    case M_CAST:
      return launch_chain_wg<M_CAST, NWG>(x, wstream, bias, out, out_f32,
                                          rows, depth, st);
    case M_RELU:
      return launch_chain_wg<M_RELU, NWG>(x, wstream, bias, out, out_f32,
                                          rows, depth, st);
    case M_BIAS_RELU:
      return launch_chain_wg<M_BIAS_RELU, NWG>(x, wstream, bias, out,
                                               out_f32, rows, depth, st);
    case M_SELECT:
      return launch_chain_wg<M_SELECT, NWG>(x, wstream, bias, out, out_f32,
                                            rows, depth, st);
    case M_CAST_MAX:
      return launch_chain_wg<M_CAST_MAX, NWG>(x, wstream, bias, out,
                                              out_f32, rows, depth, st);
    case M_RELU2:
      return launch_chain_wg<M_RELU2, NWG>(x, wstream, bias, out, out_f32,
                                           rows, depth, st);
    case M_SUM:
      return launch_chain_wg<M_SUM, NWG>(x, wstream, bias, out, out_f32,
                                         rows, depth, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ probe B: K1's chain

// Probe B's per-ray state: ro, rd, dn, ped, pv and z, the first six regions
// of fused_render.cu's ray_state_layout; no raw or weight rows (the raw
// rows go to global memory, and nothing composites).
__host__ __device__ inline size_t probe_b_layout(char* base, int rb, int S,
                                                 Smem* sm) {
  const size_t n[6] = {static_cast<size_t>(rb) * 3,
                       static_cast<size_t>(rb) * 3, static_cast<size_t>(rb),
                       static_cast<size_t>(rb) * PED_PAD,
                       static_cast<size_t>(rb) * WV,
                       static_cast<size_t>(rb) * S};
  float* p[6];
  size_t total = 0;
  for (int i = 0; i < 6; ++i) {
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
  }
  return total;
}

// Dynamic shared memory of probe B: K1's ring, tiles and mbarriers, then
// its per-ray state.
__host__ __device__ inline size_t probe_b_smem(int rb, int S, int n_ring) {
  return 1024 + ray_state_offset(n_ring) +
         probe_b_layout(nullptr, rb, S, nullptr);
}

// kdiag3 B: K1 (fused_render.cu k_render_rays) up to its chain: load_rays,
// the depths read from z, then chain_mlp with RayTile, whose raw rows go
// to the block's rows of the global (R, S*4) output; no composite.
__global__ void __launch_bounds__(D_THREADS, 1)
k_render_probe_b(Net net, const bf16* __restrict__ wstream, int n_stages,
                 const float* __restrict__ rays_o,
                 const float* __restrict__ rays_d,
                 const float* __restrict__ zin, float* __restrict__ raw,
                 int R, int S, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const Chain c = chain_begin(smem_raw, n_ring, WG_BYTES);
  Smem sm;
  probe_b_layout(c.gbase + ray_state_offset(n_ring), rb, S, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  for (int e = tid; e < n_pts; e += NTHREADS)
    sm.z[e] = zin[static_cast<size_t>(ray0) * S + e];
  __syncthreads();
  sm.raw = raw + static_cast<size_t>(ray0) * S * 4;
  chain_mlp(net, RayTile{sm, S, nr}, c, wstream, n_stages, n_pts);
}

}  // namespace kd
}  // namespace fr

extern "C" {

// dtype: 0 bf16, 1 f32, 2 int8; mode: fr::kd::Mode. w: the weight stream
// of the depth layers, for bf16 depth x 8 stages
// (kernels/kdiag.py:chain_weight_stream), for int8 depth x 4
// (chain_weight_stream_i8), for f32 the (depth, 256, 256) weights
// themselves. Every (dtype, mode, rows_per_block) the kernels do not take
// returns cudaErrorInvalidValue.
int kd_chain(const void* x, const void* w, const float* bias, void* out,
             int out_f32, int rows, int depth, int dtype, int mode,
             int rows_per_block, void* stream) {
  using namespace fr::kd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (rows_per_block == 128)
      err = launch_bf16<2>(mode, x, w, bias, out, out_f32, rows, depth, st);
    else if (rows_per_block == 64)
      err = launch_bf16<1>(mode, x, w, bias, out, out_f32, rows, depth, st);
  } else if (dtype == 2 && out_f32) {
    err = chain_i8(mode, x, w, out, rows, depth, rows_per_block, st);
  } else if (dtype == 1 && mode == M_RELU && out_f32) {
    err = chain_f32(x, w, out, rows, depth, rows_per_block, st);
  }
  return static_cast<int>(err);
}

// The chain's launch of dtype (as kd_chain's) at rows_per_block (64 or
// 128) on the current card: plan = {tiles per block, blocks, ring stages,
// shared memory bytes, threads per block}.
int kd_chain_config(int rows, int rows_per_block, int dtype, int* plan) {
  if (rows_per_block != 64 && rows_per_block != 128) return 1;
  const int nwg = rows_per_block / 64;
  const int sms = fr::kd::current_sms();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  if (dtype != 0)
    return fr::kd::chain_dtype_config(rows, rows_per_block, dtype, sms, plan);
  fr::kd::wg_plan(rows, nwg, sms, &plan[0], &plan[1]);
  plan[2] = fr::kd::wg_ring(nwg);
  plan[3] = static_cast<int>(fr::kd::wg_smem(nwg, fr::H_TILE));
  plan[4] = 128 * nwg + 32;
  return 0;
}

unsigned long long kd_render_b_smem_bytes(int rb, int S, int n_ring) {
  return fr::kd::probe_b_smem(rb, S, n_ring);
}

// Probe B at K1's launch: wstream, n_stages and n_ring as fr_render_rays
// takes them; one block per group of rb rays.
int kd_render_b(const float* rays_o, const float* rays_d, const float* z,
                float* raw, int R, int S, int rb,
                const unsigned long long* slots, int depth, int n_views,
                int multires, int multires_views, const void* wstream,
                int n_stages, int n_ring, void* stream) {
  const size_t bytes = fr::kd::probe_b_smem(rb, S, n_ring);
  cudaError_t err = fr::chain_prepare(
      fr::kd::k_render_probe_b, bytes,
      fr::chain_stages(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, 0);
  fr::kd::k_render_probe_b<<<(R + rb - 1) / rb, fr::D_THREADS, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(wstream), n_stages, rays_o, rays_d,
      z, raw, R, S, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
