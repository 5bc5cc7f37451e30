// The chain probe in f32 and in int8 for Hopper (sm_90a): kdiag.cu's
// kd_chain launches them for dtypes 1 and 2 (kernels/kdiag.py: chain).
// Each replaces a Pallas kernel of the JAX package's probe scripts:
//
// k_chain_f32_ring  replaces scripts/kdiag4.py (chain_kernel at :90, V3):
//   `depth` chained f32 (rows, 256) @ (256, 256) products with relu, no
//   cast, on the CUDA cores: fring.cuh's product, the one K6 f32's pass A
//   runs (fused_mlp_grad.cuh). The weight stream is ws itself: layer l's
//   row-major (256 x 256) f32 matrix is 16 stages of 16 K-rows (16 KB),
//   depth x 16 stages a tile, which the producer's one thread copies by
//   cp.async.bulk (chain.cuh chain_produce) through a ring of 4 stages,
//   the sequence repeated for every tile without draining. 128 rows a
//   tile: the 8 consumer warps own 16 rows each in a row-major f32
//   activation tile; thread l of warp w holds rows 16 w .. 16 w + 15 and
//   columns 4l..4l+3 and 128+4l..128+4l+3, so each weight float4 it loads
//   serves 16 rows. Per layer: fprod over the layer's 16 stages, a
//   barrier, relu in place; the last layer's relu goes from registers to
//   out. 384 threads: the 128 accumulators a thread need more registers
//   than a 288-thread block gives (168; it spilled), so the producer's
//   whole warpgroup gives its registers to the consumers' (setmaxnreg: 40
//   and 232 a thread). One block per SM walks a contiguous run of tiles,
//   at most one wave. f32 FFMAs, no tensor core (TF32 keeps 10 mantissa
//   bits against the probe's 1e-5). Bound by FFMA issue: depth x 65,536
//   FFMAs per row against 2 KB in and out.
// k_chain_i8_wg     replaces scripts/kdiag5.py (chain_kernel at :114, I0
//   and I1): int8 x int8 -> s32, relu, requant to int8 per layer, on
//   wgmma m64n128k32 s8 (hopper.cuh). 8-bit wgmma takes both operands
//   K-major, so the wrapper streams W_l^T (N rows of K bytes) as 4
//   pre-swizzled 16 KB stages a layer of 128 N-rows x 128 K-bytes, (N
//   half, K half) = (0, 0), (0, 1), (1, 0), (1, 1) (kernels/kdiag.py:
//   chain_weight_stream_i8), through a ring as the bf16 chain's. A
//   consumer warpgroup owns 64 rows in a K-major 128-byte-swizzled int8
//   tile (16 KB: two 128-byte K blocks, swz8), runs a layer's 4 stages
//   into the two 64 x 128 s32 halves of its accumulator in registers (4
//   k32 products a stage), drains, and requantises from the registers in
//   place into the tile, 2 bytes a store, each step rounded as the plain
//   version rounds it (s32 -> f32 is exact: |acc| < 2^24); after the last
//   layer its rows go out widened to f32. The bf16 chain's plans, the
//   block laid out and fed by kdiag.cuh wg_chain_begin: 128 rows a tile
//   on two warpgroups sharing each stage, a ring of 8, one block per SM;
//   64 rows on one warpgroup, a ring of 4, two blocks per SM. Bound by
//   the int8 tensor-core rate and by the f32 output (1 KB a row); the
//   requant costs about as many issue slots as a tile's products.
//
// They live apart from kdiag.cu: kernels added beside its probe B made
// ptxas serialize probe B's wgmma (C7511, PERF.md).
#include "fring.cuh"
#include "kdiag.cuh"

namespace fr {
namespace kd {

namespace {

__device__ __forceinline__ void st_shared_u16(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(a),
               "h"(static_cast<unsigned short>(v))
               : "memory");
}

}  // namespace

// ------------------------------------------------------ f32: FFMA ring

constexpr int F32_RING = 4;
constexpr int F32_KS = F_STAGE / W;  // K-rows a stage
constexpr int F32_RW = 16;           // rows a consumer warp owns
constexpr int F32_TILE = NWARP * F32_RW;
constexpr int F32_THREADS = NTHREADS + 128;
constexpr int F32_PRODUCER_REGS = 40, F32_CONSUMER_REGS = 232;

static_assert(NWARP == 8 && F32_RING <= MAX_RING,
              "8 consumer warps release each stage");
static_assert(NTHREADS * F32_CONSUMER_REGS + 128 * F32_PRODUCER_REGS <=
                  65536,
              "the f32 chain's registers exceed the SM's");

// 1,024 bytes to align the base, the ring, the activation tile, the
// mbarriers.
constexpr size_t F32_SMEM = 1024 + static_cast<size_t>(F32_RING) *
                                       STAGE_BYTES +
                            sizeof(float) * F32_TILE * W + 128;

// The f32 chain on 128-row tiles; the block walks tiles [blockIdx.x
// tiles_per_block, ...).
__global__ void __launch_bounds__(F32_THREADS, 1)
k_chain_f32_ring(const float* __restrict__ x, const float* __restrict__ ws,
                 float* __restrict__ out, int rows, int depth,
                 int tiles_per_block) {
  constexpr int RW = F32_RW, TILE = F32_TILE;
  extern __shared__ __align__(1024) char smem_raw[];
  const Chain c = chain_begin(smem_raw, F32_RING, sizeof(float) * TILE * W,
                              1, NWARP);
  float* h = reinterpret_cast<float*>(c.gbase + F32_RING * STAGE_BYTES);
  int row_base = 0;
  const int n_tiles = block_tiles(rows, TILE, tiles_per_block, &row_base);
  if (threadIdx.x >= NTHREADS) {  // thread 256 streams the weights
    setmaxnreg_dec<F32_PRODUCER_REGS>();
    chain_produce(c, reinterpret_cast<const bf16*>(ws), depth * (W / F32_KS),
                  n_tiles);
  } else {
    setmaxnreg_inc<F32_CONSUMER_REGS>();
    const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
    FRing r{c.gbase, c.bars, static_cast<uint32_t>(F32_RING), 0u};
    float acc[RW][8];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int row0 = row_base + t * TILE;
      load_rows(h, x + static_cast<size_t>(row0) * W, TILE, W,
                min(TILE, rows - row0), tid);
      named_barrier(1, NTHREADS);
      for (int li = 0; li < depth; ++li) {
        fprod<2, RW>(acc, r, h, W, W, w, l);
        named_barrier(1, NTHREADS);  // every warp's products have read h
        const bool last = li + 1 == depth;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int row = RW * w + i;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float4 v = make_float4(
                fmaxf(acc[i][4 * cc], 0.f), fmaxf(acc[i][4 * cc + 1], 0.f),
                fmaxf(acc[i][4 * cc + 2], 0.f),
                fmaxf(acc[i][4 * cc + 3], 0.f));
            acc[i][4 * cc] = acc[i][4 * cc + 1] = 0.f;
            acc[i][4 * cc + 2] = acc[i][4 * cc + 3] = 0.f;
            const int off = row * W + 128 * cc + 4 * l;
            if (!last)
              *reinterpret_cast<float4*>(h + off) = v;
            else if (row0 + row < rows)
              __stcs(reinterpret_cast<float4*>(
                         out + static_cast<size_t>(row0) * W + off),
                     v);
          }
        }
        if (!last) named_barrier(1, NTHREADS);
      }
    }
  }
  __syncthreads();
}

cudaError_t chain_f32(const void* x, const void* ws, void* out, int rows,
                      int depth, int rows_per_block, cudaStream_t st) {
  if (rows_per_block != F32_TILE) return cudaErrorInvalidValue;
  cudaError_t err = prepare(k_chain_f32_ring, F32_SMEM);
  if (err != cudaSuccess) return err;
  const int sms = current_sms();
  if (sms < 1) return cudaErrorInvalidDevice;
  int per_block = 0, blocks = 0;
  tile_plan(rows, F32_TILE, 1, sms, &per_block, &blocks);
  k_chain_f32_ring<<<blocks, F32_THREADS, F32_SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ws),
      static_cast<float*>(out), rows, depth, per_block);
  return cudaGetLastError();
}

// ------------------------------------------------------- int8: wgmma

constexpr int I8_TILE = 64 * W;  // bytes of a warpgroup's activation tile
constexpr int I8_STAGES = 4;     // stages a layer

// Byte offset of (row p, K byte b) in a K-major 128-byte-swizzled int8
// image of 64-row, 128-byte K blocks (an activation tile; a stage, whose
// 128 rows are all in K block 0): in a block, groups of 8 rows (1,024
// bytes), one 128-byte row each whose 16-byte chunks are permuted by
// chunk ^ (p % 8). It is hopper.cuh's swz in bytes.
__host__ __device__ __forceinline__ int swz8(int p, int b) {
  return ((b >> 7) << 13) + ((p >> 3) << 10) + ((p & 7) << 7) +
         ((((b >> 4) & 7) ^ (p & 7)) << 4) + (b & 15);
}

// 2^23, whose float has an ulp of 1: for an integer 0 <= n < 2^23 the
// float of bits MAGIC_BITS | n is exactly 2^23 + n.
constexpr float MAGIC = 8388608.f;
constexpr uint32_t MAGIC_BITS = 0x4B000000u;

// The int8 requant, each step rounded as the plain version rounds it (no
// FMA contraction): relu in the integer domain, then I0's f32 scale, +0.5,
// clip to [0, 127] and truncation, or I1's arithmetic shift -> a word
// whose low byte is the result. I0 converts through MAGIC, because I2F
// and F2I issue at a quarter of the FFMA rate on Hopper and the requant
// would spend most of its issue slots on them: a = relu(acc) <= 2^22
// (|acc| <= 256 * 128 * 128), so float(a) = (2^23 + a) - 2^23 exactly;
// with the relu and a positive scale q >= 0.5, so its clip at 0 changes
// nothing, and 2^23 + min(q, 127) rounded toward zero is 2^23 + trunc(min(
// q, 127)), whose low byte is the result.
template <int MODE>
__device__ __forceinline__ uint32_t requant(int a, float scale) {
  a = max(a, 0);
  if constexpr (MODE == M_I1) {
    return static_cast<uint32_t>(min(a >> 6, 127));
  } else {
    const float f = __fsub_rn(__uint_as_float(MAGIC_BITS | a), MAGIC);
    const float q = __fadd_rn(__fmul_rn(f, scale), 0.5f);
    return __float_as_uint(__fadd_rz(fminf(q, 127.f), MAGIC));
  }
}

// acc (64 x 128 s32) = A (the 64 x 256 int8 tile at shared address a) @
// the next 2 stages (K halves 0 and 1 of one N half of W_l^T).
__device__ __forceinline__ void prod_half_i8(int (&acc)[64], Ring& r,
                                             uint32_t a) {
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    const uint32_t st = ring_take(r);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_n128_s8(acc, desc_k(a + 8192 * kb + 32 * j), desc_k(st + 32 * j),
                    kb + j > 0 ? 1 : 0);
    wgmma_commit();
    ring_step(r);
  }
}

// tile (the K-major image at shared address h) = the requant of N half
// `half` of the layer's product, from wgmma's fragment order: thread l of
// warp w holds rows 16 w + l / 4 and + 8, columns 128 half + 8 (i / 4) +
// 2 (l % 4) + (i & 1); each adjacent pair is one 2-byte store.
template <int MODE>
__device__ __forceinline__ void requant_store(const int (&acc)[64], int half,
                                              uint32_t h, float scale,
                                              int wtid) {
  const int l = wtid & 31;
  const int r0 = 16 * (wtid >> 5) + (l >> 2);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 128 * half + 8 * (i >> 2) + 2 * (l & 3);
    st_shared_u16(h + swz8(row, col),
                  __byte_perm(requant<MODE>(acc[i], scale),
                              requant<MODE>(acc[i + 1], scale), 0x0040));
  }
}

// Warpgroup WG's 64 rows row0.. of one tile (rows at or past `rows` are
// zeros and write nothing) through `depth` layers in its tile at shared
// address h, then out as f32.
template <int MODE, int WG>
__device__ __forceinline__ void chain_i8_tile(
    const signed char* __restrict__ x, float* __restrict__ out, int rows,
    int depth, Ring& r, uint32_t h, int row0, int wtid) {
  constexpr int bar = 1 + WG;
  constexpr int CH = W / 16;  // 16-byte chunks of a row

  named_barrier(bar, 128);  // the previous tile's rows are out
  const uint4* xs = reinterpret_cast<const uint4*>(x);
  for (int e = wtid; e < 64 * CH; e += 128) {
    const int row = e / CH, c = e % CH;
    const size_t p = static_cast<size_t>(row0) + row;
    st_shared(h + swz8(row, 16 * c),
              p < static_cast<size_t>(rows) ? xs[p * CH + c]
                                            : make_uint4(0, 0, 0, 0));
  }
  fence_proxy_async();
  named_barrier(bar, 128);

  for (int li = 0; li < depth; ++li) {
    int acc0[64], acc1[64];
    prod_half_i8(acc0, r, h);
    prod_half_i8(acc1, r, h);
    ring_drain(r);
    named_barrier(bar, 128);  // every warp's products have read h
    const float scale = static_cast<float>(0.25 / (li + 2.0));
    requant_store<MODE>(acc0, 0, h, scale, wtid);
    requant_store<MODE>(acc1, 1, h, scale, wtid);
    fence_proxy_async();
    named_barrier(bar, 128);
  }

  // the last layer's bytes (0..127) out as f32, each through MAGIC
  for (int e = wtid; e < 64 * CH; e += 128) {
    const int row = e / CH, c = e % CH;
    const size_t p = static_cast<size_t>(row0) + row;
    if (p >= static_cast<size_t>(rows)) continue;
    const uint4 v = ld_shared(h + swz8(row, 16 * c));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    float4* d = reinterpret_cast<float4*>(out + p * W + 16 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)  // bytes k, 0, 0 and MAGIC's top byte
        f[k] = __fsub_rn(
            __uint_as_float(__byte_perm(words[j], MAGIC_BITS, 0x7440 + k)),
            MAGIC);
      __stcs(d + j, make_float4(f[0], f[1], f[2], f[3]));
    }
  }
}

// Warpgroup WG's part of the block's n_tiles tiles from row_base.
template <int MODE, int NWG, int WG>
__device__ __forceinline__ void chain_i8_walk(
    const signed char* __restrict__ x, float* __restrict__ out, int rows,
    int depth, int n_tiles, int row_base, uint32_t base, uint32_t bars) {
  constexpr uint32_t n_ring = wg_ring(NWG);
  Ring ring{base, bars, n_ring, 0, NO_STAGE};
  const uint32_t h = base + n_ring * STAGE_BYTES + WG * I8_TILE;
  for (int t = 0; t < n_tiles; ++t)
    chain_i8_tile<MODE, WG>(x, out, rows, depth, ring, h,
                            row_base + t * 64 * NWG + 64 * WG,
                            threadIdx.x & 127);
}

// The int8 chain of NWG consumer warpgroups (64 NWG rows a tile) and one
// producer warp (kdiag.cuh wg_chain_begin); the block walks tiles
// [blockIdx.x tiles_per_block, ...).
template <int MODE, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, NWG == 1 ? 2 : 1)
k_chain_i8_wg(const signed char* __restrict__ x,
              const signed char* __restrict__ wstream,
              float* __restrict__ out, int rows, int depth,
              int tiles_per_block) {
  extern __shared__ __align__(1024) char smem_raw[];
  int row_base = 0, n_tiles = 0;
  const Chain c = wg_chain_begin<NWG>(smem_raw, wstream, depth * I8_STAGES,
                                      I8_TILE, rows, tiles_per_block,
                                      &row_base, &n_tiles);
  const int wg = threadIdx.x >> 7;
  if (wg == 0)
    chain_i8_walk<MODE, NWG, 0>(x, out, rows, depth, n_tiles, row_base,
                                c.base, c.bars);
  else if constexpr (NWG == 2) {
    if (wg == 1)
      chain_i8_walk<MODE, NWG, 1>(x, out, rows, depth, n_tiles, row_base,
                                  c.base, c.bars);
  }
}

template <int MODE, int NWG>
cudaError_t launch_i8(const void* x, const void* wstream, void* out,
                      int rows, int depth, cudaStream_t st) {
  const size_t bytes = wg_smem(NWG, I8_TILE);
  cudaError_t err = prepare(k_chain_i8_wg<MODE, NWG>, bytes);
  if (err != cudaSuccess) return err;
  const int sms = current_sms();
  if (sms < 1) return cudaErrorInvalidDevice;
  int per_block = 0, blocks = 0;
  wg_plan(rows, NWG, sms, &per_block, &blocks);
  k_chain_i8_wg<MODE, NWG><<<blocks, 128 * NWG + 32, bytes, st>>>(
      static_cast<const signed char*>(x),
      static_cast<const signed char*>(wstream), static_cast<float*>(out),
      rows, depth, per_block);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_i8_mode(int mode, const void* x, const void* wstream,
                           void* out, int rows, int depth, cudaStream_t st) {
  switch (mode) {
    case M_I0:
      return launch_i8<M_I0, NWG>(x, wstream, out, rows, depth, st);
    case M_I1:
      return launch_i8<M_I1, NWG>(x, wstream, out, rows, depth, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t chain_i8(int mode, const void* x, const void* wstream, void* out,
                     int rows, int depth, int rows_per_block,
                     cudaStream_t st) {
  if (rows_per_block == 128)
    return launch_i8_mode<2>(mode, x, wstream, out, rows, depth, st);
  if (rows_per_block == 64)
    return launch_i8_mode<1>(mode, x, wstream, out, rows, depth, st);
  return cudaErrorInvalidValue;
}

int chain_dtype_config(int rows, int rows_per_block, int dtype, int sms,
                       int* plan) {
  if (dtype == 1 && rows_per_block == F32_TILE) {
    tile_plan(rows, F32_TILE, 1, sms, &plan[0], &plan[1]);
    plan[2] = F32_RING;
    plan[3] = static_cast<int>(F32_SMEM);
    plan[4] = F32_THREADS;
  } else if (dtype == 2 && (rows_per_block == 64 || rows_per_block == 128)) {
    const int nwg = rows_per_block / 64;
    wg_plan(rows, nwg, sms, &plan[0], &plan[1]);
    plan[2] = wg_ring(nwg);
    plan[3] = static_cast<int>(wg_smem(nwg, I8_TILE));
    plan[4] = 128 * nwg + 32;
  } else {
    return 1;
  }
  return 0;
}

}  // namespace kd
}  // namespace fr
