// What the chain probes of kdiag.cu (bf16, wgmma) and kdiag_dtype.cu (f32
// on FFMAs, int8 on wgmma) share: the epilogue modes, the card's SM
// count, the chains' launch plan, the wgmma chains' plans, a wgmma
// chain's block (wg_chain_begin: layout, mbarriers, producer; the int8
// chain's), and the entries kdiag.cu's kd_chain and kd_chain_config call
// for dtypes 1 and 2.
#pragma once

#include <cuda_runtime.h>

#include "chain.cuh"
#include "paper.cuh"

namespace fr {
namespace kd {

enum Mode {
  M_CAST = 0,       // bf16(acc)                        kdiag k_plain, kdiag4 V2
  M_RELU = 1,       // bf16(max(acc, 0))                kdiag4 V0, kdiag5 B0
                    // (f32: max(acc, 0), kdiag4 V3)
  M_BIAS_RELU = 2,  // bf16(max(acc + b, 0))            kdiag k_relu, kdiag4 V6
  M_SELECT = 3,     // bf16(acc > 0 ? acc : 0)          kdiag4 V5
  M_CAST_MAX = 4,   // max(bf16(acc), 0) in bf16        kdiag4 V7
  M_RELU2 = 5,      // M_BIAS_RELU, warpgroups skewed   kdiag k_relu2
  M_I0 = 6,         // int8(clip(f32(max(acc, 0)) * s + 0.5, 0, 127))  kdiag5 I0
  M_I1 = 7,         // int8(min(max(acc, 0) >> 6, 127))                kdiag5 I1
  M_SUM = 8,        // bf16(sum_l x @ w_l): one accumulator, no epilogue or
                    // barrier between layers; the products' own ceiling
};

inline int current_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// A chain's launch plan: the tiles of `tile` rows split evenly over at
// most one wave of `per_sm` blocks on each of `sms` SMs -> (tiles per
// block, blocks); block b walks tiles [b per_block, (b + 1) per_block).
inline void tile_plan(int rows, int tile, int per_sm, int sms,
                      int* per_block, int* blocks) {
  const int tiles = (rows + tile - 1) / tile;
  const int slots = sms * per_sm;
  *per_block = (tiles + slots - 1) / slots;
  *blocks = (tiles + *per_block - 1) / *per_block;
}

// The block's run of tiles of `tile` rows under tile_plan: its first row
// -> how many tiles it walks.
__device__ __forceinline__ int block_tiles(int rows, int tile,
                                           int tiles_per_block,
                                           int* row_base) {
  *row_base = blockIdx.x * tiles_per_block * tile;
  return min(tiles_per_block, (rows - *row_base + tile - 1) / tile);
}

// 16-byte shared-memory stores and loads by 32-bit shared address
__device__ __forceinline__ void st_shared(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// The wgmma chains' plans (bf16 in kdiag.cu, int8 in kdiag_dtype.cu) of
// `nwg` consumer warpgroups: 128 rows a tile on two warpgroups sharing
// each stage, a ring of 8, one block per SM; 64 rows on one, a ring of 4,
// two blocks per SM, each streaming its own weights.
__host__ __device__ constexpr int wg_ring(int nwg) {
  return nwg == 2 ? MAX_RING : 4;
}
__host__ __device__ constexpr int wg_blocks_per_sm(int nwg) {
  return nwg == 2 ? 1 : 2;
}
// 1,024 bytes to align the base, the ring, the warpgroups' activation
// tiles of tile_bytes each, the mbarriers.
__host__ __device__ constexpr size_t wg_smem(int nwg, int tile_bytes) {
  return 1024 + static_cast<size_t>(wg_ring(nwg)) * STAGE_BYTES +
         static_cast<size_t>(nwg) * tile_bytes + 128;
}

// A wgmma chain's launch plan on `sms` SMs: (tiles per block, blocks),
// the tiles of 64 nwg rows split evenly over at most one wave of blocks.
inline void wg_plan(int rows, int nwg, int sms, int* per_block,
                    int* blocks) {
  tile_plan(rows, 64 * nwg, wg_blocks_per_sm(nwg), sms, per_block, blocks);
}

// A wgmma chain's block (the int8 chain's; the bf16 chain keeps its own
// copy, kdiag.cu): NWG consumer warpgroups on tiles of 64 NWG rows and one
// producer warp. Lays out the ring of wg_ring(NWG) stages, the
// warpgroups' activation tiles of tile_bytes each and the mbarriers; the
// producer's one thread streams the n_stages 16 KB stages of wstream once
// per tile. Every thread calls it -> the layout (the ring at c.base, the
// tiles after it), and the block's first row and tile count
// (block_tiles); a consumer warpgroup then walks the tiles, the producer
// warp has done its part.
template <int NWG>
__device__ __forceinline__ Chain wg_chain_begin(char* smem_raw,
                                                const void* wstream,
                                                int n_stages, int tile_bytes,
                                                int rows, int tiles_per_block,
                                                int* row_base, int* n_tiles) {
  const Chain c =
      chain_begin(smem_raw, wg_ring(NWG), tile_bytes, NWG, 4 * NWG);
  *n_tiles = block_tiles(rows, 64 * NWG, tiles_per_block, row_base);
  if ((threadIdx.x >> 7) == NWG)
    chain_produce(c, static_cast<const bf16*>(wstream), n_stages, *n_tiles,
                  128 * NWG);
  return c;
}

// kdiag_dtype.cu: the f32 chain (mode M_RELU, ws the (depth, 256, 256)
// weights) at rows_per_block 128 and the int8 chain (M_I0, M_I1; wstream
// from kernels/kdiag.py: chain_weight_stream_i8) at 64 or 128, f32 out;
// anything else is cudaErrorInvalidValue.
cudaError_t chain_f32(const void* x, const void* ws, void* out, int rows,
                      int depth, int rows_per_block, cudaStream_t st);
cudaError_t chain_i8(int mode, const void* x, const void* wstream, void* out,
                     int rows, int depth, int rows_per_block,
                     cudaStream_t st);
// Their launch at rows_per_block on `sms` SMs (dtype 1 f32, 2 int8): plan
// = {tiles per block, blocks, ring stages, shared memory bytes, threads
// per block}; 0, or 1 for a plan they do not take.
int chain_dtype_config(int rows, int rows_per_block, int dtype, int sms,
                       int* plan);

}  // namespace kd
}  // namespace fr
