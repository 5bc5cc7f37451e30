// The f32 FFMA product on a weight ring, for Hopper (sm_90a): the f32
// kernels' counterpart of chain.cuh's wgmma chain, shared by the gradient
// kernel's pass A f32 (fused_mlp_grad.cuh) and the f32 chain probe V3
// (kdiag_dtype.cu).
//
// A producer thread streams row-major f32 K-slabs of 16 KB (16 rows of a
// 256-wide matrix, 32 of a 128-wide one; 4096 / N of an N-wide one)
// through a ring of shared-memory
// stages by cp.async.bulk on mbarriers (chain.cuh chain_produce); the
// consumer warps multiply a row-major f32 activation tile in shared memory
// by them in registers (fprod), one FFMA per multiply-add, k ascending.
// f32 FFMAs and no tensor core: TF32 keeps 10 mantissa bits, where these
// kernels must match f32 products.
#pragma once

#include "chain.cuh"

namespace fr {

constexpr int F_STAGE = STAGE_BYTES / 4;  // floats per weight stage

// A consumer's view of the weight ring: `it` counts the stages taken.
struct FRing {
  const char* stages;  // generic address of stage 0
  uint32_t bars, n, it;
};

__device__ __forceinline__ const float* fring_take(const FRing& r) {
  const uint32_t s = r.it % r.n;
  mbar_wait(r.bars + 8 * s, (r.it / r.n) & 1);
  return reinterpret_cast<const float*>(r.stages + s * STAGE_BYTES);
}
// After the warp's last read of the stage taken: one arrival per warp.
__device__ __forceinline__ void fring_release(FRing& r) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    mbar_arrive(r.bars + 8 * (MAX_RING + r.it % r.n));
  ++r.it;
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[i][j] += sum over k < K of A[RW w + i][k] * B[k][col j] for the
// thread's RW rows (warp w) and CPL = WIDTH / 32 columns (lane l): col 4 c
// + q = 128 c + 4 l + q, or 2 l + q in a 64-wide layer. A: a row-major f32
// tile in shared memory (lda floats); B: the next K rows of the weight
// stream, stages of KS = F_STAGE / WIDTH rows of WIDTH floats, of which
// the first KU count (fewer where the matrix has fewer K-rows than a
// stage: its rows are padded to one). k ascending, one FFMA each; A by
// float4 loads along k that the warp broadcasts, B by float4 (float2)
// loads of consecutive columns (no bank conflict). RW rows share each B
// load: 8 for the gradient kernel, 8 or 16 for V3.
template <int WIDTH, int RW = 8, int KU = F_STAGE / WIDTH, int AC>
__device__ __forceinline__ void fprod_w(float (&acc)[RW][AC], FRing& r,
                                        const float* A, int lda, int K,
                                        int w, int l) {
  constexpr int KS = F_STAGE / WIDTH, CPL = WIDTH / 32;
  static_assert(AC >= CPL && KU <= KS && KU % 4 == 0, "fprod_w's shapes");
  const float* rows = A + RW * w * lda;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const float* B = fring_take(r) + (WIDTH >= 128 ? 4 * l : 2 * l);
#pragma unroll 2
    for (int k4 = 0; k4 < KU; k4 += 4) {
      float4 a[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        a[i] = *reinterpret_cast<const float4*>(rows + i * lda + k0 + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (WIDTH >= 128) {
          constexpr int NC = CPL / 4;
          float4 b[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            b[c] = *reinterpret_cast<const float4*>(B + (k4 + q) * WIDTH +
                                                    128 * c);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const float x = lane4(a[i], q);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[i][4 * c] = fmaf(x, b[c].x, acc[i][4 * c]);
              acc[i][4 * c + 1] = fmaf(x, b[c].y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(x, b[c].z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(x, b[c].w, acc[i][4 * c + 3]);
            }
          }
        } else {
          const float2 b =
              *reinterpret_cast<const float2*>(B + (k4 + q) * WIDTH);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const float x = lane4(a[i], q);
            acc[i][0] = fmaf(x, b.x, acc[i][0]);
            acc[i][1] = fmaf(x, b.y, acc[i][1]);
          }
        }
      }
    }
    fring_release(r);
  }
}

// fprod_w on a layer of 128 NC columns into an 8-column accumulator (the
// paper width's: kdiag_dtype.cu's V3)
template <int NC, int RW = 8>
__device__ __forceinline__ void fprod(float (&acc)[RW][8], FRing& r,
                                      const float* A, int lda, int K, int w,
                                      int l) {
  fprod_w<128 * NC, RW>(acc, r, A, lda, K, w, l);
}

}  // namespace fr
