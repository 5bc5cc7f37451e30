// The f32 FFMA product on a weight ring, for Hopper (sm_90a): the f32
// kernels' counterpart of chain.cuh's wgmma chain, shared by the gradient
// kernel's pass A f32 (fused_mlp_grad.cu) and the f32 chain probe V3
// (kdiag_dtype.cu).
//
// A producer thread streams row-major f32 K-slabs of 16 KB (16 rows of a
// 256-wide matrix, 32 of a 128-wide one) through a ring of shared-memory
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

// acc[i][4 c + q] += sum over k < K of A[RW w + i][k] * B[k][128 c + 4 l +
// q] for the thread's RW rows (warp w) and 4 NC columns (lane l). A: a
// row-major f32 tile in shared memory (lda floats); B: the next K rows of
// the weight stream, stages of F_STAGE / (128 NC) rows of 128 NC floats.
// k ascending, one FFMA each; A by float4 loads along k that the warp
// broadcasts, B by float4 loads of consecutive columns (no bank conflict).
// RW rows share each B load: 8 for the gradient kernel, 8 or 16 for V3.
template <int NC, int RW = 8>
__device__ __forceinline__ void fprod(float (&acc)[RW][8], FRing& r,
                                      const float* A, int lda, int K, int w,
                                      int l) {
  constexpr int WIDTH = 128 * NC, KS = F_STAGE / WIDTH;
  const float* rows = A + RW * w * lda;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const float* B = fring_take(r) + 4 * l;
#pragma unroll 2
    for (int k4 = 0; k4 < KS; k4 += 4) {
      float4 a[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        a[i] = *reinterpret_cast<const float4*>(rows + i * lda + k0 + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
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
      }
    }
    fring_release(r);
  }
}

}  // namespace fr
