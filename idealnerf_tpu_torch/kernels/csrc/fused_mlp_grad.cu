// Rematerialising backward of the fused point MLP for Hopper (sm_90a), with
// a plain C interface loaded through ctypes by kernels/fused_mlp_grad.py.
// Replaces idealnerf_tpu/kernels/fused_mlp_grad.py: _run_grad_kernel
// (_grad_kernel), the backward of fused_point_mlp_train: points, directions
// and the (N, 4) cotangent -> f32 gradients of every packed operand (layer
// weights, folded biases, skip pe-part, view branch, dir-PE part, packed
// heads).
//
// Both variants recompute the forward in the gradient type, then run the
// backward layer by layer with the rounding points of the TPU kernel: d_h
// from the heads uses the unrounded f32 cotangent (g @ w_alpha^T, g @
// w_rgb^T), while the cotangent rounded to the gradient type feeds the
// heads' weight-gradient products; each d_h is rounded before its
// products; bias gradients are column sums of the unrounded f32 d_h; relu'
// is h > 0 on the recomputed, rounded post-activation. Neither uses float
// atomics: the same inputs on the same card give bitwise-equal gradients.
//
// bf16 (the training default): two passes.
// - k_grad_pass_a: the recompute and the d_h chain on the wgmma chain of
//   chain.cuh, with no weight-gradient product. One block per SM walks a
//   contiguous run of 128-point tiles (the point kernels' plan,
//   kernels/fused_mlp.py: _point_plan); its producer thread streams the
//   net's pass-A weight stream through a shared-memory ring of 4 stages
//   once per tile: K4's forward stages without the heads (chain_stages:
//   the heads' stage traded for the dir-PE stage), then the transposed
//   matrices the backward multiplies by (kernels/fused_mlp_grad.py:
//   grad_weight_stream):
//     WV_v^T          (128 x 128) for v = NV-1..1, 2 stages of 64 K-rows
//     WV_0^T h-part   (128 x 256) 4 stages of 32 K-rows
//     W_i^T           (256 x 256) for i = D-1..1, 8 stages of 32 K-rows
//   (64 stages for the paper model, 133 a tile with the forward's 69);
//   layer 0, the skip pe-part and the dir-PE part get none, as points get
//   no gradient. Each consumer warpgroup owns 64 points, one 64-point tile
//   of the planes. Forward: PointTile's PE and dir-PE tiles, then per layer
//   the product into registers and relu_store's bf16 activation in place,
//   with its relu' bits kept in shared memory. Backward: the heads' K = 4
//   products as f32 FMAs into the accumulator, which has the layout of the
//   forward's; per layer the mask, bf16 in place into the warpgroup's tile
//   (the next product's A operand), and the f32 column sums by a butterfly
//   of shuffles, then over the 4 warps in order. The K-major 64-row tile is
//   byte for byte one tile image of a plane (swz), so each finished tile
//   goes to its plane as it is: the warpgroup posts it to the three spare
//   warps of the producer warpgroup, which copy it with 16-byte streaming
//   stores (st.global.cs, evict-first in L2) while the next product runs,
//   and the warpgroup waits for them before it writes that tile again. The
//   PE tiles once a tile, every activation H(i), HV(v) and every rounded
//   d_h DC(i), DV(v); the rounded cotangent GB goes straight from
//   registers; plus per tile the f32 bias rows. Bound by writing about 10
//   KB per point (the tensor-core work, the forward twice over, is a
//   little less). Stores that L2 keeps (plain ones, or cp.async.bulk
//   shared -> global, also with an evict-first hint) pushed the weight
//   stream out of L2 and ran markedly longer on an H100 (PERF.md).
// - k_grad_pass_b: every weight gradient is X^T @ dc over the points, a
//   product with K = N. The grid is (output tile of up to 128 x 128, chunk
//   of tiles). One producer thread fills a ring of BSTAGES shared-memory
//   stages with one cp.async.bulk per operand per 64-point tile, completed
//   on mbarriers; two consumer warpgroups run wgmma m64nNk16 with both
//   operands read from the swizzled stages by descriptor, and sum their
//   chunk in registers, in order. Bound by reading the operand planes (each
//   about once from HBM, the output tiles of one gradient sharing them
//   through L2); the ring keeps 192 KB of copies in flight per SM.
// - k_bias_partials sums the per-tile bias rows of a chunk; k_reduce_slabs
//   adds the chunks' partials in chunk order.
//
// f32 (train_fused 1): k_point_mlp_grad<float>, one kernel. Each block walks
// the tiles b, b+B, ... and accumulates into its own f32 slab of every
// gradient; k_reduce_slabs sums the B slabs in block order. Products are
// f32 FMAs on the CUDA cores (TF32 would keep 10 mantissa bits where this
// variant must match f32 autograd); the activations of a tile go to a
// per-block scratch in global memory.
#include <type_traits>

#include "chain.cuh"

namespace fr {

constexpr int GP = P;  // points per backward tile

// Float offset of each operand's gradient inside a block's slab; -1 for an
// absent slot.
struct GradTable {
  long long off[NSLOTS];
};

template <typename T>
__device__ __forceinline__ T to_t(float x);
template <>
__device__ __forceinline__ bf16 to_t<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float to_t<float>(float x) {
  return x;
}
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// C (M x N, f32, row-major ldc) = [C +] op(A) (M x K) @ op(B) (K x N), where
// op(A)(i, k) = TA ? A[k * lda + i] : A[i * lda + k], and likewise for B:
// f32 FMAs, 4x4 outputs per thread, k ascending.
template <bool TA, bool TB>
__device__ void gemm_f32(float* C, int ldc, bool acc, const float* A,
                         int lda, const float* B, int ldb, int M, int N,
                         int K, int tid) {
  const int bn = N / 4;
  const int nblk = (M / 4) * bn;
  for (int t = tid; t < nblk; t += NTHREADS) {
    const int i0 = (t / bn) * 4, j0 = (t % bn) * 4;
    float c[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        c[r][s] = acc ? C[static_cast<size_t>(i0 + r) * ldc + j0 + s] : 0.f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = TA ? A[static_cast<size_t>(k) * lda + i0 + r]
                  : A[static_cast<size_t>(i0 + r) * lda + k];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        b[s] = TB ? B[static_cast<size_t>(j0 + s) * ldb + k]
                  : B[static_cast<size_t>(k) * ldb + j0 + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) c[r][s] = fmaf(a[r], b[s], c[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        C[static_cast<size_t>(i0 + r) * ldc + j0 + s] = c[r][s];
  }
}

// Every product of the f32 kernel; the caller synchronises afterwards.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void gemm(float* C, int ldc, bool acc, const T* A,
                                     int lda, const T* B, int ldb, int M,
                                     int N, int K, int warp, int tid) {
  static_assert(std::is_same<T, float>::value,
                "bf16 products run on the wgmma chain (pass A, pass B)");
  gemm_f32<TA, TB>(C, ldc, acc, A, lda, B, ldb, M, N, K, tid);
}

template <typename T>
struct GradSmem {
  T* pe;      // (GP, PE_PAD)
  T* ped;     // (GP, PED_PAD)
  T* gb;      // (GP, HEADS) cotangent rounded to T, zero past lane 3
  float* g;   // (GP, 4) cotangent
  float* dh;  // (GP, W) f32 d_h
  float* dx;  // (GP, W) f32 product output / d_hv
  T* dc;      // (GP, W) d_h rounded to T
};

template <typename T>
__host__ __device__ inline size_t grad_smem_layout(char* base,
                                                   GradSmem<T>* gs) {
  const size_t sz[7] = {sizeof(T) * GP * PE_PAD, sizeof(T) * GP * PED_PAD,
                        sizeof(T) * GP * HEADS,  sizeof(float) * GP * 4,
                        sizeof(float) * GP * W,  sizeof(float) * GP * W,
                        sizeof(T) * GP * W};
  size_t off[7];
  size_t total = 0;
  for (int i = 0; i < 7; ++i) {
    off[i] = total;
    total += (sz[i] + 127) & ~static_cast<size_t>(127);
  }
  if (gs != nullptr) {
    gs->pe = reinterpret_cast<T*>(base + off[0]);
    gs->ped = reinterpret_cast<T*>(base + off[1]);
    gs->gb = reinterpret_cast<T*>(base + off[2]);
    gs->g = reinterpret_cast<float*>(base + off[3]);
    gs->dh = reinterpret_cast<float*>(base + off[4]);
    gs->dx = reinterpret_cast<float*>(base + off[5]);
    gs->dc = reinterpret_cast<T*>(base + off[6]);
  }
  return total;
}

template <typename T>
__device__ __forceinline__ const T* op(const Net& n, int s) {
  return static_cast<const T*>(n.slot[s]);
}

// dst (GP x width, T) = relu(src + bias) rounded to T.
template <typename T>
__device__ void relu_store(T* dst, const float* src, const float* bias,
                           int width, int tid) {
  for (int e = tid; e < GP * width; e += NTHREADS)
    dst[e] = to_t<T>(fmaxf(src[e] + bias[e % width], 0.f));
}

// d (GP x width, f32) *= (h > 0) in place, and dc = d rounded to T.
template <typename T>
__device__ void mask_round(float* d, const T* h, T* dc, int width, int tid) {
  for (int e = tid; e < GP * width; e += NTHREADS) {
    const float v = to_f(h[e]) > 0.f ? d[e] : 0.f;
    d[e] = v;
    dc[e] = to_t<T>(v);
  }
}

// gb[j] += column sums of d (GP x width), rows in order.
__device__ void colsum_add(float* gb, const float* d, int width, int tid) {
  for (int j = tid; j < width; j += NTHREADS) {
    float s = 0.f;
    for (int p = 0; p < GP; ++p) s += d[p * width + j];
    gb[j] += s;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
k_point_mlp_grad(Net net, GradTable gt, const float* __restrict__ pts,
                 const float* __restrict__ dirs, const float* __restrict__ gin,
                 T* __restrict__ act, long long act_stride,
                 float* __restrict__ slabs, long long slab_stride, int N) {
  extern __shared__ __align__(128) char smem[];
  GradSmem<T> sm;
  grad_smem_layout<T>(smem, &sm);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int D = net.depth, NV = net.n_views;
  T* hs = act + blockIdx.x * act_stride;  // D x (GP, W)
  T* hv = hs + static_cast<size_t>(D) * GP * W;  // NV x (GP, WV)
  float* slab = slabs + blockIdx.x * slab_stride;
  auto grad = [&](int s) { return slab + gt.off[s]; };
  auto H = [&](int i) { return hs + static_cast<size_t>(i) * GP * W; };
  auto HV = [&](int v) { return hv + static_cast<size_t>(v) * GP * WV; };
  const int n_tiles = (N + GP - 1) / GP;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * GP;
    const int n = min(GP, N - p0);

    // ---- inputs; rows past N get a zero cotangent and contribute nothing
    for (int e = tid; e < GP * PE_PAD; e += NTHREADS) {
      const int row = e / PE_PAD, k = e - row * PE_PAD;
      float v = 0.f;
      if (row < n) {
        const float* x = pts + static_cast<size_t>(p0 + row) * 3;
        const float xx[3] = {x[0], x[1], x[2]};
        v = pe_lane(xx, k, net.multires);
      }
      sm.pe[e] = to_t<T>(v);
    }
    for (int e = tid; e < GP * PED_PAD; e += NTHREADS) {
      const int row = e / PED_PAD, k = e - row * PED_PAD;
      float v = 0.f;
      if (row < n) {
        const float* d = dirs + static_cast<size_t>(p0 + row) * 3;
        const float dd[3] = {d[0], d[1], d[2]};
        v = pe_lane(dd, k, net.multires_views);
      }
      sm.ped[e] = to_t<T>(v);
    }
    for (int e = tid; e < GP * HEADS; e += NTHREADS) {
      const int row = e / HEADS, c = e - row * HEADS;
      const float v =
          (row < n && c < 4) ? gin[static_cast<size_t>(p0 + row) * 4 + c] : 0.f;
      if (c < 4) sm.g[row * 4 + c] = v;
      sm.gb[e] = to_t<T>(v);
    }
    __syncthreads();

    // ---- forward recompute, every activation kept in the block's scratch
    gemm<T, false, false>(sm.dx, W, false, sm.pe, PE_PAD, op<T>(net, SLOT_W),
                          W, GP, W, PE_PAD, warp, tid);
    __syncthreads();
    relu_store<T>(H(0), sm.dx, fvec(net, SLOT_B), W, tid);
    __syncthreads();
    for (int i = 1; i < D; ++i) {
      const bool skip = net.slot[SLOT_WSKIP + i] != nullptr;
      if (skip) {
        gemm<T, false, false>(sm.dx, W, false, sm.pe, PE_PAD,
                              op<T>(net, SLOT_WSKIP + i), W, GP, W, PE_PAD,
                              warp, tid);
        __syncthreads();
      }
      gemm<T, false, false>(sm.dx, W, skip, H(i - 1), W,
                            op<T>(net, SLOT_W + i), W, GP, W, W, warp, tid);
      __syncthreads();
      relu_store<T>(H(i), sm.dx, fvec(net, SLOT_B + i), W, tid);
      __syncthreads();
    }
    gemm<T, false, false>(sm.dx, WV, false, H(D - 1), W, op<T>(net, SLOT_WV),
                          WV, GP, WV, W, warp, tid);
    __syncthreads();
    gemm<T, false, false>(sm.dx, WV, true, sm.ped, PED_PAD,
                          op<T>(net, SLOT_WV0D), WV, GP, WV, PED_PAD, warp,
                          tid);
    __syncthreads();
    relu_store<T>(HV(0), sm.dx, fvec(net, SLOT_BV), WV, tid);
    __syncthreads();
    for (int v = 1; v < NV; ++v) {
      gemm<T, false, false>(sm.dx, WV, false, HV(v - 1), WV,
                            op<T>(net, SLOT_WV + v), WV, GP, WV, WV, warp,
                            tid);
      __syncthreads();
      relu_store<T>(HV(v), sm.dx, fvec(net, SLOT_BV + v), WV, tid);
      __syncthreads();
    }

    // ---- heads: raw = h @ w_alpha + hv @ w_rgb + b_heads
    gemm<T, true, false>(grad(SLOT_WALPHA), HEADS, true, H(D - 1), W, sm.gb,
                         HEADS, W, HEADS, GP, warp, tid);
    gemm<T, true, false>(grad(SLOT_WRGB), HEADS, true, HV(NV - 1), WV, sm.gb,
                         HEADS, WV, HEADS, GP, warp, tid);
    for (int c = tid; c < 4; c += NTHREADS) {
      float s = 0.f;
      for (int p = 0; p < GP; ++p) s += sm.g[p * 4 + c];
      grad(SLOT_BHEADS)[c] += s;
    }
    {
      // d_h = g @ w_alpha^T, d_hv = g @ w_rgb^T with the unrounded f32 g
      const T* wa = op<T>(net, SLOT_WALPHA);
      const T* wr = op<T>(net, SLOT_WRGB);
      for (int e = tid; e < GP * W; e += NTHREADS) {
        const int p = e / W, j = e - p * W;
        float s = 0.f;
        for (int c = 0; c < 4; ++c)
          s += sm.g[p * 4 + c] * to_f(wa[j * HEADS + c]);
        sm.dh[e] = s;
      }
      for (int e = tid; e < GP * WV; e += NTHREADS) {
        const int p = e / WV, j = e - p * WV;
        float s = 0.f;
        for (int c = 0; c < 4; ++c)
          s += sm.g[p * 4 + c] * to_f(wr[j * HEADS + c]);
        sm.dx[e] = s;
      }
    }
    __syncthreads();

    // ---- view branch backward (d_hv in sm.dx, ld WV)
    for (int v = NV - 1; v >= 1; --v) {
      mask_round<T>(sm.dx, HV(v), sm.dc, WV, tid);
      __syncthreads();
      colsum_add(grad(SLOT_BV + v), sm.dx, WV, tid);
      gemm<T, true, false>(grad(SLOT_WV + v), WV, true, HV(v - 1), WV, sm.dc,
                           WV, WV, WV, GP, warp, tid);
      __syncthreads();
      gemm<T, false, true>(sm.dx, WV, false, sm.dc, WV,
                           op<T>(net, SLOT_WV + v), WV, GP, WV, WV, warp, tid);
      __syncthreads();
    }
    mask_round<T>(sm.dx, HV(0), sm.dc, WV, tid);
    __syncthreads();
    colsum_add(grad(SLOT_BV), sm.dx, WV, tid);
    gemm<T, true, false>(grad(SLOT_WV), WV, true, H(D - 1), W, sm.dc, WV, W,
                         WV, GP, warp, tid);
    gemm<T, true, false>(grad(SLOT_WV0D), WV, true, sm.ped, PED_PAD, sm.dc,
                         WV, PED_PAD, WV, GP, warp, tid);
    gemm<T, false, true>(sm.dh, W, true, sm.dc, WV, op<T>(net, SLOT_WV), WV,
                         GP, W, WV, warp, tid);
    __syncthreads();

    // ---- trunk backward (d_h ping-pongs between sm.dh and sm.dx)
    float* dh = sm.dh;
    float* dn = sm.dx;
    for (int i = D - 1; i >= 1; --i) {
      mask_round<T>(dh, H(i), sm.dc, W, tid);
      __syncthreads();
      colsum_add(grad(SLOT_B + i), dh, W, tid);
      gemm<T, true, false>(grad(SLOT_W + i), W, true, H(i - 1), W, sm.dc, W,
                           W, W, GP, warp, tid);
      if (net.slot[SLOT_WSKIP + i] != nullptr)
        gemm<T, true, false>(grad(SLOT_WSKIP + i), W, true, sm.pe, PE_PAD,
                             sm.dc, W, PE_PAD, W, GP, warp, tid);
      __syncthreads();
      gemm<T, false, true>(dn, W, false, sm.dc, W, op<T>(net, SLOT_W + i), W,
                           GP, W, W, warp, tid);
      __syncthreads();
      float* t = dh;
      dh = dn;
      dn = t;
    }
    mask_round<T>(dh, H(0), sm.dc, W, tid);
    __syncthreads();
    colsum_add(grad(SLOT_B), dh, W, tid);
    gemm<T, true, false>(grad(SLOT_W), W, true, sm.pe, PE_PAD, sm.dc, W,
                         PE_PAD, W, GP, warp, tid);
    __syncthreads();
  }
}

// out[e] = sum of the slabs' element e, in block order.
__global__ void k_reduce_slabs(const float* __restrict__ slabs,
                               float* __restrict__ out, long long G,
                               int n_slabs) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < G; e += step) {
    float s = 0.f;
    for (int b = 0; b < n_slabs; ++b) s += slabs[b * G + e];
    out[e] = s;
  }
}

static int reduce(const float* slabs, float* out, long long G, int n_slabs,
                  cudaStream_t stream) {
  const long long want = (G + 255) / 256;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  k_reduce_slabs<<<grid, 256, 0, stream>>>(slabs, out, G, n_slabs);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16, two passes
//
// The operand buffer of all N points. Plane j holds one image of GP x F_j
// bf16 per tile at off[j] + tile * GP * F_j (elements); F_j is a multiple
// of 64. Planes: PE, PED (64 lanes, zero past PED_PAD), GB (the rounded
// cotangent, 64 lanes, zero past 3), then H(i), HV(v), DC(i), DV(v).
constexpr int MAXPLANES = 3 + 2 * MAXD + 2 * MAXV;
constexpr int PL_PE = 0, PL_PED = 1, PL_GB = 2, PL_H = 3;
constexpr int LANES = 64;  // width of the PED and GB planes

struct Planes {
  long long off[MAXPLANES];
};

// ---- pass A: the recompute and the d_h chain on the wgmma chain

// Stages of pass A's backward stream per tile (after the forward's): WV_v^T
// for v = NV-1..1, WV_0^T's h-part, W_i^T for i = D-1..1.
inline int grad_back_stages(int depth, int n_views) {
  return (n_views - 1) * (WV / KC_V) + WV / KC_W + (depth - 1) * (W / KC_W);
}

// A warpgroup's tiles: PE, trunk and view (the ray kernels' WG_BYTES). The
// dir-PE tile lives in the view tile's first 8 KB until view layer 0's
// epilogue overwrites it; in the backward the trunk tile holds DC(i), the
// view tile DV(v) and the PE tile the column sums' scratch.
constexpr int A_TILES = WG_BYTES;
static_assert(PED_TILE <= HV_TILE, "the dir-PE tile shares the view tile");
constexpr int SCRATCH_HEADS = 4 * W;  // float offset of the heads' partials

// A warpgroup's relu' bits: per trunk layer 16 bytes a thread (128 values),
// per view layer 8 (64 values).
__host__ __device__ inline int mask_bytes(int depth, int n_views) {
  return 128 * (16 * depth + 8 * n_views);
}

// One epilogue's finished tiles, which a consumer warpgroup hands to the
// store warps (at most two: PE and dir-PE).
struct Mail {
  bf16* dst[2];
  const bf16* src[2];
  uint32_t bytes[2];
  int n;
};

// Pass A's shared memory: 1,024 bytes to align the base, the ring of
// n_ring stages, two warpgroups' tiles and relu' bits, 128 bytes of the
// ring's mbarriers, then each warpgroup's mailbox full / empty mbarriers
// and its Mail.
constexpr int MAIL_BYTES = 2 * 2 * 8 + 2 * sizeof(Mail);
__host__ __device__ inline size_t pass_a_smem_bytes(int n_ring, int depth,
                                                    int n_views) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES +
         2 * static_cast<size_t>(A_TILES + mask_bytes(depth, n_views)) + 128 +
         MAIL_BYTES;
}

// Every product of pass A starts its accumulator over (scale-d 0), so an
// epilogue zeroes the registers it has read: the compiler then need not
// keep the 128 of them live beside the epilogue's own.
__device__ __forceinline__ void clear(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
}

// One step of the column sums' butterfly: of s[0:2 HALF], this lane keeps
// one half (by its lane_bit) in s[0:HALF] and adds the partner lane's sums
// of those columns. (Trip counts are template arguments, so that every
// index is known at compile time and s stays in registers.)
template <int M, int HALF>
__device__ __forceinline__ void fold(float (&s)[M], int l, int lane_bit) {
  const bool up = (l & lane_bit) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? s[k] : s[k + HALF];
    const float keep = up ? s[k + HALF] : s[k];
    s[k] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, lane_bit);
  }
}

// The backward's epilogue of a layer of 2 NR columns, in relu_store's
// fragment order: d = acc masked by the relu' bits m (bit i % 32 of m[i /
// 32] for acc[i]); tile = bf16(d) in place; part[warp][col] = the warp's
// column sums of the unrounded d: each thread's two rows, then the 8 lanes
// of a column by a butterfly of shuffles that leaves each lane NR / 16 of
// the sums. acc ends zeroed (clear).
template <int NR>
__device__ __forceinline__ void grad_store(float (&acc)[128], bf16* tile,
                                           const uint32_t (&m)[NR / 32],
                                           float* part, int wtid) {
  const int l = wtid & 31, w = wtid >> 5;
  const int r0 = 16 * w + (l >> 2);
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const uint32_t bits = m[i >> 5] >> (i & 31);
    acc[i] = bits & 1u ? acc[i] : 0.f;
    acc[i + 1] = bits & 2u ? acc[i + 1] : 0.f;
    const int hi = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (l & 3);
    *reinterpret_cast<__nv_bfloat162*>(tile + swz(r0 + 8 * hi, col)) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  // s[k]: column 8 (k / 2) + 2 (l % 4) + k % 2, rows lo + hi
  constexpr int M = NR / 2;
  float s[M];
#pragma unroll
  for (int k = 0; k < M; ++k)
    s[k] = acc[4 * (k >> 1) + (k & 1)] + acc[4 * (k >> 1) + 2 + (k & 1)];
  clear(acc);
  // lanes l ^ 16, l ^ 8, l ^ 4 hold the same columns of other rows
  fold<M, M / 2>(s, l, 16);
  fold<M, M / 4>(s, l, 8);
  fold<M, M / 8>(s, l, 4);
  const int kb = ((l & 16) ? M / 2 : 0) + ((l & 8) ? M / 4 : 0) +
                 ((l & 4) ? M / 8 : 0);
  float* pw = part + w * 2 * NR;
#pragma unroll
  for (int f = 0; f < M / 8; f += 2) {
    const int col = 8 * ((kb + f) >> 1) + 2 * (l & 3);
    *reinterpret_cast<float2*>(pw + col) = make_float2(s[f], s[f + 1]);
  }
}

// row[c] = the warpgroup's column sums of part, warps in order.
template <int NR>
__device__ __forceinline__ void bias_row(const float* part, float* row,
                                         int wtid) {
#pragma unroll
  for (int c = wtid; c < 2 * NR; c += 128)
    row[c] = ((part[c] + part[2 * NR + c]) + part[4 * NR + c]) +
             part[6 * NR + c];
}

// acc[0:NR] (+)= g @ w[:, 0:4]^T at the thread's rows and columns: g is
// the (n_pts, 4) f32 cotangent from row row0 of the warpgroup's tile (zero
// at rows past n_pts), w is (2 NR, HEADS) bf16, of which the first 4 lanes
// count. The cotangent is loaded here, not held across the products.
template <int NR, bool ADD>
__device__ __forceinline__ void heads_fma(float (&acc)[128],
                                          const float* __restrict__ gin,
                                          int row0, int n_pts,
                                          const bf16* __restrict__ w,
                                          int wtid) {
  const int l = wtid & 31;
  float g[2][4];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int p = row0 + 16 * (wtid >> 5) + (l >> 2) + 8 * hi;
    const float4 v = p < n_pts
                         ? __ldg(reinterpret_cast<const float4*>(gin) + p)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    g[hi][0] = v.x;
    g[hi][1] = v.y;
    g[hi][2] = v.z;
    g[hi][3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < NR; i += 4)
#pragma unroll
    for (int b0 = 0; b0 < 2; ++b0) {
      const int col = 2 * i + 2 * (l & 3) + b0;
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(w + col * HEADS));
      const float2 w01 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 w23 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float d = g[hi][0] * w01.x;
        d = fmaf(g[hi][1], w01.y, d);
        d = fmaf(g[hi][2], w23.x, d);
        d = fmaf(g[hi][3], w23.y, d);
        float& a = acc[i + 2 * hi + b0];
        a = ADD ? a + d : d;
      }
    }
}

// Pass A for warpgroup wg on one 128-point tile (rows 64 wg .. +64 at
// tile_base of the block's n_pts points; the block's first 64-point tile of
// the planes is pt0): the forward, then d_h back through the heads, the
// view branch and the trunk. Each epilogue's finished tiles go to the store
// warps through the warpgroup's Mail (put, then post: one post per
// epilogue, posts counts them), and the warpgroup waits for the last post's
// stores before it writes a tile again (reuse). A warpgroup past N computes
// on zeros and posts nothing to store; rows past N have a zero cotangent,
// so every d_h of theirs is zero.
__device__ __forceinline__ void pass_a_tile(
    const Net& net, const Planes& pl, const PointTile<false>& src,
    const float* __restrict__ gin, bf16* planes, float* bias, Ring& r,
    char* tiles, Mail& mail, uint32_t mail_full, uint32_t mail_empty,
    uint32_t& posts, int tile_base, int n_pts, int pt0, int wg, int wtid) {
  const int D = net.depth, NV = net.n_views;
  const int bar = 1 + wg;
  const int row0 = tile_base + 64 * wg;
  const int pt = pt0 + row0 / GP;
  const bool live = row0 < n_pts;
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  bf16* h_g = pe_g + PE_TILE / 2;
  bf16* hv_g = h_g + H_TILE / 2;
  bf16* ped_g = hv_g;
  const uint32_t pe = smem_addr(tiles), h = pe + PE_TILE, hv = h + H_TILE;
  const uint32_t ped = hv;
  char* masks = tiles + A_TILES;
  float* part = reinterpret_cast<float*>(tiles);
  float* brow = bias + static_cast<size_t>(pt) * (D * W + NV * WV + HEADS);

  int n_put = 0;
  auto put = [&](const bf16* from, int plane, int width) {
    if (live && wtid == 0) {
      mail.dst[n_put] =
          planes + pl.off[plane] + static_cast<size_t>(pt) * GP * width;
      mail.src[n_put] = from;
      mail.bytes[n_put] = 2 * GP * width;
      ++n_put;
    }
  };
  auto post = [&]() {  // the puts since the last post, to the store warps
    if (wtid == 0) {
      mail.n = n_put;
      mbar_arrive(mail_full);
    }
    n_put = 0;
    ++posts;
  };
  auto reuse = [&]() {  // every warp's reads and the last post's are done
    if (wtid == 0 && posts > 0) mbar_wait(mail_empty, (posts - 1) & 1);
    named_barrier(bar, 128);
  };
  auto ready = [&]() {  // the tile is written, for wgmma and the stores
    fence_proxy_async();
    named_barrier(bar, 128);
  };

  float acc[128];
  clear(acc);

  // ---- forward, K4's chain without the heads; relu' bits kept
  reuse();
  src.fill(net, pe_g, ped_g, row0, n_pts, wtid);
  ready();
  put(pe_g, PL_PE, PE_PAD);
  put(ped_g, PL_PED, LANES);
  post();
  for (int i = 0; i < D; ++i) {
    if (i == 0) {
      prod_w(acc, r, pe, PE_PAD, true);
    } else {
      const bool skip = net.slot[SLOT_WSKIP + i] != nullptr;
      if (skip) prod_w(acc, r, pe, PE_PAD, true);
      prod_w(acc, r, h, W, !skip);
    }
    ring_drain(r);
    reuse();
    uint32_t m[4] = {0u, 0u, 0u, 0u};
    const float* b = fvec(net, SLOT_B + i);
    relu_store<128, true>(acc, h_g, b, b, wtid, m);
    clear(acc);
    reinterpret_cast<uint4*>(masks + 2048 * i)[wtid] =
        make_uint4(m[0], m[1], m[2], m[3]);
    ready();
    put(h_g, PL_H + i, W);
    post();
  }
  for (int v = 0; v < NV; ++v) {
    prod_v(acc, r, v == 0 ? h : hv, v == 0 ? W : WV, true);
    if (v == 0) prod_v(acc, r, ped, KC_V, false);
    ring_drain(r);
    reuse();
    uint32_t m[2] = {0u, 0u};
    const float* b = fvec(net, SLOT_BV + v);
    relu_store<64, true>(acc, hv_g, b, b, wtid, m);
    clear(acc);
    reinterpret_cast<uint2*>(masks + 2048 * D + 1024 * v)[wtid] =
        make_uint2(m[0], m[1]);
    ready();
    put(hv_g, PL_H + D + v, WV);
    post();
  }

  // ---- backward. The cotangent at row wtid % 64 for the GB tile and the
  // heads' bias sums (threads < 64).
  const int grow = wtid & 63, c0 = wtid >> 6;
  float4 gr = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 == 0 && row0 + grow < n_pts)
    gr = __ldg(reinterpret_cast<const float4*>(gin) + row0 + grow);

  if (live) {  // GB, straight to its plane: the rounded cotangent, zero past
              // lane 3
    const __nv_bfloat162 lo = __floats2bfloat162_rn(gr.x, gr.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(gr.z, gr.w);
    const uint4 first = make_uint4(*reinterpret_cast<const uint32_t*>(&lo),
                                   *reinterpret_cast<const uint32_t*>(&hi),
                                   0u, 0u);
    bf16* gb = planes + pl.off[PL_GB] + static_cast<size_t>(pt) * GP * LANES;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 2 * j;
      __stcs(reinterpret_cast<uint4*>(gb + swz(grow, 8 * c)),
             c == 0 ? first : make_uint4(0u, 0u, 0u, 0u));
    }
  }
  reuse();
  if (c0 == 0) {  // b_heads: the column sums of the f32 cotangent
    float4 s = gr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_xor_sync(0xFFFFFFFFu, s.x, o);
      s.y += __shfl_xor_sync(0xFFFFFFFFu, s.y, o);
      s.z += __shfl_xor_sync(0xFFFFFFFFu, s.z, o);
      s.w += __shfl_xor_sync(0xFFFFFFFFu, s.w, o);
    }
    if ((wtid & 31) == 0)
      reinterpret_cast<float4*>(part + SCRATCH_HEADS)[wtid >> 5] = s;
  }
  // d_hv of the last view layer = g @ w_rgb^T
  heads_fma<64, false>(acc, gin, row0, n_pts, wmat(net, SLOT_WRGB), wtid);
  {
    const uint2 u = reinterpret_cast<const uint2*>(
        masks + 2048 * D + 1024 * (NV - 1))[wtid];
    const uint32_t m[2] = {u.x, u.y};
    grad_store<64>(acc, hv_g, m, part, wtid);
  }
  ready();
  put(hv_g, PL_H + 2 * D + NV + NV - 1, WV);
  post();
  if (live) {
    bias_row<64>(part, brow + D * W + (NV - 1) * WV, wtid);
    if (wtid < HEADS) {
      const float* ph = part + SCRATCH_HEADS;
      brow[D * W + NV * WV + wtid] = wtid < 4 ? ph[wtid] + ph[4 + wtid] : 0.f;
    }
  }
  for (int v = NV - 1; v >= 1; --v) {  // d_hv(v - 1) = dv(v) @ WV_v^T
    prod_v(acc, r, hv, WV, true);
    ring_drain(r);
    reuse();
    const uint2 u = reinterpret_cast<const uint2*>(
        masks + 2048 * D + 1024 * (v - 1))[wtid];
    const uint32_t m[2] = {u.x, u.y};
    grad_store<64>(acc, hv_g, m, part, wtid);
    ready();
    put(hv_g, PL_H + 2 * D + NV + v - 1, WV);
    post();
    if (live) bias_row<64>(part, brow + D * W + (v - 1) * WV, wtid);
  }
  // d_h of the last trunk layer = dv(0) @ WV_0^T + g @ w_alpha^T
  prod_w(acc, r, hv, WV, true);
  ring_drain(r);
  heads_fma<128, true>(acc, gin, row0, n_pts, wmat(net, SLOT_WALPHA),
                       wtid);
  for (int i = D - 1; i >= 0; --i) {  // d_h(i - 1) = dc(i) @ W_i^T
    reuse();
    const uint4 u = reinterpret_cast<const uint4*>(masks + 2048 * i)[wtid];
    const uint32_t m[4] = {u.x, u.y, u.z, u.w};
    grad_store<128>(acc, h_g, m, part, wtid);
    ready();
    put(h_g, PL_H + D + NV + i, W);
    post();
    if (live) bias_row<128>(part, brow + i * W, wtid);
    if (i > 0) {
      prod_w(acc, r, h, W, true);
      ring_drain(r);
    }
  }
}

// Pass A's block: the chain's two consumer warpgroups and a whole producer
// warpgroup, so that registers can move between them (setmaxnreg acts on
// whole warpgroups): the producer keeps A_PRODUCER_REGS a thread and each
// consumer thread A_CONSUMER_REGS, where the launch gives every thread
// 65,536 / 384 rounded down (168). The producer's thread 256 streams; the
// rest of its warpgroup waits at the end.
constexpr int A_THREADS = 384;
constexpr int STORE_WARPS = 3;  // the producer warpgroup's warps 9..11
constexpr int A_PRODUCER_REGS = 40, A_CONSUMER_REGS = 232;
static_assert(2 * 128 * A_CONSUMER_REGS + 128 * A_PRODUCER_REGS <= 65536,
              "pass A's registers exceed the SM's");

__global__ void __launch_bounds__(A_THREADS, 1)
k_grad_pass_a(Net net, const __grid_constant__ Planes pl,
              const bf16* __restrict__ wstream, int n_stages,
              const float* __restrict__ pts, const float* __restrict__ dirs,
              const float* __restrict__ gin, bf16* __restrict__ planes,
              float* __restrict__ bias, int N, int tiles_per_block,
              int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const int wg_bytes = A_TILES + mask_bytes(net.depth, net.n_views);
  const Chain c = chain_begin(smem_raw, n_ring, wg_bytes);
  const int p0 = blockIdx.x * tiles_per_block * DT;
  const int n_pts = min(tiles_per_block * DT, N - p0);
  const int wg = threadIdx.x >> 7;
  // per warpgroup: mailbox full (one arrival) and empty (one per store warp)
  const uint32_t mbars = c.bars + 16 * MAX_RING;
  Mail* mail = reinterpret_cast<Mail*>(c.gbase + (mbars - c.base) + 32);
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(mbars + 8 * w, 1);
      mbar_init(mbars + 16 + 8 * w, STORE_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (n_pts + DT - 1) / DT;
  if (wg == 2) {
    setmaxnreg_dec<A_PRODUCER_REGS>();
    if (threadIdx.x < 288) {
      chain_produce(c, wstream, n_stages, n_tiles);
    } else {  // the store warps: each post of each warpgroup, in order
      const int t = threadIdx.x - 288;
      const int posts = n_tiles * (2 * net.depth + 2 * net.n_views + 1);
      for (int e = 0; e < posts; ++e)
        for (int w = 0; w < 2; ++w) {
          mbar_wait(mbars + 8 * w, e & 1);
          const Mail& m = mail[w];
          for (int j = 0; j < m.n; ++j) {
            const uint4* from = reinterpret_cast<const uint4*>(m.src[j]);
            uint4* to = reinterpret_cast<uint4*>(m.dst[j]);
            const int n16 = static_cast<int>(m.bytes[j] / 16);
#pragma unroll 4
            for (int i = t; i < n16; i += 32 * STORE_WARPS)
              __stcs(to + i, from[i]);
          }
          __syncwarp();
          if ((threadIdx.x & 31) == 0) mbar_arrive(mbars + 16 + 8 * w);
        }
    }
  } else {
    setmaxnreg_inc<A_CONSUMER_REGS>();
    const int wtid = threadIdx.x & 127;
    const PointTile<false> src{pts + static_cast<size_t>(p0) * 3,
                               dirs + static_cast<size_t>(p0) * 3, nullptr};
    Ring ring{c.base, c.bars, static_cast<uint32_t>(n_ring), 0, NO_STAGE};
    char* tiles = c.gbase + n_ring * STAGE_BYTES + wg * wg_bytes;
    uint32_t posts = 0;
    for (int t0 = 0; t0 < n_pts; t0 += DT)
      pass_a_tile(net, pl, src, gin + static_cast<size_t>(p0) * 4, planes,
                  bias, ring, tiles, mail[wg], mbars + 8 * wg,
                  mbars + 16 + 8 * wg, posts, t0, n_pts, p0 / GP, wg, wtid);
  }
  __syncthreads();
}

// ---- pass B: long-K weight-gradient products on wgmma

constexpr int BSTAGES = 6;
constexpr int BSTAGE_BYTES = 2 * 2 * 64 * GP * 2;  // X and Y, 128 lanes each
constexpr int B_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int MAXTASKS = 160;
constexpr size_t B_SMEM = 1024 + BSTAGES * BSTAGE_BYTES + 2 * BSTAGES * 8;

// One output tile of one gradient dW = X^T @ Y (rows x cols at float
// offset off): X from plane xp (xw x 64 lanes), Y from plane yp; rows
// 64*mb .. 64*(mb+mw), columns 64*nb .. 64*(nb+nw).
struct BTask {
  unsigned char xp, yp, xw, yw, mb, nb, mw, nw;
  unsigned short rows, cols;
  int off;
};

struct BTable {
  long long plane[MAXPLANES];
  BTask task[MAXTASKS];
};


__global__ void __launch_bounds__(B_THREADS, 1)
k_grad_pass_b(const __grid_constant__ BTable tb,
              const bf16* __restrict__ planes, float* __restrict__ partials,
              long long G, int n_tiles, int n_chunks) {
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + BSTAGES * BSTAGE_BYTES;
  const BTask t = tb.task[blockIdx.x];
  const int chunk = blockIdx.y;
  const int t0 = static_cast<int>(static_cast<long long>(chunk) * n_tiles /
                                  n_chunks);
  const int t1 = static_cast<int>(static_cast<long long>(chunk + 1) *
                                  n_tiles / n_chunks);
  const int nk = t1 - t0;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (BSTAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * t.mw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // producer: one thread keeps BSTAGES tiles in flight
    if (threadIdx.x == 256) {
      const uint32_t xb = 8192u * t.mw, yb = 8192u * t.nw;
      const size_t sx = static_cast<size_t>(GP) * 64 * t.xw;
      const size_t sy = static_cast<size_t>(GP) * 64 * t.yw;
      const bf16* gx = planes + tb.plane[t.xp] + t0 * sx + 4096 * t.mb;
      const bf16* gy = planes + tb.plane[t.yp] + t0 * sy + 4096 * t.nb;
      for (int k = 0; k < nk; ++k) {
        const int s = k % BSTAGES;
        if (k >= BSTAGES) mbar_wait(empty(s), ((k / BSTAGES) - 1) & 1);
        mbar_expect_tx(full(s), xb + yb);
        const uint32_t st = base + s * BSTAGE_BYTES;
        bulk_g2s(st, gx + k * sx, xb, full(s));
        bulk_g2s(st + BSTAGE_BYTES / 2, gy + k * sy, yb, full(s));
      }
      // stay until the consumers have drained every copy
      for (int k = max(0, nk - BSTAGES); k < nk; ++k)
        mbar_wait(empty(k % BSTAGES), (k / BSTAGES) & 1);
    }
    return;
  }
  if (wg >= t.mw) return;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % BSTAGES;
    mbar_wait(full(s), (k / BSTAGES) & 1);
    const uint32_t xa = base + s * BSTAGE_BYTES + 8192 * wg;
    const uint32_t ya = base + s * BSTAGE_BYTES + BSTAGE_BYTES / 2;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < GP / 16; ++j) {  // 16 points = two 1,024-byte groups
      const uint64_t da = desc_mn(xa + 2048 * j, 8192);
      const uint64_t db = desc_mn(ya + 2048 * j, 8192);
      if (t.nw == 2)
        wgmma_n128(acc, da, db);
      else
        wgmma_n64(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty(s));
  }

  // accumulator (row, col) of thread l of warp w: rows w*16 + l/4 (+8),
  // columns 8*(i/4) + 2*(l%4) + (i&1)
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r0 = 64 * (t.mb + wg) + 16 * w + lane / 4;
  const int c0 = 64 * t.nb + 2 * (lane & 3);
  float* out = partials + chunk * G + t.off;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 32 * t.nw) break;
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = c0 + 8 * (i >> 2) + (i & 1);
    if (row < t.rows && col < t.cols)
      out[static_cast<size_t>(row) * t.cols + col] = acc[i];
  }
}

// partials[chunk][bias e] = sum of the chunk's per-tile bias rows, in
// tile order; e runs over b[0..D), bv[0..V), b_heads as in pass A's rows.
__global__ void k_bias_partials(const float* __restrict__ bias, int NB,
                                int n_tiles, int n_chunks, GradTable gt,
                                int D, int NV, float* __restrict__ partials,
                                long long G) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (e >= NB) return;
  const int t0 = static_cast<int>(static_cast<long long>(chunk) * n_tiles /
                                  n_chunks);
  const int t1 = static_cast<int>(static_cast<long long>(chunk + 1) *
                                  n_tiles / n_chunks);
  float s = 0.f;
  for (int t = t0; t < t1; ++t) s += bias[static_cast<size_t>(t) * NB + e];
  long long dst;
  if (e < D * W) {
    dst = gt.off[SLOT_B + e / W] + e % W;
  } else if (e < D * W + NV * WV) {
    const int v = (e - D * W) / WV;
    dst = gt.off[SLOT_BV + v] + (e - D * W - v * WV);
  } else {
    dst = gt.off[SLOT_BHEADS] + (e - D * W - NV * WV);
  }
  partials[chunk * G + dst] = s;
}

// The tiles of gradient dW = X^T @ Y (rows x cols at float offset off).
static bool add_tasks(BTask* task, int* n, int xp, int xw, int yp, int yw,
                      int rows, int cols, long long off) {
  for (int mb = 0; mb < xw; mb += 2)
    for (int nb = 0; nb < yw; nb += 2) {
      if (*n >= MAXTASKS || off < 0) return false;
      BTask& t = task[(*n)++];
      t.xp = static_cast<unsigned char>(xp);
      t.yp = static_cast<unsigned char>(yp);
      t.xw = static_cast<unsigned char>(xw);
      t.yw = static_cast<unsigned char>(yw);
      t.mb = static_cast<unsigned char>(mb);
      t.nb = static_cast<unsigned char>(nb);
      t.mw = static_cast<unsigned char>(xw - mb < 2 ? xw - mb : 2);
      t.nw = static_cast<unsigned char>(yw - nb < 2 ? yw - nb : 2);
      t.rows = static_cast<unsigned short>(rows);
      t.cols = static_cast<unsigned short>(cols);
      t.off = static_cast<int>(off);
    }
  return true;
}

static int launch_grad_f32(const Net& net, const GradTable& gt,
                           const float* pts, const float* dirs,
                           const float* g, void* act, long long act_stride,
                           float* slabs, float* out, long long G,
                           int n_blocks, int N, cudaStream_t stream) {
  const size_t bytes = grad_smem_layout<float>(nullptr, nullptr);
  cudaError_t err = prepare(k_point_mlp_grad<float>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_point_mlp_grad<float><<<n_blocks, NTHREADS, bytes, stream>>>(
      net, gt, pts, dirs, g, static_cast<float*>(act), act_stride, slabs, G,
      N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(slabs, out, G, n_blocks, stream);
}

}  // namespace fr

extern "C" {

unsigned long long fr_point_mlp_grad_smem_bytes() {
  return fr::grad_smem_layout<float>(nullptr, nullptr);
}

// The f32 variant. slabs: (n_blocks, G) f32, zeroed by the caller; out:
// (G,) f32; act: the per-block activation scratch, act_stride floats per
// block.
int fr_point_mlp_grad(const float* pts, const float* dirs, const float* g,
                      void* act, long long act_stride, float* slabs,
                      float* out, long long G, int n_blocks, int N,
                      const unsigned long long* slots,
                      const long long* grad_offsets, int depth, int n_views,
                      int multires, int multires_views, void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, 0);
  fr::GradTable gt;
  for (int i = 0; i < fr::NSLOTS; ++i) gt.off[i] = grad_offsets[i];
  return fr::launch_grad_f32(net, gt, pts, dirs, g, act, act_stride, slabs,
                             out, G, n_blocks, N,
                             static_cast<cudaStream_t>(stream));
}

unsigned long long fr_grad_pass_a_smem_bytes(int n_ring, int depth,
                                             int n_views) {
  return fr::pass_a_smem_bytes(n_ring, depth, n_views);
}

unsigned long long fr_grad_pass_b_smem_bytes() { return fr::B_SMEM; }

// bf16 pass A. planes: the operand buffer (plane_off, bf16 elements, as
// kernels/fused_mlp_grad.py:grad_planes); bias: (tiles of 64 points, NB)
// f32; wstream: n_stages stages of the net's pass-A weight stream (16-byte
// aligned); blocks of tiles_per_block 128-point tiles; n_ring: stages of the
// shared-memory ring (2..MAX_RING).
int fr_grad_pass_a(const float* pts, const float* dirs, const float* g,
                   void* planes, const long long* plane_off, float* bias,
                   int N, int tiles_per_block, const unsigned long long* slots,
                   int depth, int n_views, int multires, int multires_views,
                   const void* wstream, int n_stages, int n_ring,
                   void* stream) {
  using namespace fr;
  if (tiles_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = pass_a_smem_bytes(n_ring, depth, n_views);
  // the forward trades the heads' stage for the dir-PE stage
  cudaError_t err = chain_prepare(
      k_grad_pass_a, bytes,
      chain_stages(slots, depth, n_views) + grad_back_stages(depth, n_views),
      n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net = make_net(slots, depth, n_views, multires, multires_views, 0);
  Planes pl;
  const int n_planes = 3 + 2 * depth + 2 * n_views;
  for (int i = 0; i < MAXPLANES; ++i)
    pl.off[i] = i < n_planes ? plane_off[i] : 0;
  const int tiles = (N + DT - 1) / DT;
  const int grid = (tiles + tiles_per_block - 1) / tiles_per_block;
  k_grad_pass_a<<<grid, A_THREADS, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      net, pl, static_cast<const bf16*>(wstream), n_stages, pts, dirs, g,
      static_cast<bf16*>(planes), bias, N, tiles_per_block, n_ring);
  return static_cast<int>(cudaGetLastError());
}

// bf16 pass B: partials (n_chunks, G) f32 (every gradient's region is
// written), out (G,) f32 = the partials summed in chunk order.
int fr_grad_pass_b(const void* planes, const long long* plane_off,
                   const float* bias, int NB, float* partials, float* out,
                   long long G, int n_tiles, int n_chunks,
                   const long long* grad_offsets, int depth, int n_views,
                   void* stream) {
  using namespace fr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = depth, NV = n_views;
  BTable tb;
  const int n_planes = 3 + 2 * D + 2 * NV;
  for (int i = 0; i < MAXPLANES; ++i)
    tb.plane[i] = i < n_planes ? plane_off[i] : 0;
  const int H = PL_H, HV = PL_H + D, DC = PL_H + D + NV, DV = DC + D;
  const int w = W / 64, wv = WV / 64, pe = PE_PAD / 64, ln = LANES / 64;
  const long long* go = grad_offsets;
  int n = 0;
  bool ok = add_tasks(tb.task, &n, PL_PE, pe, DC, w, PE_PAD, W, go[SLOT_W]);
  for (int i = 1; i < D; ++i) {
    ok = ok && add_tasks(tb.task, &n, H + i - 1, w, DC + i, w, W, W,
                         go[SLOT_W + i]);
    if (go[SLOT_WSKIP + i] >= 0)
      ok = ok && add_tasks(tb.task, &n, PL_PE, pe, DC + i, w, PE_PAD, W,
                           go[SLOT_WSKIP + i]);
  }
  ok = ok && add_tasks(tb.task, &n, H + D - 1, w, DV, wv, W, WV, go[SLOT_WV]);
  ok = ok && add_tasks(tb.task, &n, PL_PED, ln, DV, wv, PED_PAD, WV,
                       go[SLOT_WV0D]);
  for (int v = 1; v < NV; ++v)
    ok = ok && add_tasks(tb.task, &n, HV + v - 1, wv, DV + v, wv, WV, WV,
                         go[SLOT_WV + v]);
  ok = ok && add_tasks(tb.task, &n, H + D - 1, w, PL_GB, ln, W, HEADS,
                       go[SLOT_WALPHA]);
  ok = ok && add_tasks(tb.task, &n, HV + NV - 1, wv, PL_GB, ln, WV, HEADS,
                       go[SLOT_WRGB]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = prepare(k_grad_pass_b, B_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_grad_pass_b<<<dim3(n, n_chunks), B_THREADS, B_SMEM, s>>>(
      tb, static_cast<const bf16*>(planes), partials, G, n_tiles, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GradTable gt;
  for (int i = 0; i < NSLOTS; ++i) gt.off[i] = grad_offsets[i];
  k_bias_partials<<<dim3((NB + 255) / 256, n_chunks), 256, 0, s>>>(
      bias, NB, n_tiles, n_chunks, gt, D, NV, partials, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(partials, out, G, n_chunks, s);
}

}  // extern "C"
