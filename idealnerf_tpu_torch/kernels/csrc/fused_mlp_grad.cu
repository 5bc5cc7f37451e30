// Rematerialising backward of the fused point MLP for Hopper (sm_90a), with
// a plain C interface loaded through ctypes by kernels/fused_mlp_grad.py.
// Replaces idealnerf_tpu/kernels/fused_mlp_grad.py: _run_grad_kernel
// (_grad_kernel), the backward of fused_point_mlp_train: points, directions
// and the (N, 4) cotangent -> f32 gradients of every packed operand (layer
// weights, folded biases, skip pe-part, view branch, dir-PE part, packed
// heads).
//
// Both variants recompute the forward per tile of GP=64 points in the
// gradient type, then run the backward layer by layer with the rounding
// points of the TPU kernel: the cotangent is rounded before the head weight
// products, each d_h is rounded before its products, bias gradients are
// column sums of the unrounded f32 d_h, and relu' is h > 0 on the
// recomputed post-activation. Neither uses float atomics: the same inputs
// on the same card give bitwise-equal gradients.
//
// bf16 (the training default): two passes.
// - k_grad_pass_a, per tile: the recompute and the d_h chain on wmma
//   16x16x16 fragments (gemm_tc), with no weight-gradient product. It
//   writes every operand of those products for all N points: the PE tiles,
//   the rounded cotangent, every bf16 activation and every rounded d_h, each
//   64-point tile of each plane in wgmma's MN-major 128-byte-swizzled order
//   (swz), plus per tile the f32 column sums of the unrounded d_h (bias
//   gradients). Bound by its tensor-core work (the forward twice over, as
//   wmma) and by writing about 10 KB per point.
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
// What this replaces: one kernel that added every weight-gradient product
// of each tile (K = 64) into a per-block f32 slab of all gradients (2.3 MB),
// loading and storing the slab's fragments from global memory per tile.
//
// f32 (train_fused 1): k_point_mlp_grad<float>, one kernel. Each block walks
// the tiles b, b+B, ... and accumulates into its own f32 slab of every
// gradient; k_reduce_slabs sums the B slabs in block order. Products are
// f32 FMAs on the CUDA cores (wmma has no f32 fragment and TF32 would keep
// 10 mantissa bits where this variant must match f32 autograd); the
// activations of a tile go to a per-block scratch in global memory.
#include <type_traits>

#include "hopper.cuh"
#include "render_body.cuh"

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
// op(A)(i, k) = TA ? A[k * lda + i] : A[i * lda + k], and likewise for B.
// Each warp owns output blocks of FM x FN fragments.
template <bool TA, bool TB, int FM, int FN>
__device__ void gemm_tc(float* C, int ldc, bool acc, const bf16* A, int lda,
                        const bf16* B, int ldb, int M, int N, int K,
                        int warp) {
  typedef typename std::conditional<TA, wmma::col_major, wmma::row_major>::type
      LA;
  typedef typename std::conditional<TB, wmma::col_major, wmma::row_major>::type
      LB;
  const int bn = N / (16 * FN);
  const int nblk = (M / (16 * FM)) * bn;
  for (int t = warp; t < nblk; t += NWARP) {
    const int i0 = (t / bn) * 16 * FM, j0 = (t % bn) * 16 * FN;
    FragC c[FM][FN];
#pragma unroll
    for (int a = 0; a < FM; ++a)
#pragma unroll
      for (int b = 0; b < FN; ++b) {
        float* cp = C + static_cast<size_t>(i0 + 16 * a) * ldc + j0 + 16 * b;
        if (acc)
          wmma::load_matrix_sync(c[a][b], cp, ldc, wmma::mem_row_major);
        else
          wmma::fill_fragment(c[a][b], 0.f);
      }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[FM];
#pragma unroll
      for (int a = 0; a < FM; ++a) {
        const int i = i0 + 16 * a;
        const bf16* pa = TA ? A + static_cast<size_t>(k) * lda + i
                            : A + static_cast<size_t>(i) * lda + k;
        wmma::load_matrix_sync(fa[a], pa, lda);
      }
#pragma unroll
      for (int b = 0; b < FN; ++b) {
        const int j = j0 + 16 * b;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
        const bf16* pb = TB ? B + static_cast<size_t>(j) * ldb + k
                            : B + static_cast<size_t>(k) * ldb + j;
        wmma::load_matrix_sync(fb, pb, ldb);
#pragma unroll
        for (int a = 0; a < FM; ++a)
          wmma::mma_sync(c[a][b], fa[a], fb, c[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < FM; ++a)
#pragma unroll
      for (int b = 0; b < FN; ++b)
        wmma::store_matrix_sync(
            C + static_cast<size_t>(i0 + 16 * a) * ldc + j0 + 16 * b, c[a][b],
            ldc, wmma::mem_row_major);
  }
}

// The same product in f32 FMAs, 4x4 outputs per thread, k ascending.
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

// Every product of the kernel; the caller synchronises afterwards.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void gemm(float* C, int ldc, bool acc, const T* A,
                                     int lda, const T* B, int ldb, int M,
                                     int N, int K, int warp, int tid) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (M % 32 == 0 && N % 32 == 0)
      gemm_tc<TA, TB, 2, 2>(C, ldc, acc, A, lda, B, ldb, M, N, K, warp);
    else
      gemm_tc<TA, TB, 1, 1>(C, ldc, acc, A, lda, B, ldb, M, N, K, warp);
  } else {
    gemm_f32<TA, TB>(C, ldc, acc, A, lda, B, ldb, M, N, K, tid);
  }
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

struct GradASmem {
  bf16* pe;    // (GP, PE_PAD)
  bf16* ped;   // (GP, PED_PAD)
  float* g;    // (GP, 4) cotangent
  float* dh;   // (GP, W) f32 d_h; in the forward, two (GP, W) bf16
               // activation buffers
  float* dx;   // (GP, W) f32 product output / d_hv
  bf16* dc;    // (GP, W) d_h rounded
};

__host__ __device__ inline size_t grad_a_smem_layout(char* base,
                                                     GradASmem* gs) {
  const size_t sz[6] = {sizeof(bf16) * GP * PE_PAD, sizeof(bf16) * GP * PED_PAD,
                        sizeof(float) * GP * 4,     sizeof(float) * GP * W,
                        sizeof(float) * GP * W,     sizeof(bf16) * GP * W};
  size_t off[6];
  size_t total = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = total;
    total += (sz[i] + 127) & ~static_cast<size_t>(127);
  }
  if (gs != nullptr) {
    gs->pe = reinterpret_cast<bf16*>(base + off[0]);
    gs->ped = reinterpret_cast<bf16*>(base + off[1]);
    gs->g = reinterpret_cast<float*>(base + off[2]);
    gs->dh = reinterpret_cast<float*>(base + off[3]);
    gs->dx = reinterpret_cast<float*>(base + off[4]);
    gs->dc = reinterpret_cast<bf16*>(base + off[5]);
  }
  return total;
}

// img (a tile's image, F lanes) <- src (GP x width, row-major bf16), zero
// lanes past width; 16-byte chunks.
__device__ void put_tile(bf16* img, const bf16* src, int width, int F,
                         int tid) {
  const int ch = F / 8, sch = width / 8;
  for (int e = tid; e < GP * ch; e += NTHREADS) {
    const int p = e / ch, c = e - p * ch;
    const uint4 v = c < sch ? reinterpret_cast<const uint4*>(src)[p * sch + c]
                            : make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(img)[swz(p, 8 * c) >> 3] = v;
  }
}

// img (LANES) <- the cotangent rounded to bf16, zero past lane 3.
__device__ void put_cotangent(bf16* img, const float* g, int tid) {
  for (int e = tid; e < GP * (LANES / 8); e += NTHREADS) {
    const int p = e / (LANES / 8), c = e - p * (LANES / 8);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __float2bfloat16(c == 0 && k < 4 ? g[p * 4 + k] : 0.f);
    reinterpret_cast<uint4*>(img)[swz(p, 8 * c) >> 3] =
        *reinterpret_cast<const uint4*>(v);
  }
}

// dst (GP x width, bf16, shared) = relu(src + bias) rounded; the same
// 16-byte chunks also into the plane image img.
__device__ void relu_put(bf16* dst, bf16* img, const float* src,
                         const float* bias, int width, int tid) {
  const int ch = width / 8;
  for (int e = tid; e < GP * ch; e += NTHREADS) {
    const int p = e / ch, c = e - p * ch;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __float2bfloat16(
          fmaxf(src[p * width + 8 * c + k] + bias[8 * c + k], 0.f));
    const uint4 u = *reinterpret_cast<const uint4*>(v);
    reinterpret_cast<uint4*>(dst)[e] = u;
    reinterpret_cast<uint4*>(img)[swz(p, 8 * c) >> 3] = u;
  }
}

// d (GP x width, f32) *= (h > 0) with h read from its plane image (written
// by this block earlier in the tile); dc = d rounded, into shared memory
// and into the plane image dimg.
__device__ void mask_put(float* d, const bf16* himg, bf16* dc, bf16* dimg,
                         int width, int tid) {
  const int ch = width / 8;
  for (int e = tid; e < GP * ch; e += NTHREADS) {
    const int p = e / ch, c = e - p * ch;
    const int o = swz(p, 8 * c) >> 3;
    const uint4 hu = reinterpret_cast<const uint4*>(himg)[o];
    const bf16* h = reinterpret_cast<const bf16*>(&hu);
    __align__(16) bf16 r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = p * width + 8 * c + k;
      const float v = __bfloat162float(h[k]) > 0.f ? d[i] : 0.f;
      d[i] = v;
      r[k] = __float2bfloat16(v);
    }
    const uint4 u = *reinterpret_cast<const uint4*>(r);
    reinterpret_cast<uint4*>(dc)[e] = u;
    reinterpret_cast<uint4*>(dimg)[o] = u;
  }
}

// row[j] = column sums of d (GP x width), rows in order.
__device__ void colsum_put(float* row, const float* d, int width, int tid) {
  for (int j = tid; j < width; j += NTHREADS) {
    float s = 0.f;
    for (int p = 0; p < GP; ++p) s += d[p * width + j];
    row[j] = s;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
k_grad_pass_a(Net net, Planes pl, const float* __restrict__ pts,
              const float* __restrict__ dirs, const float* __restrict__ gin,
              bf16* planes, float* __restrict__ bias, int N) {
  extern __shared__ __align__(128) char smem[];
  GradASmem sm;
  grad_a_smem_layout(smem, &sm);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int D = net.depth, NV = net.n_views;
  const int NB = D * W + NV * WV + HEADS;
  bf16* hb[2] = {reinterpret_cast<bf16*>(sm.dh),
                 reinterpret_cast<bf16*>(sm.dh) + GP * W};
  const int n_tiles = (N + GP - 1) / GP;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * GP;
    const int n = min(GP, N - p0);
    auto img = [&](int plane, int width) {
      return planes + pl.off[plane] + static_cast<size_t>(tile) * GP * width;
    };
    auto himg = [&](int i) { return img(PL_H + i, W); };
    auto hvimg = [&](int v) { return img(PL_H + D + v, WV); };
    auto dcimg = [&](int i) { return img(PL_H + D + NV + i, W); };
    auto dvimg = [&](int v) { return img(PL_H + 2 * D + NV + v, WV); };
    float* brow = bias + static_cast<size_t>(tile) * NB;

    // ---- inputs; rows past N get a zero cotangent, so every d_h and
    // every product over them is zero
    for (int e = tid; e < GP * PE_PAD; e += NTHREADS) {
      const int row = e / PE_PAD, k = e - row * PE_PAD;
      float v = 0.f;
      if (row < n) {
        const float* x = pts + static_cast<size_t>(p0 + row) * 3;
        const float xx[3] = {x[0], x[1], x[2]};
        v = pe_lane(xx, k, net.multires);
      }
      sm.pe[e] = __float2bfloat16(v);
    }
    for (int e = tid; e < GP * PED_PAD; e += NTHREADS) {
      const int row = e / PED_PAD, k = e - row * PED_PAD;
      float v = 0.f;
      if (row < n) {
        const float* d = dirs + static_cast<size_t>(p0 + row) * 3;
        const float dd[3] = {d[0], d[1], d[2]};
        v = pe_lane(dd, k, net.multires_views);
      }
      sm.ped[e] = __float2bfloat16(v);
    }
    for (int e = tid; e < GP * 4; e += NTHREADS)
      sm.g[e] = e / 4 < n ? gin[static_cast<size_t>(p0) * 4 + e] : 0.f;
    __syncthreads();
    put_tile(img(PL_PE, PE_PAD), sm.pe, PE_PAD, PE_PAD, tid);
    put_tile(img(PL_PED, LANES), sm.ped, PED_PAD, LANES, tid);
    put_cotangent(img(PL_GB, LANES), sm.g, tid);

    // ---- forward recompute: activations ping-pong in shared memory and
    // are written to their planes
    gemm<bf16, false, false>(sm.dx, W, false, sm.pe, PE_PAD,
                             op<bf16>(net, SLOT_W), W, GP, W, PE_PAD, warp,
                             tid);
    __syncthreads();
    relu_put(hb[0], himg(0), sm.dx, fvec(net, SLOT_B), W, tid);
    __syncthreads();
    for (int i = 1; i < D; ++i) {
      const bool skip = net.slot[SLOT_WSKIP + i] != nullptr;
      if (skip) {
        gemm<bf16, false, false>(sm.dx, W, false, sm.pe, PE_PAD,
                                 op<bf16>(net, SLOT_WSKIP + i), W, GP, W,
                                 PE_PAD, warp, tid);
        __syncthreads();
      }
      gemm<bf16, false, false>(sm.dx, W, skip, hb[(i - 1) & 1], W,
                               op<bf16>(net, SLOT_W + i), W, GP, W, W, warp,
                               tid);
      __syncthreads();
      relu_put(hb[i & 1], himg(i), sm.dx, fvec(net, SLOT_B + i), W, tid);
      __syncthreads();
    }
    gemm<bf16, false, false>(sm.dx, WV, false, hb[(D - 1) & 1], W,
                             op<bf16>(net, SLOT_WV), WV, GP, WV, W, warp,
                             tid);
    __syncthreads();
    gemm<bf16, false, false>(sm.dx, WV, true, sm.ped, PED_PAD,
                             op<bf16>(net, SLOT_WV0D), WV, GP, WV, PED_PAD,
                             warp, tid);
    __syncthreads();
    relu_put(hb[D & 1], hvimg(0), sm.dx, fvec(net, SLOT_BV), WV, tid);
    __syncthreads();
    for (int v = 1; v < NV; ++v) {
      gemm<bf16, false, false>(sm.dx, WV, false, hb[(D + v - 1) & 1], WV,
                               op<bf16>(net, SLOT_WV + v), WV, GP, WV, WV,
                               warp, tid);
      __syncthreads();
      relu_put(hb[(D + v) & 1], hvimg(v), sm.dx, fvec(net, SLOT_BV + v), WV,
               tid);
      __syncthreads();
    }

    // ---- heads: d_h = g @ w_alpha^T, d_hv = g @ w_rgb^T with the
    // unrounded f32 g; b_heads' tile sums
    for (int c = tid; c < HEADS; c += NTHREADS) {
      float s = 0.f;
      if (c < 4)
        for (int p = 0; p < GP; ++p) s += sm.g[p * 4 + c];
      brow[D * W + NV * WV + c] = s;
    }
    {
      const bf16* wa = op<bf16>(net, SLOT_WALPHA);
      const bf16* wr = op<bf16>(net, SLOT_WRGB);
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
      mask_put(sm.dx, hvimg(v), sm.dc, dvimg(v), WV, tid);
      __syncthreads();
      colsum_put(brow + D * W + v * WV, sm.dx, WV, tid);
      __syncthreads();
      gemm<bf16, false, true>(sm.dx, WV, false, sm.dc, WV,
                              op<bf16>(net, SLOT_WV + v), WV, GP, WV, WV,
                              warp, tid);
      __syncthreads();
    }
    mask_put(sm.dx, hvimg(0), sm.dc, dvimg(0), WV, tid);
    __syncthreads();
    colsum_put(brow + D * W, sm.dx, WV, tid);
    gemm<bf16, false, true>(sm.dh, W, true, sm.dc, WV, op<bf16>(net, SLOT_WV),
                            WV, GP, W, WV, warp, tid);
    __syncthreads();

    // ---- trunk backward (d_h ping-pongs between sm.dh and sm.dx)
    float* dh = sm.dh;
    float* dn = sm.dx;
    for (int i = D - 1; i >= 1; --i) {
      mask_put(dh, himg(i), sm.dc, dcimg(i), W, tid);
      __syncthreads();
      colsum_put(brow + i * W, dh, W, tid);
      gemm<bf16, false, true>(dn, W, false, sm.dc, W,
                              op<bf16>(net, SLOT_W + i), W, GP, W, W, warp,
                              tid);
      __syncthreads();
      float* t = dh;
      dh = dn;
      dn = t;
    }
    mask_put(dh, himg(0), sm.dc, dcimg(0), W, tid);
    __syncthreads();
    colsum_put(brow, dh, W, tid);
    __syncthreads();
  }
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

unsigned long long fr_grad_pass_a_smem_bytes() {
  return fr::grad_a_smem_layout(nullptr, nullptr);
}

unsigned long long fr_grad_pass_b_smem_bytes() { return fr::B_SMEM; }

// bf16 pass A. planes: the operand buffer (plane_off, bf16 elements, as
// kernels/fused_mlp_grad.py:grad_planes); bias: (tiles, NB) f32.
int fr_grad_pass_a(const float* pts, const float* dirs, const float* g,
                   void* planes, const long long* plane_off, float* bias,
                   int n_blocks, int N, const unsigned long long* slots,
                   int depth, int n_views, int multires, int multires_views,
                   void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, 0);
  fr::Planes pl;
  const int n_planes = 3 + 2 * depth + 2 * n_views;
  for (int i = 0; i < fr::MAXPLANES; ++i)
    pl.off[i] = i < n_planes ? plane_off[i] : 0;
  const size_t bytes = fr::grad_a_smem_layout(nullptr, nullptr);
  cudaError_t err = fr::prepare(fr::k_grad_pass_a, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fr::k_grad_pass_a<<<n_blocks, fr::NTHREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, pl, pts, dirs, g, static_cast<fr::bf16*>(planes), bias, N);
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
