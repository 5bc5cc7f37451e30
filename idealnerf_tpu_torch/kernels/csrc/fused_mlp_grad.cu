// Rematerialising backward of the fused point MLP for Hopper (sm_90a), with
// a plain C interface loaded through ctypes by kernels/fused_mlp_grad.py.
//
// fr_point_mlp_grad  replaces idealnerf_tpu/kernels/fused_mlp_grad.py:
//                    _run_grad_kernel (_grad_kernel), the backward of
//                    fused_point_mlp_train: points, directions and the (N, 4)
//                    cotangent -> f32 gradients of every packed operand
//                    (layer weights, folded biases, skip pe-part, view
//                    branch, dir-PE part, packed heads).
//
// Per tile of GP=64 points a block recomputes the forward in the gradient
// type T (bf16 weights and activations with f32 accumulation, or f32
// throughout), then runs the backward layer by layer, with the rounding
// points of the TPU kernel: the cotangent is rounded to T before the head
// weight products, each d_h is rounded to T before its products, bias
// gradients are column sums of the unrounded f32 d_h, and relu' is h > 0 on
// the recomputed post-activation.
//
// What bounds it on the card: tensor-core work (about 3x the forward's
// MACs: recompute, input gradients, weight gradients) plus the weight-
// gradient read-modify-write below. Design choices:
// - Activations: the eight 256-wide trunk activations and the three view
//   activations of a tile are 304 KB in bf16 at GP=64, more than a block's
//   227 KB of shared memory. They go to a per-block scratch in global memory
//   (about 40 MB over 132 blocks in bf16, within the 50 MB L2); shared
//   memory holds the PE tiles, the cotangent, two f32 d_h buffers and the
//   rounded d_h.
// - Weight gradients: the TPU kernel adds each grid step into one VMEM
//   accumulator, which relies on sequential grid steps. Here each block owns
//   a contiguous f32 slab of every gradient (about 2.2 MB at D=8, W=256),
//   walks the tiles b, b+B, b+2B, ... in order and accumulates into its own
//   slab; a second kernel sums the B slabs element by element in block
//   order. No float atomics: the same inputs give bitwise-equal gradients.
// - Products: nvcuda::wmma bf16 16x16x16 with f32 accumulators for T=bf16
//   (transposed operands through col_major fragments); f32 FMAs on the CUDA
//   cores for T=float, since wmma has no f32 fragment and TF32 would keep 10
//   mantissa bits where the f32 variant must match f32 autograd.
#include <type_traits>

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

template <typename T>
static int launch_grad(const Net& net, const GradTable& gt, const float* pts,
                       const float* dirs, const float* g, void* act,
                       long long act_stride, float* slabs, float* out,
                       long long G, int n_blocks, int N,
                       cudaStream_t stream) {
  const size_t bytes = grad_smem_layout<T>(nullptr, nullptr);
  cudaError_t err = prepare(k_point_mlp_grad<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_point_mlp_grad<T><<<n_blocks, NTHREADS, bytes, stream>>>(
      net, gt, pts, dirs, g, static_cast<T*>(act), act_stride, slabs, G, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (G + 255) / 256;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  k_reduce_slabs<<<grid, 256, 0, stream>>>(slabs, out, G, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fr

extern "C" {

unsigned long long fr_point_mlp_grad_smem_bytes(int use_bf16) {
  return use_bf16 ? fr::grad_smem_layout<fr::bf16>(nullptr, nullptr)
                  : fr::grad_smem_layout<float>(nullptr, nullptr);
}

// slabs: (n_blocks, G) f32, zeroed by the caller; out: (G,) f32; act: the
// per-block activation scratch, act_stride elements of T per block.
int fr_point_mlp_grad(const float* pts, const float* dirs, const float* g,
                      void* act, long long act_stride, float* slabs,
                      float* out, long long G, int n_blocks, int N,
                      const unsigned long long* slots,
                      const long long* grad_offsets, int depth, int n_views,
                      int multires, int multires_views, int use_bf16,
                      void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, 0);
  fr::GradTable gt;
  for (int i = 0; i < fr::NSLOTS; ++i) gt.off[i] = grad_offsets[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return fr::launch_grad<fr::bf16>(net, gt, pts, dirs, g, act, act_stride,
                                     slabs, out, G, n_blocks, N, s);
  return fr::launch_grad<float>(net, gt, pts, dirs, g, act, act_stride, slabs,
                                out, G, n_blocks, N, s);
}

}  // extern "C"
