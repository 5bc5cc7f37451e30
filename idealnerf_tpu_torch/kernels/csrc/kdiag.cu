// Kernel-diagnosis probes for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by kernels/kdiag.py. They take the fused MLP's time
// apart on the card, as the TPU probes under scripts/ took it apart there:
//
// kd_chain     replaces scripts/kdiag.py (k_plain, k_relu, k_relu2 at :70),
//              scripts/kdiag4.py (chain_kernel at :90) and scripts/kdiag5.py
//              (chain_kernel at :114): `depth` chained (ROWS, 256) @ (256,
//              256) products with one epilogue between layers. bf16 with
//              f32 accumulation (cast only, relu, bias + relu, compare +
//              select, cast then max, two independent half-tile chains,
//              and products only: every layer into one accumulator, the
//              port's own bisection of the epilogue from the products),
//              f32 on the CUDA cores (relu), int8 with s32 accumulation
//              (relu + f32 scale + round/clip, or relu + shift).
// kd_ladder    replaces scripts/kdiag2.py (:114, rungs v0-v2): the
//              production trunk without the skip's pe-part, then with it,
//              then with the view branch, on the production operand table.
//              Rungs v3 and v4 are the production kernels K5 and K4
//              (fused_mlp.cu), which kernels/kdiag.py launches for them.
// kd_render_a  replaces scripts/kdiag3.py (kernel_A, :269): the ray-organised
//              MLP from a given (R*S, 64) bf16 xyz-PE and a per-ray (R, 32)
//              dir-PE -> raw (R, S*4), no compositing.
// kd_render_b  replaces scripts/kdiag3.py (kernel_B, :291): the same with
//              the PE built in the kernel from ray packets and depths, as
//              the production fine pass builds it. kdiag3's kernel_C
//              (:315) is the production fine pass itself (fr_render_rays).
//
// What bounds them on the card: tensor-core work (f32: the CUDA cores). A
// chain row costs 8 x 65,536 MACs against 512-1,536 bytes in and out. Each
// probe is built from the production inner loop (render_body.cuh): a
// block of 8 warps owns a tile of rows whose activations ping-pong between
// two shared-memory buffers; weights are read per layer from global memory
// (L2-resident) as wmma fragments; each accumulator fragment goes through a
// per-warp f32 scratch for the epilogue. So a probe's time against the
// production kernels' says which part of them costs what.
#include "render_body.cuh"

namespace fr {
namespace kd {

enum Mode {
  M_CAST = 0,       // bf16(acc)                        kdiag k_plain, kdiag4 V2
  M_RELU = 1,       // bf16(max(acc, 0))                kdiag4 V0, kdiag5 B0
  M_BIAS_RELU = 2,  // bf16(max(acc + b, 0))            kdiag k_relu, kdiag4 V6
  M_SELECT = 3,     // bf16(acc > 0 ? acc : 0)          kdiag4 V5
  M_CAST_MAX = 4,   // max(bf16(acc), 0) in bf16        kdiag4 V7
  M_RELU2 = 5,      // M_BIAS_RELU, two chains a block  kdiag k_relu2
  M_I0 = 6,         // int8(clip(f32(max(acc, 0)) * s + 0.5, 0, 127))  kdiag5 I0
  M_I1 = 7,         // int8(min(max(acc, 0) >> 6, 127))                kdiag5 I1
  M_SUM = 8,        // bf16(sum_l x @ w_l): one accumulator, no epilogue or
                    // barrier between layers; the products' own ceiling
};

constexpr int CT = W / 16;  // column tiles of a 256-wide layer

template <typename T>
struct Frag;
template <>
struct Frag<bf16> {
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> A;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> B;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> C;
  typedef float Acc;
};
template <>
struct Frag<signed char> {
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major>
      A;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major>
      B;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> C;
  typedef int Acc;
};

template <int MODE>
__device__ __forceinline__ bf16 epilogue(float a, float b, float) {
  if constexpr (MODE == M_CAST || MODE == M_SUM) {
    return __float2bfloat16(a);
  } else if constexpr (MODE == M_SELECT) {
    return __float2bfloat16(a > 0.f ? a : 0.f);
  } else if constexpr (MODE == M_CAST_MAX) {
    return __hmax(__float2bfloat16(a), __float2bfloat16(0.f));
  } else if constexpr (MODE == M_BIAS_RELU || MODE == M_RELU2) {
    return __float2bfloat16(fmaxf(a + b, 0.f));
  } else {
    return __float2bfloat16(fmaxf(a, 0.f));
  }
}

// The int8 requant, each step rounded as the plain version rounds it (no
// FMA contraction): relu in the integer domain, then I0's f32 scale, +0.5,
// clip to [0, 127] and truncation, or I1's arithmetic shift.
template <int MODE>
__device__ __forceinline__ signed char epilogue(int a, float, float scale) {
  a = max(a, 0);
  if constexpr (MODE == M_I1) {
    return static_cast<signed char>(min(a >> 6, 127));
  } else {
    const float q = __fadd_rn(__fmul_rn(__int2float_rn(a), scale), 0.5f);
    return static_cast<signed char>(
        static_cast<int>(fminf(fmaxf(q, 0.f), 127.f)));
  }
}

__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(signed char v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T, int ROWS>
constexpr size_t chain_smem() {
  return 2 * sizeof(T) * ROWS * W + sizeof(float) * NWARP * 256;
}

// The rows [0, n) of a shared tile to global memory: as T (16-byte chunks)
// or widened to f32.
template <typename T>
__device__ __forceinline__ void store_rows(void* dst, const T* src, int width,
                                           int n, int out_f32, int tid) {
  if (out_f32) {
    float4* d = reinterpret_cast<float4*>(dst);
    for (int e = tid; e < n * width / 4; e += NTHREADS) {
      const T* v = src + 4 * e;
      d[e] = make_float4(to_float(v[0]), to_float(v[1]), to_float(v[2]),
                         to_float(v[3]));
    }
  } else {
    const int ch = width * static_cast<int>(sizeof(T)) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int e = tid; e < n * ch; e += NTHREADS) d[e] = s[e];
  }
}

// One tile of ROWS rows through `depth` layers. With M_RELU2 the block runs
// two independent chains, each of 4 warps on half the rows with its own
// named barrier, so one chain's epilogue can overlap the other's products
// (kdiag.py's two interleaved half tiles). Otherwise warp w owns column
// tiles {w, w + 8} over all row tiles, as render_body.cuh:mma_k does. With
// M_SUM every layer multiplies the input tile and adds into the same
// accumulators; the epilogue runs once, after the last layer.
template <int MODE, typename T, int ROWS>
__global__ void __launch_bounds__(NTHREADS, ROWS == 64 ? 2 : 1)
k_chain(const T* __restrict__ x, const T* __restrict__ w,
        const float* __restrict__ bias, void* __restrict__ out, int out_f32,
        int rows, int depth) {
  typedef Frag<T> F;
  typedef typename F::Acc Acc;
  constexpr int G = MODE == M_RELU2 ? 2 : 1;  // chains per block
  constexpr int WG = NWARP / G;               // warps per chain
  constexpr int RTG = ROWS / 16 / G;          // row tiles per chain
  constexpr int NC = CT / WG;                 // column tiles per warp
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp / WG, wl = warp - g * WG;
  T* h = reinterpret_cast<T*>(smem);
  T* hn = h + ROWS * W;
  Acc* scr = reinterpret_cast<Acc*>(hn + ROWS * W) + warp * 256;
  const int r0 = blockIdx.x * ROWS;
  const int n = min(ROWS, rows - r0);
  const int row0 = g * RTG * 16;

  load_rows(h, x + static_cast<size_t>(r0) * W, ROWS, W, n, tid);
  __syncthreads();
  typename F::C acc[NC][RTG];
  for (int li = 0; li < depth; ++li) {
    const T* wt = w + static_cast<size_t>(li) * W * W;
    if (MODE != M_SUM || li == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int r = 0; r < RTG; ++r) wmma::fill_fragment(acc[c][r], Acc(0));
    }
    for (int k = 0; k < W; k += 16) {
      typename F::A a[RTG];
#pragma unroll
      for (int r = 0; r < RTG; ++r)
        wmma::load_matrix_sync(a[r], h + (row0 + r * 16) * W + k, W);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        typename F::B b;
        wmma::load_matrix_sync(
            b, wt + static_cast<size_t>(k) * W + (wl + c * WG) * 16, W);
#pragma unroll
        for (int r = 0; r < RTG; ++r)
          wmma::mma_sync(acc[c][r], a[r], b, acc[c][r]);
      }
    }
    if (MODE == M_SUM && li + 1 < depth) continue;
    const float scale = static_cast<float>(0.25 / (li + 2.0));
    const float* bl = bias + static_cast<size_t>(li) * W;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int r = 0; r < RTG; ++r) {
        wmma::store_matrix_sync(scr, acc[c][r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = row0 + r * 16 + (e >> 4);
          const int col = (wl + c * WG) * 16 + (e & 15);
          const float b =
              (MODE == M_BIAS_RELU || MODE == M_RELU2) ? bl[col] : 0.f;
          hn[row * W + col] = epilogue<MODE>(scr[e], b, scale);
        }
        __syncwarp();
      }
    }
    if constexpr (G == 1) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(WG * 32) : "memory");
    }
    T* t = h;
    h = hn;
    hn = t;
  }
  __syncthreads();
  store_rows(static_cast<char*>(out) +
                 static_cast<size_t>(r0) * W * (out_f32 ? 4 : sizeof(T)),
             h, W, n, out_f32, tid);
}

// The f32 chain (kdiag4 V3: no casts) on the CUDA cores: warp w owns rows
// 8w..8w+7 of the 64-row tile and lane l columns 8l..8l+7, so the shared
// activations are read as broadcasts and the weights as coalesced rows;
// 8x8 f32 FMAs per thread per k, k ascending.
constexpr int F32_ROWS = 64;

__global__ void __launch_bounds__(NTHREADS, 1)
k_chain_f32(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int rows, int depth) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* h = reinterpret_cast<float*>(smem);
  float* hn = h + F32_ROWS * W;
  const int r0 = blockIdx.x * F32_ROWS;
  const int n = min(F32_ROWS, rows - r0);
  const int i0 = warp * 8, j0 = lane * 8;

  load_rows(h, x + static_cast<size_t>(r0) * W, F32_ROWS, W, n, tid);
  __syncthreads();
  for (int li = 0; li < depth; ++li) {
    const float* wt = w + static_cast<size_t>(li) * W * W;
    float c[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
    for (int k = 0; k < W; ++k) {
      const float4 b0 = *reinterpret_cast<const float4*>(wt + k * W + j0);
      const float4 b1 = *reinterpret_cast<const float4*>(wt + k * W + j0 + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = h[(i0 + i) * W + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a, b[j], c[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4* d = reinterpret_cast<float4*>(hn + (i0 + i) * W + j0);
      d[0] = make_float4(fmaxf(c[i][0], 0.f), fmaxf(c[i][1], 0.f),
                         fmaxf(c[i][2], 0.f), fmaxf(c[i][3], 0.f));
      d[1] = make_float4(fmaxf(c[i][4], 0.f), fmaxf(c[i][5], 0.f),
                         fmaxf(c[i][6], 0.f), fmaxf(c[i][7], 0.f));
    }
    __syncthreads();
    float* t = h;
    h = hn;
    hn = t;
  }
  store_rows(out + static_cast<size_t>(r0) * W, h, W, n, 1, tid);
}

// The ladder's rungs v0-v2 on one tile of P points with the given PE in
// sm.pe (and, for v2, the dir-PE in sm.ped_tile): mlp_core's trunk without
// (STAGE 0) or with (STAGE >= 1) the skip layer's pe-part, then (STAGE 2)
// its view branch; the last activation (W or WV wide, bf16) goes out.
template <int STAGE>
__global__ void __launch_bounds__(NTHREADS, 2)
k_mlp_ladder(Net net, const bf16* __restrict__ pe,
             const bf16* __restrict__ ped, bf16* __restrict__ out, int N) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  point_smem_layout(smem, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * P;
  const int n = min(P, N - p0);
  float* scr = sm.scr + warp * 256;

  load_rows(sm.pe, pe + static_cast<size_t>(p0) * PE_PAD, P, PE_PAD, n, tid);
  if (STAGE >= 2)
    load_rows(sm.ped_tile, ped + static_cast<size_t>(p0) * PED_PAD, P,
              PED_PAD, n, tid);
  __syncthreads();
  bf16* h = sm.h0;
  {
    FragC acc[2][RT];
    zero<2>(acc);
    mma_k<2>(acc, sm.pe, PE_PAD, PE_PAD, wmat(net, SLOT_W), W, warp);
    store_relu<2>(acc, h, W, fvec(net, SLOT_B), 0, 0, 1, 1, scr, warp, lane);
  }
  __syncthreads();
  for (int i = 1; i < net.depth; ++i) {
    bf16* hn = (h == sm.h0) ? sm.h1 : sm.h0;
    FragC acc[2][RT];
    zero<2>(acc);
    if (STAGE >= 1 && net.slot[SLOT_WSKIP + i] != nullptr)
      mma_k<2>(acc, sm.pe, PE_PAD, PE_PAD, wmat(net, SLOT_WSKIP + i), W, warp);
    mma_k<2>(acc, h, W, W, wmat(net, SLOT_W + i), W, warp);
    store_relu<2>(acc, hn, W, fvec(net, SLOT_B + i), 0, 0, 1, 1, scr, warp,
                  lane);
    __syncthreads();
    h = hn;
  }
  if constexpr (STAGE < 2) {
    store_rows(out + static_cast<size_t>(p0) * W, h, W, n, 0, tid);
  } else {
    bf16* hv = (h == sm.h0) ? sm.h1 : sm.h0;
    bf16* hv2 = hv + P * WV;
    {
      FragC acc[1][RT];
      zero<1>(acc);
      mma_k<1>(acc, h, W, W, wmat(net, SLOT_WV), WV, warp);
      mma_k<1>(acc, sm.ped_tile, PED_PAD, PED_PAD, wmat(net, SLOT_WV0D), WV,
               warp);
      store_relu<1>(acc, hv, WV, fvec(net, SLOT_BV), 0, 0, 1, 1, scr, warp,
                    lane);
    }
    __syncthreads();
    for (int v = 1; v < net.n_views; ++v) {
      FragC acc[1][RT];
      zero<1>(acc);
      mma_k<1>(acc, hv, WV, WV, wmat(net, SLOT_WV + v), WV, warp);
      store_relu<1>(acc, hv2, WV, fvec(net, SLOT_BV + v), 0, 0, 1, 1, scr,
                    warp, lane);
      __syncthreads();
      bf16* t = hv;
      hv = hv2;
      hv2 = t;
    }
    store_rows(out + static_cast<size_t>(p0) * WV, hv, WV, n, 0, tid);
  }
}

// kdiag3 B: the fine pass's rays, depths and in-kernel PE (load_rays,
// mlp_tile), with the tiles' raw rows written to global memory instead of
// shared memory and no compositing. The block layout is K1's.
__global__ void __launch_bounds__(NTHREADS, 2)
k_render_probe_b(Net net, const float* __restrict__ rays_o,
                 const float* __restrict__ rays_d,
                 const float* __restrict__ zin, float* __restrict__ raw,
                 int R, int S, int rb) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  smem_layout(smem, rb, S, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0);

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  for (int e = tid; e < nr * S; e += NTHREADS)
    sm.z[e] = zin[static_cast<size_t>(ray0) * S + e];
  __syncthreads();
  sm.raw = raw + static_cast<size_t>(ray0) * S * 4;
  const int n_pts = nr * S;
  for (int base = 0; base < n_pts; base += P)
    mlp_tile(net, sm, base, n_pts, S, rb, warp, lane, tid);
}

// kdiag3 A: B with the xyz-PE of every point read from global memory and
// the per-ray dir-PE given, its view-layer-0 term built as load_rays does.
__global__ void __launch_bounds__(NTHREADS, 2)
k_render_probe_a(Net net, const bf16* __restrict__ pe,
                 const bf16* __restrict__ ped, float* __restrict__ raw, int R,
                 int S, int rb) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  smem_layout(smem, rb, S, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0);

  for (int e = tid; e < nr * PED_PAD; e += NTHREADS)
    sm.ped[e] =
        __bfloat162float(ped[static_cast<size_t>(ray0) * PED_PAD + e]);
  __syncthreads();
  const bf16* wd = wmat(net, SLOT_WV0D);
  const float* bv0 = fvec(net, SLOT_BV);
  for (int e = tid; e < nr * WV; e += NTHREADS) {
    const int r = e / WV, c = e - r * WV;
    float a = 0.f;
    for (int k = 0; k < PED_PAD; ++k)
      a += sm.ped[r * PED_PAD + k] * __bfloat162float(wd[k * WV + c]);
    sm.pv[e] = a + bv0[c];
  }
  __syncthreads();
  const int n_pts = nr * S;
  const bf16* pe_blk = pe + static_cast<size_t>(ray0) * S * PE_PAD;
  float* raw_blk = raw + static_cast<size_t>(ray0) * S * 4;
  for (int base = 0; base < n_pts; base += P) {
    load_rows(sm.pe, pe_blk + static_cast<size_t>(base) * PE_PAD, P, PE_PAD,
              n_pts - base, tid);
    __syncthreads();
    mlp_core(net, sm, sm.pv, WV, base, n_pts, S, rb, raw_blk, warp, lane);
  }
}

template <int MODE, typename T, int ROWS>
cudaError_t launch_chain(const void* x, const void* w, const float* bias,
                         void* out, int out_f32, int rows, int depth,
                         cudaStream_t st) {
  const size_t bytes = chain_smem<T, ROWS>();
  cudaError_t err = prepare(k_chain<MODE, T, ROWS>, bytes);
  if (err != cudaSuccess) return err;
  k_chain<MODE, T, ROWS><<<(rows + ROWS - 1) / ROWS, NTHREADS, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, out, out_f32,
      rows, depth);
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t launch_rows(int rows_per_block, const void* x, const void* w,
                        const float* bias, void* out, int out_f32, int rows,
                        int depth, cudaStream_t st) {
  if (rows_per_block == 64)
    return launch_chain<MODE, T, 64>(x, w, bias, out, out_f32, rows, depth,
                                     st);
  if (rows_per_block == 128)
    return launch_chain<MODE, T, 128>(x, w, bias, out, out_f32, rows, depth,
                                      st);
  return cudaErrorInvalidValue;
}

template <int STAGE>
cudaError_t launch_ladder(const Net& net, const void* pe, const void* ped,
                          void* out, int N, cudaStream_t st) {
  const size_t bytes = point_smem_layout(nullptr, nullptr);
  cudaError_t err = prepare(k_mlp_ladder<STAGE>, bytes);
  if (err != cudaSuccess) return err;
  k_mlp_ladder<STAGE><<<(N + P - 1) / P, NTHREADS, bytes, st>>>(
      net, static_cast<const bf16*>(pe), static_cast<const bf16*>(ped),
      static_cast<bf16*>(out), N);
  return cudaGetLastError();
}

}  // namespace kd
}  // namespace fr

extern "C" {

// dtype: 0 bf16, 1 f32, 2 int8; mode: fr::kd::Mode. Every (dtype, mode,
// rows_per_block) the kernel does not take returns cudaErrorInvalidValue.
int kd_chain(const void* x, const void* w, const float* bias, void* out,
             int out_f32, int rows, int depth, int dtype, int mode,
             int rows_per_block, void* stream) {
  using namespace fr::kd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (mode) {
      case M_CAST:
        err = launch_rows<M_CAST, fr::bf16>(rows_per_block, x, w, bias, out,
                                            out_f32, rows, depth, st);
        break;
      case M_RELU:
        err = launch_rows<M_RELU, fr::bf16>(rows_per_block, x, w, bias, out,
                                            out_f32, rows, depth, st);
        break;
      case M_BIAS_RELU:
        err = launch_rows<M_BIAS_RELU, fr::bf16>(rows_per_block, x, w, bias,
                                                 out, out_f32, rows, depth,
                                                 st);
        break;
      case M_SELECT:
        err = launch_rows<M_SELECT, fr::bf16>(rows_per_block, x, w, bias,
                                              out, out_f32, rows, depth, st);
        break;
      case M_CAST_MAX:
        err = launch_rows<M_CAST_MAX, fr::bf16>(rows_per_block, x, w, bias,
                                                out, out_f32, rows, depth,
                                                st);
        break;
      case M_RELU2:
        err = launch_rows<M_RELU2, fr::bf16>(rows_per_block, x, w, bias, out,
                                             out_f32, rows, depth, st);
        break;
      case M_SUM:
        err = launch_rows<M_SUM, fr::bf16>(rows_per_block, x, w, bias, out,
                                           out_f32, rows, depth, st);
        break;
      default:
        break;
    }
  } else if (dtype == 2 && out_f32) {
    if (mode == M_I0)
      err = launch_rows<M_I0, signed char>(rows_per_block, x, w, bias, out,
                                           out_f32, rows, depth, st);
    else if (mode == M_I1)
      err = launch_rows<M_I1, signed char>(rows_per_block, x, w, bias, out,
                                           out_f32, rows, depth, st);
  } else if (dtype == 1 && mode == M_RELU && out_f32 &&
             rows_per_block == F32_ROWS) {
    const size_t bytes = 2 * sizeof(float) * F32_ROWS * fr::W;
    err = fr::prepare(k_chain_f32, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    k_chain_f32<<<(rows + F32_ROWS - 1) / F32_ROWS, fr::NTHREADS, bytes,
                  st>>>(static_cast<const float*>(x),
                        static_cast<const float*>(w),
                        static_cast<float*>(out), rows, depth);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// stage 0: trunk only -> (N, 256) bf16; 1: + skip -> (N, 256); 2: + view
// branch -> (N, 128).
int kd_ladder(const void* pe, const void* ped, void* out, int N, int stage,
              const unsigned long long* slots, int depth, int n_views,
              void* stream) {
  using namespace fr::kd;
  const fr::Net net = fr::make_net(slots, depth, n_views, 0, 0, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (stage == 0) err = launch_ladder<0>(net, pe, ped, out, N, st);
  if (stage == 1) err = launch_ladder<1>(net, pe, ped, out, N, st);
  if (stage == 2) err = launch_ladder<2>(net, pe, ped, out, N, st);
  return static_cast<int>(err);
}

int kd_render_a(const void* pe, const void* ped, float* raw, int R, int S,
                int rb, const unsigned long long* slots, int depth,
                int n_views, void* stream) {
  const fr::Net net = fr::make_net(slots, depth, n_views, 0, 0, 0);
  const size_t bytes = fr::smem_layout(nullptr, rb, S, nullptr);
  cudaError_t err = fr::prepare(fr::kd::k_render_probe_a, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fr::kd::k_render_probe_a<<<(R + rb - 1) / rb, fr::NTHREADS, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(pe),
      static_cast<const fr::bf16*>(ped), raw, R, S, rb);
  return static_cast<int>(cudaGetLastError());
}

int kd_render_b(const float* rays_o, const float* rays_d, const float* z,
                float* raw, int R, int S, int rb,
                const unsigned long long* slots, int depth, int n_views,
                int multires, int multires_views, void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, 0);
  const size_t bytes = fr::smem_layout(nullptr, rb, S, nullptr);
  cudaError_t err = fr::prepare(fr::kd::k_render_probe_b, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fr::kd::k_render_probe_b<<<(R + rb - 1) / rb, fr::NTHREADS, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      net, rays_o, rays_d, z, raw, R, S, rb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
