// Shared device body of the fused kernels (fused_render.cu, fused_mlp.cu,
// fused_mlp_grad.cu) and of the probes built from them (kdiag.cu): the
// operand table, PE lanes, the per-ray set-up, alpha compositing, the
// inverse-CDF depth placement that the coarse and delta kernels run and
// the delta kernel's foreground band epilogue, and the wmma MLP body that
// the kdiag.cu probe A and ladder run.
//
// Numeric contract (the same as the JAX package's Pallas kernels,
// idealnerf_tpu/kernels/fused_render.py:_render_body):
//   - bf16 weights; bf16 activations after every relu; f32 accumulation;
//   - PE phases and sin/cos in f32 (phases reach 512*x ~ 300 rad: this file
//     must never be built with --use_fast_math, whose __sinf is wrong far
//     outside [-pi, pi]);
//   - f32 compositing with the transmittance as a running product of
//     max(1 - alpha, 1e-10); the last sample takes the plate colour.
//
// Ray blocks own whole rays, so compositing and the depth placement never
// leave the block and each ray's outputs are written by exactly one block.
// The per-ray code here (load_rays, composite, the depth placement, the
// band) is the ray kernels' of fused_render.cu. Every production forward
// kernel (K1-K3 there, K4 and K5 in fused_mlp.cu) runs its field MLP on
// the wgmma chain of chain.cuh, and so does the gradient kernel's pass A
// (fused_mlp_grad.cu), forward then backward.
//
// The wmma body (mma_k, store_relu, mlp_core) now serves only the kdiag.cu
// probes A and the ladder, which time it as the production kernels ran it
// before the chain: one block of 8 warps walks its points in tiles of P=64
// rows. A tile's activations live in shared memory (two 64x256 bf16
// buffers, ping-pong); layer weights are read per layer from global memory
// (about 1 MB in bf16: L2-resident, larger than the 227 KB of shared
// memory). Products are nvcuda::wmma bf16 16x16x16 fragments with f32
// accumulators; warp w owns output column tiles {w, w+8} across all four
// 16-row tiles, so each weight fragment is fetched once per point tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fr {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int W = 256;          // trunk width
constexpr int WV = W / 2;       // view-branch width
constexpr int PE_PAD = 64;      // 63 xyz-PE lanes + 1 zero lane
constexpr int PED_PAD = 32;     // 27 dir-PE lanes + 5 zero lanes
constexpr int HEADS = 16;       // packed head columns: rgb 0..2, sigma 3
constexpr int P = 64;           // points per tile
constexpr int RT = P / 16;      // 16-row tiles per point tile
constexpr int NWARP = 8;
constexpr int NTHREADS = 32 * NWARP;
constexpr int MAXD = 16;        // trunk layers supported
constexpr int MAXV = 8;         // view layers supported

// Operand table, mirrored by kernels/fused_render.py (_SLOT_*).
enum Slot {
  SLOT_W = 0,                   // layer i: (PE_PAD, W) for i=0, else (W, W) h-part
  SLOT_B = SLOT_W + MAXD,       // layer i folded bias (W,) f32
  SLOT_WSKIP = SLOT_B + MAXD,   // layer i pe-part (PE_PAD, W) if a skip layer, else null
  SLOT_WV = SLOT_WSKIP + MAXD,  // view layer v: (W, WV) h-part for v=0, else (WV, WV)
  SLOT_BV = SLOT_WV + MAXV,     // view layer v bias (WV,) f32 (v=0: folded)
  SLOT_WV0D = SLOT_BV + MAXV,   // (PED_PAD, WV) dir-PE part of view layer 0
  SLOT_WALPHA,                  // (W, HEADS), sigma in column 3
  SLOT_WRGB,                    // (WV, HEADS), rgb in columns 0..2
  SLOT_BHEADS,                  // (HEADS,) f32
  NSLOTS
};

struct Net {
  const void* slot[NSLOTS];
  int depth, n_views, multires, multires_views, softplus;
};

static __device__ __forceinline__ const bf16* wmat(const Net& n, int s) {
  return static_cast<const bf16*>(n.slot[s]);
}
static __device__ __forceinline__ const float* fvec(const Net& n, int s) {
  return static_cast<const float*>(n.slot[s]);
}

struct Smem {
  bf16* pe;      // (P, PE_PAD) tile PE
  bf16* h0;      // (P, W) activations, ping
  bf16* h1;      // (P, W) activations, pong
  float* scr;    // (NWARP, 256) per-warp epilogue scratch
  float* ro;     // (rb, 3)
  float* rd;     // (rb, 3) unnormalised directions
  float* dn;     // (rb,) |rays_d|
  float* ped;    // (rb, PED_PAD) bf16-rounded dir-PE, as f32
  float* pv;     // (rb, WV) per-ray view-layer-0 term ped @ wv0d + bv0
  float* z;      // (rb, S) depths
  float* raw;    // (rb, S, 4) [rgb logits, sigma]
  float* w;      // (rb, S) compositing weights
  float* cdf;    // (rb, n_cdf) coarse and delta kernels: per-ray CDF
  float* uni;    // (rb, n_union) coarse and delta kernels: unsorted union
  float* zp;     // (rb, n_prev) delta kernel only: previous frame's depths
  float* wp;     // (rb, n_prev) delta kernel only: previous frame's weights
  bf16* ped_tile;  // (P, PED_PAD) per-point dir-PE (kdiag.cu's ladder only)
};

// Byte layout of the dynamic shared memory of the wmma ray blocks (the
// kdiag.cu render probe A); the host calls it with a null base to size the
// launch. Every region starts 128-byte aligned.
__host__ __device__ inline size_t smem_layout(char* base, int rb, int S,
                                              Smem* sm) {
  const size_t sz[12] = {
      sizeof(bf16) * P * PE_PAD, sizeof(bf16) * P * W, sizeof(bf16) * P * W,
      sizeof(float) * NWARP * 256,
      sizeof(float) * rb * 3, sizeof(float) * rb * 3, sizeof(float) * rb,
      sizeof(float) * rb * PED_PAD, sizeof(float) * rb * WV,
      sizeof(float) * rb * S, sizeof(float) * rb * S * 4,
      sizeof(float) * rb * S};
  size_t off[12];
  size_t total = 0;
  for (int i = 0; i < 12; ++i) {
    off[i] = total;
    total += (sz[i] + 127) & ~static_cast<size_t>(127);
  }
  if (sm != nullptr) {
    *sm = Smem{};
    sm->pe = reinterpret_cast<bf16*>(base + off[0]);
    sm->h0 = reinterpret_cast<bf16*>(base + off[1]);
    sm->h1 = reinterpret_cast<bf16*>(base + off[2]);
    sm->scr = reinterpret_cast<float*>(base + off[3]);
    sm->ro = reinterpret_cast<float*>(base + off[4]);
    sm->rd = reinterpret_cast<float*>(base + off[5]);
    sm->dn = reinterpret_cast<float*>(base + off[6]);
    sm->ped = reinterpret_cast<float*>(base + off[7]);
    sm->pv = reinterpret_cast<float*>(base + off[8]);
    sm->z = reinterpret_cast<float*>(base + off[9]);
    sm->raw = reinterpret_cast<float*>(base + off[10]);
    sm->w = reinterpret_cast<float*>(base + off[11]);
  }
  return total;
}

// PE lane `lane` of the 3-vector x: [x, sin f0 x, cos f0 x, sin f1 x, ...],
// frequency-major with f_k = 2^k (core/embedding.py); lanes past the last
// frequency are the zero padding.
static __device__ __forceinline__ float pe_lane(const float* x, int lane,
                                                int n_freq) {
  if (lane < 3) return x[lane];
  const int j = lane - 3;
  const int fi = j / 6;
  if (fi >= n_freq) return 0.f;
  const int rem = j - fi * 6;
  const float ph = x[rem % 3] * static_cast<float>(1 << fi);
  return rem < 3 ? sinf(ph) : cosf(ph);
}

// Copy n rows of `width` elements of T (a multiple of 16 bytes per row)
// from global memory into a shared tile of `rows` rows; zeros past n.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows,
                                          int width, int n, int tid) {
  const int ch = width * static_cast<int>(sizeof(T)) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int e = tid; e < rows * ch; e += NTHREADS)
    d[e] = e / ch < n ? s[e] : make_uint4(0, 0, 0, 0);
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int NC>
__device__ __forceinline__ void zero(FragC (&acc)[NC][RT]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[c][r], 0.f);
}

// acc[c][r] += A[16r:16r+16, :K] @ B[:K, 16 (warp + 8c) : +16]
// A: bf16 in shared memory (lda); B: bf16 row-major in global memory (ldb).
template <int NC>
__device__ __forceinline__ void mma_k(FragC (&acc)[NC][RT], const bf16* A,
                                      int lda, int K, const bf16* B, int ldb,
                                      int warp) {
  for (int k = 0; k < K; k += 16) {
    FragA a[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      wmma::load_matrix_sync(a[r], A + r * 16 * lda + k, lda);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      FragB b;
      wmma::load_matrix_sync(
          b, B + static_cast<size_t>(k) * ldb + (warp + c * NWARP) * 16, ldb);
#pragma unroll
      for (int r = 0; r < RT; ++r) wmma::mma_sync(acc[c][r], a[r], b, acc[c][r]);
    }
  }
}

// out = bf16(relu(acc + bias)). With bias_ld == 0 the bias is per column;
// otherwise it is per ray: row p of the tile reads bias[(ray of p) * bias_ld].
template <int NC>
__device__ __forceinline__ void store_relu(FragC (&acc)[NC][RT], bf16* out,
                                           int ldo, const float* bias,
                                           int bias_ld, int tile_base, int S,
                                           int rb, float* scr, int warp,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(scr, acc[c][r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = r * 16 + (e >> 4);
        const int col = (warp + c * NWARP) * 16 + (e & 15);
        const float* bp = bias;
        if (bias_ld) bp += min((tile_base + row) / S, rb - 1) * bias_ld;
        out[row * ldo + col] = __float2bfloat16(fmaxf(scr[e] + bp[col], 0.f));
      }
      __syncwarp();
    }
  }
}

// Per-ray set-up: origins, directions, |d|, the bf16 dir-PE of the unit
// view direction, and its view-layer-0 contribution pv = ped @ wv0d + bv0,
// computed once per ray instead of once per point.
static __device__ void load_rays(const Net& net, const Smem& sm,
                                 const float* rays_o, const float* rays_d,
                                 int ray0, int nr, int tid) {
  for (int r = tid; r < nr; r += NTHREADS) {
    const size_t g = static_cast<size_t>(ray0 + r) * 3;
    float d[3];
    for (int i = 0; i < 3; ++i) {
      sm.ro[r * 3 + i] = rays_o[g + i];
      d[i] = rays_d[g + i];
      sm.rd[r * 3 + i] = d[i];
    }
    const float n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    sm.dn[r] = n;
    const float vd[3] = {d[0] / n, d[1] / n, d[2] / n};
    for (int k = 0; k < PED_PAD; ++k)
      sm.ped[r * PED_PAD + k] = __bfloat162float(
          __float2bfloat16(pe_lane(vd, k, net.multires_views)));
  }
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
}

// The MLP of one tile whose PE is in sm.pe: trunk -> view branch -> heads.
// View layer 0 adds `view_bias` (per column, or per ray with bias_ld != 0).
// Row p of the tile writes raw[(tile_base + p) * 4 + 0..3] if tile_base + p
// < n_pts.
static __device__ void mlp_core(const Net& net, const Smem& sm,
                                const float* view_bias, int bias_ld,
                                int tile_base, int n_pts, int S, int rb,
                                float* raw, int warp, int lane) {
  float* scr = sm.scr + warp * 256;

  // trunk; the skip layer is pe @ W_pe + h @ W_h in one accumulator
  bf16* h = sm.h0;
  {
    FragC acc[2][RT];
    zero<2>(acc);
    mma_k<2>(acc, sm.pe, PE_PAD, PE_PAD, wmat(net, SLOT_W), W, warp);
    store_relu<2>(acc, h, W, fvec(net, SLOT_B), 0, tile_base, S, rb, scr,
                  warp, lane);
  }
  __syncthreads();
  for (int i = 1; i < net.depth; ++i) {
    bf16* hn = (h == sm.h0) ? sm.h1 : sm.h0;
    FragC acc[2][RT];
    zero<2>(acc);
    if (net.slot[SLOT_WSKIP + i] != nullptr)
      mma_k<2>(acc, sm.pe, PE_PAD, PE_PAD, wmat(net, SLOT_WSKIP + i), W, warp);
    mma_k<2>(acc, h, W, W, wmat(net, SLOT_W + i), W, warp);
    store_relu<2>(acc, hn, W, fvec(net, SLOT_B + i), 0, tile_base, S, rb,
                  scr, warp, lane);
    __syncthreads();
    h = hn;
  }

  // view branch, in the trunk buffer that is free now
  bf16* hv = (h == sm.h0) ? sm.h1 : sm.h0;
  bf16* hv2 = hv + P * WV;
  {
    FragC acc[1][RT];
    zero<1>(acc);
    mma_k<1>(acc, h, W, W, wmat(net, SLOT_WV), WV, warp);
    store_relu<1>(acc, hv, WV, view_bias, bias_ld, tile_base, S, rb, scr,
                  warp, lane);
  }
  __syncthreads();
  for (int v = 1; v < net.n_views; ++v) {
    FragC acc[1][RT];
    zero<1>(acc);
    mma_k<1>(acc, hv, WV, WV, wmat(net, SLOT_WV + v), WV, warp);
    store_relu<1>(acc, hv2, WV, fvec(net, SLOT_BV + v), 0, tile_base, S, rb,
                  scr, warp, lane);
    __syncthreads();
    bf16* t = hv;
    hv = hv2;
    hv2 = t;
  }

  // heads: raw = h @ w_alpha + hv @ w_rgb + b_heads, f32, no activation
  if (warp < RT) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    FragA a;
    FragB b;
    const bf16* wa = wmat(net, SLOT_WALPHA);
    const bf16* wr = wmat(net, SLOT_WRGB);
    for (int k = 0; k < W; k += 16) {
      wmma::load_matrix_sync(a, h + warp * 16 * W + k, W);
      wmma::load_matrix_sync(b, wa + k * HEADS, HEADS);
      wmma::mma_sync(acc, a, b, acc);
    }
    for (int k = 0; k < WV; k += 16) {
      wmma::load_matrix_sync(a, hv + warp * 16 * WV + k, WV);
      wmma::load_matrix_sync(b, wr + k * HEADS, HEADS);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const float* bh = fvec(net, SLOT_BHEADS);
    for (int e = lane; e < 64; e += 32) {
      const int rr = e >> 2, cc = e & 3;
      const int p = tile_base + warp * 16 + rr;
      if (p < n_pts) raw[p * 4 + cc] = scr[rr * 16 + cc] + bh[cc];
    }
  }
  __syncthreads();
}

// Compositing of the block's rays from sm.z and sm.raw: summary (R, 8) =
// [rgb, acc, last_w, depth, 0, 0] and weights (R, S), one thread per ray.
static __device__ void composite(const Net& net, const Smem& sm,
                                 const float* bc, float* summary,
                                 float* weights, int ray0, int nr, int S,
                                 int tid) {
  const int n_pts = nr * S;
  for (int r = tid; r < nr; r += NTHREADS) {
    const float* z = sm.z + r * S;
    const float* raw = sm.raw + static_cast<size_t>(r) * S * 4;
    float* w = sm.w + r * S;
    const float dn = sm.dn[r];
    float T = 1.f, acc = 0.f, dep = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    float last = 0.f;
    for (int s = 0; s < S; ++s) {
      const float dist = (s + 1 < S ? z[s + 1] - z[s] : 1e10f) * dn;
      const float sg = raw[s * 4 + 3];
      const float act =
          net.softplus ? (sg > 20.f ? sg : logf(1.f + expf(fminf(sg, 20.f))))
                       : fmaxf(sg, 0.f);
      const float alpha = 1.f - expf(-(act + 1e-6f) * dist);
      const float wt = alpha * T;
      T *= fmaxf(1.f - alpha, 1e-10f);
      w[s] = wt;
      acc += wt;
      dep += wt * z[s];
      if (s + 1 < S) {
        c0 += wt * (1.f / (1.f + expf(-raw[s * 4])));
        c1 += wt * (1.f / (1.f + expf(-raw[s * 4 + 1])));
        c2 += wt * (1.f / (1.f + expf(-raw[s * 4 + 2])));
      } else {
        last = wt;
      }
    }
    const size_t g = static_cast<size_t>(ray0 + r);
    float* o = summary + g * 8;
    o[0] = c0 + last * bc[g * 3];
    o[1] = c1 + last * bc[g * 3 + 1];
    o[2] = c2 + last * bc[g * 3 + 2];
    o[3] = acc;
    o[4] = last;
    o[5] = dep;
    o[6] = 0.f;
    o[7] = 0.f;
  }
  __syncthreads();
  for (int e = tid; e < n_pts; e += NTHREADS)
    weights[static_cast<size_t>(ray0) * S + e] = sm.w[e];
}

// Per-ray CDFs of the deterministic inverse-CDF draw (core/sampling.py:
// sample_pdf) over the Sd - 1 bin mids of the depths z[0:Sd] with weights
// w[1:Sd-1] + 1e-5; row r of z and w starts at r * ld, its CDF (Sd - 1
// entries, cdf[0] = 0) at cdf + r * (Sd - 1). Summed in f64 and rounded
// once, as sample_pdf does, so the summation order leaves no trace in the
// f32 CDF; the last entry is pinned to 1, its exact value, as sample_pdf
// pins it. One thread per ray.
static __device__ void pdf_cdf(const float* z, const float* w, int ld, int Sd,
                               float* cdf, int nr, int tid) {
  const int B = Sd - 1;
  for (int r = tid; r < nr; r += NTHREADS) {
    const float* wr = w + r * ld;
    float* c = cdf + r * B;
    double sum = 0.0;
    for (int j = 1; j < Sd - 1; ++j) sum += static_cast<double>(wr[j] + 1e-5f);
    double run = 0.0;
    c[0] = 0.f;
    for (int j = 1; j < Sd - 1; ++j) {
      run += static_cast<double>(wr[j] + 1e-5f) / sum;
      c[j] = static_cast<float>(run);
    }
    c[B - 1] = 1.f;
  }
}

// Depth j of n deterministic inverse-CDF samples over one ray's bins: u =
// j / (n - 1), a short scan over the B-entry CDF c for the last edge with
// c <= u (searchsorted right, minus one), then the linear step between the
// bin mids of z.
static __device__ float pdf_sample(const float* z, const float* c, int B,
                                   int j, int n) {
  const float u = __fdiv_rn(static_cast<float>(j), static_cast<float>(n - 1));
  int lo = 0;
  while (lo + 1 < B && c[lo + 1] <= u) ++lo;
  const int hi = lo + 1 < B ? lo + 1 : B - 1;
  const float bl = 0.5f * (z[lo] + z[lo + 1]);
  const float bh = 0.5f * (z[hi] + z[hi + 1]);
  float den = c[hi] - c[lo];
  if (den < 1e-5f) den = 1.f;
  // _rn intrinsics: no FMA contraction, each step rounded as the plain
  // version rounds it
  return __fadd_rn(bl, __fmul_rn(__fdiv_rn(__fsub_rn(u, c[lo]), den),
                                 __fsub_rn(bh, bl)));
}

// Ascending sort of each ray's n values in vals (row stride n) by rank:
// element e lands at #{f: v_f < v_e} plus the equal values before it,
// which equals a stable sort. Row r goes to out + r * ldo.
static __device__ void rank_sort(const float* vals, int n, float* out,
                                 size_t ldo, int nr, int tid) {
  for (int e = tid; e < nr * n; e += NTHREADS) {
    const int r = e / n, j = e - r * n;
    const float* uu = vals + r * n;
    const float v = uu[j];
    int rank = 0;
    for (int f = 0; f < n; ++f) {
      const float x = uu[f];
      rank += (x < v) | ((x == v) & (f < j));
    }
    out[r * ldo + rank] = v;
  }
}

// Fine depths from the coarse weights: sort(concat(z, sample_pdf(mids of z,
// weights[1:-1], n_imp))) written to z_all (R, S + n_imp).
static __device__ void hier_depths(const Smem& sm, float* z_all, int ray0,
                                   int nr, int S, int n_imp, int tid) {
  pdf_cdf(sm.z, sm.w, S, S, sm.cdf, nr, tid);
  __syncthreads();
  const int SU = S + n_imp;
  for (int e = tid; e < nr * SU; e += NTHREADS) {
    const int r = e / SU, j = e - r * SU;
    const float* z = sm.z + r * S;
    sm.uni[e] = j < S ? z[j]
                      : pdf_sample(z, sm.cdf + r * (S - 1), S - 1, j - S, n_imp);
  }
  __syncthreads();
  rank_sort(sm.uni, SU, z_all + static_cast<size_t>(ray0) * SU, SU, nr, tid);
}

// A delta frame's depths into sm.z (rb, S), S = s_imp + s_uni + 1:
// s_imp inverse-CDF samples over the previous frame's per-ray (z, w) in
// sm.zp / sm.wp (row stride s_prev; its last depth is the plate pin and is
// no bin edge), s_uni depths lo + (hi - lo) * j / (s_uni - 1) across the
// cached band, their sorted union, and the plate pin at `far` last
// (eval/temporal.py:_delta_depths).
static __device__ void delta_depths(const Smem& sm, const float* band_lo,
                                    const float* band_hi, float far,
                                    int ray0, int nr, int s_prev, int s_uni,
                                    int s_imp, int tid) {
  const int Sd = s_prev - 1;
  pdf_cdf(sm.zp, sm.wp, s_prev, Sd, sm.cdf, nr, tid);
  __syncthreads();
  const int n_in = s_imp + s_uni, S = n_in + 1;
  for (int e = tid; e < nr * n_in; e += NTHREADS) {
    const int r = e / n_in, j = e - r * n_in;
    float v;
    if (j < s_imp) {
      v = pdf_sample(sm.zp + r * s_prev, sm.cdf + r * (Sd - 1), Sd - 1, j,
                     s_imp);
    } else {
      const float t = __fdiv_rn(static_cast<float>(j - s_imp),
                                static_cast<float>(s_uni - 1));
      const float lo = band_lo[ray0 + r], hi = band_hi[ray0 + r];
      v = __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), t));
    }
    sm.uni[e] = v;
  }
  for (int r = tid; r < nr; r += NTHREADS) sm.z[r * S + S - 1] = far;
  __syncthreads();
  rank_sort(sm.uni, n_in, sm.z, S, nr, tid);
  __syncthreads();
}

// The next frame's foreground band from this frame's depths and weights
// (sm.z, sm.w, the plate sample excluded): lo / hi are the least depths
// whose cumulative weight reaches q_lo / q_hi of the ray's total, capped
// at the last non-plate depth (eval/temporal.py:fg_band). The cumulative
// weights are summed in f64 and rounded once, as fg_band sums them, so a
// threshold comparison cannot flip on summation order. Written to
// summary[:, 6:8]. One thread per ray.
static __device__ void fg_band_out(const Smem& sm, float* summary, int ray0,
                                   int nr, int S, float q_lo, float q_hi,
                                   int tid) {
  for (int r = tid; r < nr; r += NTHREADS) {
    const float* z = sm.z + r * S;
    const float* w = sm.w + r * S;
    double tot = 0.0;
    for (int s = 0; s < S - 1; ++s) tot += static_cast<double>(w[s]);
    const float total = fmaxf(static_cast<float>(tot), 1e-10f);
    const float t_lo = __fmul_rn(q_lo, total), t_hi = __fmul_rn(q_hi, total);
    float lo = 1e10f, hi = 1e10f;
    double run = 0.0;
    for (int s = 0; s < S - 1; ++s) {
      run += static_cast<double>(w[s]);
      const float cw = static_cast<float>(run);
      if (cw >= t_lo) lo = fminf(lo, z[s]);
      if (cw >= t_hi) hi = fminf(hi, z[s]);
    }
    float* o = summary + static_cast<size_t>(ray0 + r) * 8;
    o[6] = fminf(lo, z[S - 2]);
    o[7] = fminf(hi, z[S - 2]);
  }
}

inline Net make_net(const unsigned long long* slots, int depth, int n_views,
                    int multires, int multires_views, int softplus) {
  Net net;
  for (int i = 0; i < NSLOTS; ++i)
    net.slot[i] = reinterpret_cast<const void*>(slots[i]);
  net.depth = depth;
  net.n_views = n_views;
  net.multires = multires;
  net.multires_views = multires_views;
  net.softplus = softplus;
  return net;
}

template <typename K>
inline cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fr
