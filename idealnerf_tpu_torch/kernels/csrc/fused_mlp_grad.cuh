// Rematerialising backward of the fused point MLP for Hopper (sm_90a), with
// a plain C interface loaded through ctypes by kernels/fused_mlp_grad.py:
// templates over the net's widths (chain.cuh Layout<W>), instantiated once
// per width by fused_mlp_grad_w<W>.cu (FR_GRAD_ENTRIES:
// fr_grad_pass_a_w128, ...).
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
// is h > 0 on the recomputed, rounded post-activation (in f32 every
// rounding is the identity). Neither uses float atomics: the same inputs on
// the same card give bitwise-equal gradients. Each variant is two passes:
// pass A recomputes and runs d_h back, writing every operand of the weight
// gradients of all N points to planes in device memory; pass B computes
// every weight gradient as one long-K product over those points.
//
// bf16 (the training default):
// - k_grad_pass_a: the recompute and the d_h chain on the wgmma chain of
//   chain.cuh, with no weight-gradient product. One block per SM walks a
//   contiguous run of tiles (the point kernels' plan,
//   kernels/fused_mlp.py: _point_plan); its producer thread streams the
//   net's pass-A weight stream through a shared-memory ring of 4 stages
//   once per tile: K4's forward stages without the heads (chain_stages:
//   the heads' stage traded for the dir-PE stage), then the transposed
//   matrices the backward multiplies by (kernels/fused_mlp_grad.py:
//   grad_weight_stream), at W=256:
//     WV_v^T          (128 x 128) for v = NV-1..1, 2 stages of 64 K-rows
//     WV_0^T h-part   (128 x 256) 4 stages of 32 K-rows
//     W_i^T           (256 x 256) for i = D-1..1, 8 stages of 32 K-rows
//   (64 stages for the paper model, 133 a tile with the forward's 69);
//   layer 0, the skip pe-part and the dir-PE part get none, as points get
//   no gradient. At W <= 256 each consumer warpgroup owns 64 points, one
//   64-point tile of the planes (pass_a_tile); at W=512 both share one 64-
//   point tile, each on its half of every layer's columns, as the forward
//   chain does (pass_a_tile_split, below). Forward: PointTile's PE and
//   dir-PE tiles, then per layer
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
// f32 (train_fused 1): the products are f32 FFMAs on the CUDA cores (TF32
// keeps 10 mantissa bits, where this variant must match f32 autograd), so
// it is bound by the card's f32 rate: 3 multiply-add passes over the MLP,
// about 1.7 M a point.
// - k_grad_pass_a_f32: one block per SM walks a contiguous run of 64-point
//   tiles. Its producer thread streams the net's f32 weight stream
//   (kernels/fused_mlp_grad.py: grad_weight_stream_f32) once per tile
//   through a ring of 16 KB stages by cp.async.bulk on mbarriers (the
//   chain's chain_produce): row-major K-slabs of 16 rows of a 256-wide
//   matrix or 32 rows of a 128-wide one, forward then the transposed
//   matrices of the backward (265 stages for the paper model). The 8
//   consumer warps keep the tile's activation (the A operand, row-major
//   64 x 256 f32), PE and dir-PE in shared memory; each thread holds an
//   8 x 8 register block (warp w rows 8w..8w+7, lane l columns 4l..4l+3
//   and 128+4l..128+4l+3) and runs 64 FFMAs per k on broadcast float4
//   loads of A and conflict-free float4 loads of B (fring.cuh: the ring
//   and the product, shared with kdiag_dtype.cu's f32 chain). relu' bits
//   stay in shared memory (64 per thread and layer); each epilogue writes
//   its tile to the planes by streaming stores (st.global.cs) and, in the
//   backward, the tile's bias column sums (rows in order, then warps in
//   order) to a per-tile row.
// - k_grad_pass_b_f32: every weight gradient as X^T @ D over the points.
//   The grid is (128 x 128 output tile, chunk of point tiles); slabs of 32
//   points of both operands are staged by cp.async into a 3-stage ring,
//   and each thread sums an 8 x 8 register block over the chunk's points
//   in order, one partial per chunk.
// - k_bias_partials and k_reduce_slabs, as for bf16.
#pragma once

#include "chain.cuh"
#include "fring.cuh"

namespace fr {

constexpr int GP = P;  // points per backward tile

// Float offset of each operand's gradient inside a chunk's partial; -1 for
// an absent slot.
struct GradTable {
  long long off[NSLOTS];
};

// out[e] = sum of the slabs' (chunks' partials') element e, in order.
// (static: every width's translation unit has its own.)
static __global__ void k_reduce_slabs(const float* __restrict__ slabs,
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
template <class T>
inline int grad_back_stages(int depth, int n_views) {
  constexpr int v = (T::WV + T::KC_V - 1) / T::KC_V;
  return (n_views - 1) * v + T::WV / T::KC_W + (depth - 1) * (T::W / T::KC_W);
}

// Pass A's layout past the chain's. W <= 256: a warpgroup's tiles are PE,
// trunk and view (the ray kernels' WG_BYTES); the dir-PE tile lives in the
// view tile's first 8 KB until view layer 0's epilogue overwrites it; in
// the backward the trunk tile holds DC(i), the view tile DV(v) and the PE
// tile the column sums' scratch. W=512: the block's PE tile and its two
// trunk tiles (the forward chain's), both warpgroups' relu' bits after
// them; the dir-PE tile lives in the second half of the trunk tile the last
// trunk layer does not write, until view layer 1's epilogue overwrites it;
// in the backward DC(i) and DV(v) ping-pong as the forward's activations
// do, and each warpgroup's column sums' scratch is one half of the PE tile.
template <class T>
struct PassA {
  static_assert(PED_TILE <= T::HV_TILE, "the dir-PE tile shares a view tile");
  static constexpr int MW = T::NRW / 32, MV = T::NRV / 32;  // relu' words
  static constexpr int TILES = T::kSplit ? T::TILES : 2 * T::WG_BYTES;
  // a warpgroup's scratch (floats): its column sums of a layer (4 warps x
  // its columns), and the heads' partials past those of the layer they
  // share the scratch with (the trunk's at W <= 256, the last view
  // layer's at 512)
  static constexpr int PART_FLOATS = T::kSplit ? PE_TILE / 8 : PE_TILE / 4;
  static constexpr int SCRATCH_HEADS = T::kSplit ? 4 * T::CV : 4 * T::CW;
  static_assert(4 * T::CW <= PART_FLOATS && SCRATCH_HEADS + 8 <= PART_FLOATS,
                "the column sums fit the scratch");
};

// A warpgroup's relu' bits: per trunk layer 4 MW bytes a thread (NRW
// values), per view layer 4 MV (NRV values); at W=256 16 and 8. Rounded
// up to 1,024 bytes, so that the tiles after them (warpgroup 1's at W <=
// 256) stay aligned to the swizzle's atoms (at W=256 they are whole KB).
template <class T>
__host__ __device__ inline int mask_bytes(int depth, int n_views) {
  const int bytes = 128 * 4 * (PassA<T>::MW * depth + PassA<T>::MV * n_views);
  return (bytes + 1023) & ~1023;
}

// A thread's relu' words of one layer: M 32-bit words at its slot of the
// layer's block (128 threads x M words).
template <int M>
__device__ __forceinline__ void put_bits(char* layer, const uint32_t (&m)[M],
                                         int wtid) {
  if constexpr (M == 4)
    reinterpret_cast<uint4*>(layer)[wtid] = make_uint4(m[0], m[1], m[2], m[3]);
  else if constexpr (M == 2)
    reinterpret_cast<uint2*>(layer)[wtid] = make_uint2(m[0], m[1]);
  else
    reinterpret_cast<uint32_t*>(layer)[wtid] = m[0];
}
template <int M>
__device__ __forceinline__ void get_bits(const char* layer, uint32_t (&m)[M],
                                         int wtid) {
  if constexpr (M == 4) {
    const uint4 u = reinterpret_cast<const uint4*>(layer)[wtid];
    m[0] = u.x;
    m[1] = u.y;
    m[2] = u.z;
    m[3] = u.w;
  } else if constexpr (M == 2) {
    const uint2 u = reinterpret_cast<const uint2*>(layer)[wtid];
    m[0] = u.x;
    m[1] = u.y;
  } else {
    m[0] = reinterpret_cast<const uint32_t*>(layer)[wtid];
  }
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
// n_ring stages, the tiles and both warpgroups' relu' bits, 128 bytes of
// the ring's mbarriers, then each warpgroup's mailbox full / empty
// mbarriers and its Mail.
constexpr int MAIL_BYTES = 2 * 2 * 8 + 2 * sizeof(Mail);
template <class T>
__host__ __device__ inline size_t pass_a_smem_bytes(int n_ring, int depth,
                                                    int n_views) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES +
         PassA<T>::TILES + 2 * static_cast<size_t>(mask_bytes<T>(depth,
                                                                 n_views)) +
         128 + MAIL_BYTES;
}

// Every product of pass A starts its accumulator over (scale-d 0), so an
// epilogue zeroes the registers it has read: the compiler then need not
// keep them live beside the epilogue's own.
template <int A>
__device__ __forceinline__ void clear(float (&acc)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) acc[i] = 0.f;
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
template <int NR, int A>
__device__ __forceinline__ void grad_store(float (&acc)[A], bf16* tile,
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
template <int NR, bool ADD, int A>
__device__ __forceinline__ void heads_fma(float (&acc)[A],
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

// Pass A's hand-over of finished tiles to the store warps, for one
// warpgroup: put (a tile for a plane, at most two between posts), post
// (one per epilogue; posts counts them), reuse (before writing a tile
// again: the last post's stores are done, and, over `threads` threads of
// barrier `bar`, every warp's reads) and ready (the tile is written, for
// wgmma and the stores). A warpgroup past N posts nothing to store.
struct MailBox {
  Mail& mail;
  uint32_t full, empty;
  uint32_t& posts;
  bf16* planes;
  const Planes& pl;
  int pt, wtid, bar, threads;
  bool live;
  int n_put = 0;

  __device__ __forceinline__ void put(const bf16* from, int plane, int width,
                                      int off = 0, int bytes = 0) {
    if (live && wtid == 0) {
      mail.dst[n_put] = planes + pl.off[plane] +
                        static_cast<size_t>(pt) * GP * width + off;
      mail.src[n_put] = from;
      mail.bytes[n_put] = bytes ? bytes : 2 * GP * width;
      ++n_put;
    }
  }
  __device__ __forceinline__ void post() {
    if (wtid == 0) {
      mail.n = n_put;
      mbar_arrive(full);
    }
    n_put = 0;
    ++posts;
  }
  __device__ __forceinline__ void reuse() {
    if (wtid == 0 && posts > 0) mbar_wait(empty, (posts - 1) & 1);
    named_barrier(bar, threads);
  }
  __device__ __forceinline__ void ready() {
    fence_proxy_async();
    named_barrier(bar, threads);
  }
};

// GB (the rounded cotangent, zero past lane 3) of a 64-point tile straight
// to its plane: gr is the f32 cotangent of row wtid % 64 (threads < 64,
// zero elsewhere).
__device__ __forceinline__ void cotangent_out(const Planes& pl, bf16* planes,
                                              float4 gr, int pt, bool live,
                                              int wtid) {
  const int grow = wtid & 63, c0 = wtid >> 6;
  if (live) {
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
}

// Pass A for warpgroup wg on one 128-point tile at W <= 256 (rows 64 wg ..
// +64 at tile_base of the block's n_pts points; the block's first 64-point
// tile of the planes is pt0): the forward, then d_h back through the heads,
// the view branch and the trunk. Each epilogue's finished tiles go to the
// store warps through the warpgroup's MailBox. A warpgroup past N computes
// on zeros and posts nothing to store; rows past N have a zero cotangent,
// so every d_h of theirs is zero.
template <class T>
__device__ __forceinline__ void pass_a_tile(
    const Net& net, const Planes& pl, const PointTile<false, T>& src,
    const float* __restrict__ gin, bf16* planes, float* bias, Ring& r,
    char* tiles, Mail& mail, uint32_t mail_full, uint32_t mail_empty,
    uint32_t& posts, int tile_base, int n_pts, int pt0, int wg, int wtid) {
  constexpr int W = T::W, WV = T::WV, NRW = T::NRW, NRV = T::NRV;
  constexpr int MW = PassA<T>::MW, MV = PassA<T>::MV;
  const int D = net.depth, NV = net.n_views;
  const int row0 = tile_base + 64 * wg;
  const int pt = pt0 + row0 / GP;
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  bf16* h_g = pe_g + PE_TILE / 2;
  bf16* hv_g = h_g + T::H_TILE / 2;
  bf16* ped_g = hv_g;
  const uint32_t pe = smem_addr(tiles), h = pe + PE_TILE, hv = h + T::H_TILE;
  const uint32_t ped = hv;
  char* masks = tiles + T::WG_BYTES;
  char* vmasks = masks + 512 * MW * D;
  float* part = reinterpret_cast<float*>(tiles);
  float* brow = bias + static_cast<size_t>(pt) * (D * W + NV * WV + HEADS);
  MailBox mb{mail, mail_full, mail_empty, posts, planes, pl,
             pt,   wtid,      1 + wg,     128,   row0 < n_pts};

  float acc[T::ACC];
  clear(acc);

  // ---- forward, K4's chain without the heads; relu' bits kept
  mb.reuse();
  src.fill(net, pe_g, ped_g, row0, n_pts, wtid);
  mb.ready();
  mb.put(pe_g, PL_PE, PE_PAD);
  mb.put(ped_g, PL_PED, LANES);
  mb.post();
  for (int i = 0; i < D; ++i) {
    trunk_prod<T>(net, acc, r, pe, h, i);
    ring_drain(r);
    mb.reuse();
    uint32_t m[MW] = {};
    const float* b = fvec(net, SLOT_B + i);
    relu_store<NRW, true>(acc, h_g, b, b, wtid, m);
    clear(acc);
    put_bits<MW>(masks + 512 * MW * i, m, wtid);
    mb.ready();
    mb.put(h_g, PL_H + i, W);
    mb.post();
  }
  for (int v = 0; v < NV; ++v) {
    view_prod<T, true>(acc, r, h, hv, ped, v);
    ring_drain(r);
    mb.reuse();
    uint32_t m[MV] = {};
    const float* b = fvec(net, SLOT_BV + v);
    relu_store<NRV, true>(acc, hv_g, b, b, wtid, m);
    clear(acc);
    put_bits<MV>(vmasks + 512 * MV * v, m, wtid);
    mb.ready();
    mb.put(hv_g, PL_H + D + v, WV);
    mb.post();
  }

  // ---- backward. The cotangent at row wtid % 64 for the GB tile and the
  // heads' bias sums (threads < 64).
  const int grow = wtid & 63, c0 = wtid >> 6;
  float4 gr = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 == 0 && row0 + grow < n_pts)
    gr = __ldg(reinterpret_cast<const float4*>(gin) + row0 + grow);
  cotangent_out(pl, planes, gr, pt, mb.live, wtid);
  mb.reuse();
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
      reinterpret_cast<float4*>(part + PassA<T>::SCRATCH_HEADS)[wtid >> 5] =
          s;
  }
  // d_hv of the last view layer = g @ w_rgb^T
  heads_fma<NRV, false>(acc, gin, row0, n_pts, wmat(net, SLOT_WRGB), wtid);
  {
    uint32_t m[MV];
    get_bits<MV>(vmasks + 512 * MV * (NV - 1), m, wtid);
    grad_store<NRV>(acc, hv_g, m, part, wtid);
  }
  mb.ready();
  mb.put(hv_g, PL_H + 2 * D + NV + NV - 1, WV);
  mb.post();
  if (mb.live) {
    bias_row<NRV>(part, brow + D * W + (NV - 1) * WV, wtid);
    if (wtid < HEADS) {
      const float* ph = part + PassA<T>::SCRATCH_HEADS;
      brow[D * W + NV * WV + wtid] = wtid < 4 ? ph[wtid] + ph[4 + wtid] : 0.f;
    }
  }
  for (int v = NV - 1; v >= 1; --v) {  // d_hv(v - 1) = dv(v) @ WV_v^T
    prod<NRV, T::KC_V, T::KS_V>(acc, r, hv, WV, true);
    ring_drain(r);
    mb.reuse();
    uint32_t m[MV];
    get_bits<MV>(vmasks + 512 * MV * (v - 1), m, wtid);
    grad_store<NRV>(acc, hv_g, m, part, wtid);
    mb.ready();
    mb.put(hv_g, PL_H + 2 * D + NV + v - 1, WV);
    mb.post();
    if (mb.live) bias_row<NRV>(part, brow + D * W + (v - 1) * WV, wtid);
  }
  // d_h of the last trunk layer = dv(0) @ WV_0^T + g @ w_alpha^T
  prod<NRW, T::KC_W>(acc, r, hv, WV, true);
  ring_drain(r);
  heads_fma<NRW, true>(acc, gin, row0, n_pts, wmat(net, SLOT_WALPHA), wtid);
  for (int i = D - 1; i >= 0; --i) {  // d_h(i - 1) = dc(i) @ W_i^T
    mb.reuse();
    uint32_t m[MW];
    get_bits<MW>(masks + 512 * MW * i, m, wtid);
    grad_store<NRW>(acc, h_g, m, part, wtid);
    mb.ready();
    mb.put(h_g, PL_H + D + NV + i, W);
    mb.post();
    if (mb.live) bias_row<NRW>(part, brow + i * W, wtid);
    if (i > 0) {
      prod<NRW, T::KC_W>(acc, r, h, W, true);
      ring_drain(r);
    }
  }
}

// Pass A on one 64-point tile at W=512 (rows row0.. of the block's n_pts
// points, plane tile pt0 + row0 / 64), both warpgroups on the same rows,
// warpgroup wg on columns wg CW.. of every trunk layer and wg CV.. of every
// view layer: pass_a_tile's walk on chain_tile_split's tiles. Trunk layer i
// writes H[i % 2]; the view branch ping-pongs between the halves of the
// other trunk tile, whose second half holds the dir-PE tile for view layer
// 0 (warpgroup 0 fills it again after the trunk, which writes over it; its
// plane is posted from the first fill); in the backward DV(v) continues the view branch's
// ping-pong, then DC(D-1) goes to the trunk's last tile and DC(i)
// alternates between the two. Every epilogue writes the warpgroup's half
// of a tile and posts that half (32 KB of a trunk tile's image, 16 KB of a
// view tile's) to the store warps; warpgroup 0 also fills and posts the PE
// and dir-PE tiles, writes GB and the heads' bias sums. MailBox joins both
// warpgroups on barrier 1, so a tile is written again only after both
// warpgroups' products have read it and both halves' stores are done.
template <class T>
__device__ __forceinline__ void pass_a_tile_split(
    const Net& net, const Planes& pl, const PointTile<false, T>& src,
    const float* __restrict__ gin, bf16* planes, float* bias, Ring& r,
    char* tiles, char* masks, Mail& mail, uint32_t mail_full,
    uint32_t mail_empty, uint32_t& posts, int row0, int n_pts, int pt0,
    int wg, int wtid) {
  constexpr int W = T::W, WV = T::WV, NRW = T::NRW, NRV = T::NRV;
  constexpr int MW = PassA<T>::MW, MV = PassA<T>::MV;
  const int D = net.depth, NV = net.n_views;
  const int pt = pt0 + row0 / GP;
  const uint32_t boff = wg * T::HALF;
  const int cw = wg * T::CW, cv = wg * T::CV;
  bf16* pe_g = reinterpret_cast<bf16*>(tiles);
  bf16* h_g[2] = {pe_g + PE_TILE / 2, pe_g + PE_TILE / 2 + T::H_TILE / 2};
  const uint32_t pe = smem_addr(tiles);
  const uint32_t h[2] = {pe + PE_TILE, pe + PE_TILE + T::H_TILE};
  const int hl = (D - 1) & 1;  // the trunk tile of the last layer
  bf16* hv_g[2] = {h_g[hl ^ 1], h_g[hl ^ 1] + T::HV_TILE / 2};
  const uint32_t hv[2] = {h[hl ^ 1], h[hl ^ 1] + T::HV_TILE};
  bf16* ped_g = hv_g[1];
  char* vmasks = masks + 512 * MW * D;
  float* part = reinterpret_cast<float*>(tiles) + wg * PassA<T>::PART_FLOATS;
  float* brow = bias + static_cast<size_t>(pt) * (D * W + NV * WV + HEADS);
  MailBox mb{mail, mail_full, mail_empty, posts, planes, pl,
             pt,   wtid,      1,          256,   row0 < n_pts};
  // the warpgroup's half of a trunk / view tile's image (elements, bytes)
  const int sw = swz(0, cw), sv = swz(0, cv);
  constexpr int HW_BYTES = T::H_TILE / 2, HV_BYTES = T::HV_TILE / 2;

  float acc[T::ACC];
  clear(acc);

  // ---- forward; relu' bits kept
  mb.reuse();
  if (wg == 0) src.fill(net, pe_g, ped_g, row0, n_pts, wtid);
  mb.ready();
  if (wg == 0) {
    mb.put(pe_g, PL_PE, PE_PAD);
    mb.put(ped_g, PL_PED, LANES);
  }
  mb.post();
  for (int i = 0; i < D; ++i) {
    const int o = i & 1;
    trunk_prod<T>(net, acc, r, pe, h[o ^ 1], i, boff);
    ring_drain(r);
    mb.reuse();
    uint32_t m[MW] = {};
    const float* b = fvec(net, SLOT_B + i) + cw;
    relu_store<NRW, true>(acc, h_g[o] + sw, b, b, wtid, m);
    clear(acc);
    put_bits<MW>(masks + 512 * MW * i, m, wtid);
    mb.ready();
    mb.put(h_g[o] + sw, PL_H + i, W, sw, HW_BYTES);
    mb.post();
  }
  // the dir-PE tile again: the trunk's layers D - 2, D - 4, ... wrote over
  // it (and their stores are done: reuse)
  mb.reuse();
  if (wg == 0) src.fill(net, pe_g, ped_g, row0, n_pts, wtid);
  mb.ready();
  for (int v = 0; v < NV; ++v) {
    const int o = v & 1;
    view_prod<T, true>(acc, r, h[hl], hv[o ^ 1], smem_addr(ped_g), v, boff);
    ring_drain(r);
    mb.reuse();
    uint32_t m[MV] = {};
    const float* b = fvec(net, SLOT_BV + v) + cv;
    relu_store<NRV, true>(acc, hv_g[o] + sv, b, b, wtid, m);
    clear(acc);
    put_bits<MV>(vmasks + 512 * MV * v, m, wtid);
    mb.ready();
    mb.put(hv_g[o] + sv, PL_H + D + v, WV, sv, HV_BYTES);
    mb.post();
  }

  // ---- backward. Warpgroup 0: the cotangent at row wtid % 64 for the GB
  // tile and the heads' bias sums (threads < 64).
  const int grow = wtid & 63, c0 = wtid >> 6;
  float4 gr = make_float4(0.f, 0.f, 0.f, 0.f);
  if (wg == 0 && c0 == 0 && row0 + grow < n_pts)
    gr = __ldg(reinterpret_cast<const float4*>(gin) + row0 + grow);
  if (wg == 0) cotangent_out(pl, planes, gr, pt, mb.live, wtid);
  mb.reuse();
  if (wg == 0 && c0 == 0) {  // b_heads: the column sums of the cotangent
    float4 s = gr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_xor_sync(0xFFFFFFFFu, s.x, o);
      s.y += __shfl_xor_sync(0xFFFFFFFFu, s.y, o);
      s.z += __shfl_xor_sync(0xFFFFFFFFu, s.z, o);
      s.w += __shfl_xor_sync(0xFFFFFFFFu, s.w, o);
    }
    if ((wtid & 31) == 0)
      reinterpret_cast<float4*>(part + PassA<T>::SCRATCH_HEADS)[wtid >> 5] =
          s;
  }
  // d_hv of the last view layer = g @ w_rgb^T, into the view tile the
  // forward's last view layer did not write
  int dv = NV & 1;
  heads_fma<NRV, false>(acc, gin, row0, n_pts,
                        wmat(net, SLOT_WRGB) + cv * HEADS, wtid);
  {
    uint32_t m[MV];
    get_bits<MV>(vmasks + 512 * MV * (NV - 1), m, wtid);
    grad_store<NRV>(acc, hv_g[dv] + sv, m, part, wtid);
  }
  mb.ready();
  mb.put(hv_g[dv] + sv, PL_H + 2 * D + NV + NV - 1, WV, sv, HV_BYTES);
  mb.post();
  if (mb.live) {
    bias_row<NRV>(part, brow + D * W + (NV - 1) * WV + cv, wtid);
    if (wg == 0 && wtid < HEADS) {
      const float* ph = part + PassA<T>::SCRATCH_HEADS;
      brow[D * W + NV * WV + wtid] = wtid < 4 ? ph[wtid] + ph[4 + wtid] : 0.f;
    }
  }
  for (int v = NV - 1; v >= 1; --v) {  // d_hv(v - 1) = dv(v) @ WV_v^T
    prod<NRV, T::KC_V>(acc, r, hv[dv], WV, true, boff);
    ring_drain(r);
    dv ^= 1;
    mb.reuse();
    uint32_t m[MV];
    get_bits<MV>(vmasks + 512 * MV * (v - 1), m, wtid);
    grad_store<NRV>(acc, hv_g[dv] + sv, m, part, wtid);
    mb.ready();
    mb.put(hv_g[dv] + sv, PL_H + 2 * D + NV + v - 1, WV, sv, HV_BYTES);
    mb.post();
    if (mb.live) bias_row<NRV>(part, brow + D * W + (v - 1) * WV + cv, wtid);
  }
  // d_h of the last trunk layer = dv(0) @ WV_0^T + g @ w_alpha^T
  prod<NRW, T::KC_W>(acc, r, hv[dv], WV, true, boff);
  ring_drain(r);
  heads_fma<NRW, true>(acc, gin, row0, n_pts,
                       wmat(net, SLOT_WALPHA) + cw * HEADS, wtid);
  int dc = hl;
  for (int i = D - 1; i >= 0; --i) {  // d_h(i - 1) = dc(i) @ W_i^T
    mb.reuse();
    uint32_t m[MW];
    get_bits<MW>(masks + 512 * MW * i, m, wtid);
    grad_store<NRW>(acc, h_g[dc] + sw, m, part, wtid);
    mb.ready();
    mb.put(h_g[dc] + sw, PL_H + D + NV + i, W, sw, HW_BYTES);
    mb.post();
    if (mb.live) bias_row<NRW>(part, brow + i * W + cw, wtid);
    if (i > 0) {
      prod<NRW, T::KC_W>(acc, r, h[dc], W, true, boff);
      ring_drain(r);
      dc ^= 1;
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

template <class T>
__global__ void __launch_bounds__(A_THREADS, 1)
k_grad_pass_a(Net net, const __grid_constant__ Planes pl,
              const bf16* __restrict__ wstream, int n_stages,
              const float* __restrict__ pts, const float* __restrict__ dirs,
              const float* __restrict__ gin, bf16* __restrict__ planes,
              float* __restrict__ bias, int N, int tiles_per_block,
              int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const int m_bytes = mask_bytes<T>(net.depth, net.n_views);
  const Chain c =
      chain_begin(smem_raw, n_ring, PassA<T>::TILES + 2 * m_bytes, 1);
  const int p0 = blockIdx.x * tiles_per_block * T::DT;
  const int n_pts = min(tiles_per_block * T::DT, N - p0);
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
  const int n_tiles = (n_pts + T::DT - 1) / T::DT;
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
    const PointTile<false, T> src{pts + static_cast<size_t>(p0) * 3,
                                  dirs + static_cast<size_t>(p0) * 3,
                                  nullptr};
    Ring ring{c.base, c.bars, static_cast<uint32_t>(n_ring), 0, NO_STAGE};
    uint32_t posts = 0;
    const float* g = gin + static_cast<size_t>(p0) * 4;
    if constexpr (T::kSplit) {
      char* tiles = c.gbase + n_ring * STAGE_BYTES;
      char* masks = tiles + T::TILES + wg * m_bytes;
      for (int t0 = 0; t0 < n_pts; t0 += T::DT)
        pass_a_tile_split(net, pl, src, g, planes, bias, ring, tiles, masks,
                          mail[wg], mbars + 8 * wg, mbars + 16 + 8 * wg,
                          posts, t0, n_pts, p0 / GP, wg, wtid);
    } else {
      // a warpgroup's tiles, then its relu' bits
      char* tiles =
          c.gbase + n_ring * STAGE_BYTES + wg * (T::WG_BYTES + m_bytes);
      for (int t0 = 0; t0 < n_pts; t0 += T::DT)
        pass_a_tile(net, pl, src, g, planes, bias, ring, tiles, mail[wg],
                    mbars + 8 * wg, mbars + 16 + 8 * wg, posts, t0, n_pts,
                    p0 / GP, wg, wtid);
    }
  }
  __syncthreads();
}

// ---- pass B: long-K weight-gradient products on wgmma

constexpr int BSTAGES = 6;
constexpr int BSTAGE_BYTES = 2 * 2 * 64 * GP * 2;  // X and Y, 128 lanes each
constexpr int B_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr size_t B_SMEM = 1024 + BSTAGES * BSTAGE_BYTES + 2 * BSTAGES * 8;
// output tiles of both second passes at most: 160 at W <= 256; at W=512
// 224, which covers depth 12 (pass A's deepest there) with four skip
// layers, and keeps the table, a kernel parameter, within 4 KB
template <class T>
constexpr int max_tasks() {
  return T::W > 256 ? 224 : 160;
}

// One output tile of one gradient dW = X^T @ Y (rows x cols at float
// offset off): X from plane xp (xw x 64 lanes), Y from plane yp; rows
// 64*mb .. 64*(mb+mw), columns 64*nb .. 64*(nb+nw).
struct BTask {
  unsigned char xp, yp, xw, yw, mb, nb, mw, nw;
  unsigned short rows, cols;
  int off;
};

template <int MAXT>
struct BTable {
  long long plane[MAXPLANES];
  BTask task[MAXT];
};


template <class T>
__global__ void __launch_bounds__(B_THREADS, 1)
k_grad_pass_b(const __grid_constant__ BTable<max_tasks<T>()> tb,
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
template <class T>
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
  constexpr int W = T::W, WV = T::WV;
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

// The tiles of gradient dW = X^T @ Y (rows x cols at float offset off),
// at most maxt in all.
static bool add_tasks(BTask* task, int maxt, int* n, int xp, int xw, int yp,
                      int yw, int rows, int cols, long long off) {
  for (int mb = 0; mb < xw; mb += 2)
    for (int nb = 0; nb < yw; nb += 2) {
      if (*n >= maxt || off < 0) return false;
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

// The chunks' bias partials from the per-tile bias rows, then out = the
// partials summed in chunk order (both variants' last two kernels).
template <class T>
static int finish(const float* bias, int NB, int n_tiles, int n_chunks,
                  const long long* grad_offsets, int D, int NV,
                  float* partials, float* out, long long G, cudaStream_t s) {
  GradTable gt;
  for (int i = 0; i < NSLOTS; ++i) gt.off[i] = grad_offsets[i];
  k_bias_partials<T><<<dim3((NB + 255) / 256, n_chunks), 256, 0, s>>>(
      bias, NB, n_tiles, n_chunks, gt, D, NV, partials, G);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(partials, out, G, n_chunks, s);
}

// ------------------------------------------------ f32, two passes
//
// The f32 operand buffer: plane j is row-major, tiles * GP rows of F_j
// floats at float offset off[j] (kernels/fused_mlp_grad.py:
// grad_planes_f32), with the bf16 buffer's plane indices and F_j =
// PE_PAD, PED_PAD, HEADS for PE, PED, GB, then W or WV. Pass A writes every
// row of every tile, rows past N from zero inputs and a zero cotangent, so
// their d_h rows are zero and pass B reads whole tiles.

// ---- pass A f32: the recompute and the d_h chain on FFMAs

constexpr int F_CONSUMERS = 256;               // 8 consumer warps
constexpr int F_THREADS = F_CONSUMERS + 32;    // + the producer warp
constexpr int F_BAR = 1;                       // the consumers' barrier
static_assert(CONSUMER_WARPS == F_CONSUMERS / 32 && NWARP == 8,
              "each consumer warp releases a stage once");

// Pass A f32's layout at widths T. A consumer thread holds 8 rows (warp w:
// 8 w..) of CPL = width / 32 columns of a layer (lane l: 128 c + 4 l + q,
// q < 4; 2 l + q, q < 2, in a 64-wide layer), column j = 4 c + q of its
// accumulator, and one relu' bit per value.
template <class T>
struct F32 {
  static constexpr int KW = F_STAGE / T::W, KV = F_STAGE / T::WV;  // K-rows
  static constexpr int AC = T::W / 32;  // accumulator columns a thread
  // 64-bit relu' words a thread per trunk / view layer
  static constexpr int NBW = (T::W / 4 + 63) / 64, NBV = (T::WV / 4 + 63) / 64;
  // W=512: the column sums' scratch (8 warps x W) lies over the PE and
  // dir-PE tiles, which only the forward reads; on a tile of its own the
  // block would pass the shared memory
  static constexpr bool kPartInPe = T::W > 256;
  // activation tile, PE, dir-PE and the scratch
  static constexpr size_t TILE_BYTES =
      4 * (GP * T::W + GP * PE_PAD + GP * PED_PAD +
           (kPartInPe ? 0 : NWARP * T::W));
  static_assert(!kPartInPe || NWARP * T::W <= GP * (PE_PAD + PED_PAD),
                "the scratch fits the PE tiles");
};

// relu' bits of the trunk's layers, then the view branch's
template <class T>
__host__ __device__ inline size_t f32_mask_bytes(int depth, int n_views) {
  return 8 * F_CONSUMERS *
         static_cast<size_t>(F32<T>::NBW * depth + F32<T>::NBV * n_views);
}

// 1,024 bytes to align the base, the ring, the tiles, the relu' bits, then
// the ring's mbarriers.
template <class T>
__host__ __device__ inline size_t pass_a_f32_smem_bytes(int n_ring,
                                                        int depth,
                                                        int n_views) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES +
         F32<T>::TILE_BYTES + f32_mask_bytes<T>(depth, n_views) +
         16 * MAX_RING;
}

// Stages of pass A f32's weight stream per tile: layer 0, each later
// layer's skip pe-part then its h-part, view layer 0's h-part and dir-PE
// part (its rows padded to a stage), the later view layers; then WV_v^T
// for v = NV-1..1, WV_0^T's h-part and W_i^T for i = D-1..1 (265 for the
// paper model at W=256).
template <class T>
inline int f32_stages(const unsigned long long* slots, int depth,
                      int n_views) {
  constexpr int KW = F32<T>::KW, KV = F32<T>::KV;
  constexpr int W = T::W, WV = T::WV;
  constexpr int v = (WV + KV - 1) / KV, dir = (PED_PAD + KV - 1) / KV;
  int n = PE_PAD / KW;
  for (int i = 1; i < depth; ++i)
    n += W / KW + (slots[SLOT_WSKIP + i] ? PE_PAD / KW : 0);
  n += W / KV + dir + (n_views - 1) * v;
  return n + (n_views - 1) * v + WV / KW + (depth - 1) * (W / KW);
}

// A thread's relu' bits of one layer
template <int N>
struct Bits {
  unsigned long long w[N];
};

// Column j of a thread's CPL columns of a WIDTH-wide row (lane l)
template <int WIDTH>
__device__ __forceinline__ int fcol(int j, int l) {
  return WIDTH >= 128 ? 128 * (j >> 2) + 4 * l + (j & 3) : 2 * l + j;
}

// The forward's epilogue of a layer of WIDTH columns: h = relu(acc + bias)
// into the activation tile and to the plane rows at dst (both row-major,
// WIDTH floats a row; streaming stores to dst) -> the relu' bits, bit CPL
// i + j for acc[i][j]. acc ends zeroed.
template <int WIDTH, int AC>
__device__ __forceinline__ Bits<(WIDTH / 4 + 63) / 64> fwd_store(
    float (&acc)[8][AC], const float* __restrict__ bias, float* act,
    float* __restrict__ dst, int w, int l) {
  constexpr int CPL = WIDTH / 32;
  Bits<(WIDTH / 4 + 63) / 64> bits = {};
  if constexpr (WIDTH >= 128) {
    constexpr int NC = CPL / 4;
    float4 b[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      b[c] = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * l));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 h = make_float4(fmaxf(acc[i][4 * c] + b[c].x, 0.f),
                                     fmaxf(acc[i][4 * c + 1] + b[c].y, 0.f),
                                     fmaxf(acc[i][4 * c + 2] + b[c].z, 0.f),
                                     fmaxf(acc[i][4 * c + 3] + b[c].w, 0.f));
        const unsigned long long m =
            (h.x > 0.f ? 1ull : 0ull) | (h.y > 0.f ? 2ull : 0ull) |
            (h.z > 0.f ? 4ull : 0ull) | (h.w > 0.f ? 8ull : 0ull);
        const int bit = CPL * i + 4 * c;
        bits.w[bit >> 6] |= m << (bit & 63);
        const int off = (8 * w + i) * WIDTH + 128 * c + 4 * l;
        *reinterpret_cast<float4*>(act + off) = h;
        __stcs(reinterpret_cast<float4*>(dst + off), h);
        acc[i][4 * c] = acc[i][4 * c + 1] = 0.f;
        acc[i][4 * c + 2] = acc[i][4 * c + 3] = 0.f;
      }
  } else {
    static_assert(WIDTH == 64, "a layer is 64, 128, 256 or 512 wide");
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 2 * l));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 h = make_float2(fmaxf(acc[i][0] + b.x, 0.f),
                                   fmaxf(acc[i][1] + b.y, 0.f));
      const unsigned long long m =
          (h.x > 0.f ? 1ull : 0ull) | (h.y > 0.f ? 2ull : 0ull);
      bits.w[0] |= m << (CPL * i);
      const int off = (8 * w + i) * WIDTH + 2 * l;
      *reinterpret_cast<float2*>(act + off) = h;
      __stcs(reinterpret_cast<float2*>(dst + off), h);
      acc[i][0] = acc[i][1] = 0.f;
    }
  }
  return bits;
}

// The backward's epilogue of a layer of WIDTH columns: d = acc masked by
// the relu' bits into the activation tile (the next product's A) and to the
// plane rows at dst; brow[0, WIDTH) = the column sums of d, each thread's
// 8 rows in order, then the 8 warps in order through part. acc ends
// zeroed. The caller has passed the barrier after the tile's last reads;
// the barrier here publishes the tile and part.
template <int WIDTH, int AC, int NB>
__device__ __forceinline__ void bwd_store(float (&acc)[8][AC],
                                          const Bits<NB>& bits, float* act,
                                          float* __restrict__ dst,
                                          float* part,
                                          float* __restrict__ brow, int w,
                                          int l, int tid) {
  constexpr int CPL = WIDTH / 32;
  float s[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) s[j] = 0.f;
  if constexpr (WIDTH >= 128) {
    constexpr int NC = CPL / 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int bit = CPL * i + 4 * c;
        const unsigned long long u = bits.w[bit >> 6] >> (bit & 63);
        const float4 d =
            make_float4(u & 1ull ? acc[i][4 * c] : 0.f,
                        (u >> 1) & 1ull ? acc[i][4 * c + 1] : 0.f,
                        (u >> 2) & 1ull ? acc[i][4 * c + 2] : 0.f,
                        (u >> 3) & 1ull ? acc[i][4 * c + 3] : 0.f);
        s[4 * c] += d.x;
        s[4 * c + 1] += d.y;
        s[4 * c + 2] += d.z;
        s[4 * c + 3] += d.w;
        const int off = (8 * w + i) * WIDTH + 128 * c + 4 * l;
        *reinterpret_cast<float4*>(act + off) = d;
        __stcs(reinterpret_cast<float4*>(dst + off), d);
        acc[i][4 * c] = acc[i][4 * c + 1] = 0.f;
        acc[i][4 * c + 2] = acc[i][4 * c + 3] = 0.f;
      }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(part + w * WIDTH + 128 * c + 4 * l) =
          make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned long long u = bits.w[0] >> (CPL * i);
      const float2 d = make_float2(u & 1ull ? acc[i][0] : 0.f,
                                   (u >> 1) & 1ull ? acc[i][1] : 0.f);
      s[0] += d.x;
      s[1] += d.y;
      const int off = (8 * w + i) * WIDTH + 2 * l;
      *reinterpret_cast<float2*>(act + off) = d;
      __stcs(reinterpret_cast<float2*>(dst + off), d);
      acc[i][0] = acc[i][1] = 0.f;
    }
    *reinterpret_cast<float2*>(part + w * WIDTH + 2 * l) =
        make_float2(s[0], s[1]);
  }
  named_barrier(F_BAR, F_CONSUMERS);
  for (int col = tid; col < WIDTH; col += F_CONSUMERS) {
    float t = part[col];
#pragma unroll
    for (int v = 1; v < NWARP; ++v) t += part[v * WIDTH + col];
    brow[col] = t;
  }
}

// acc[i][j] (+)= g[8 w + i] . wh[col j][0:4]: the heads' K = 4 products
// with the f32 cotangent g (the tile's rows; rows at or past n are zero);
// wh is (WIDTH, HEADS) f32, of which the first 4 lanes count.
template <int WIDTH, bool ADD, int AC>
__device__ __forceinline__ void fheads(float (&acc)[8][AC],
                                       const float* __restrict__ g, int n,
                                       const float* __restrict__ wh, int w,
                                       int l) {
  float4 gr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    gr[i] = 8 * w + i < n
                ? __ldg(reinterpret_cast<const float4*>(g) + 8 * w + i)
                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < WIDTH / 32; ++j) {
    const float4 u = __ldg(
        reinterpret_cast<const float4*>(wh + fcol<WIDTH>(j, l) * HEADS));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d = gr[i].x * u.x;
      d = fmaf(gr[i].y, u.y, d);
      d = fmaf(gr[i].z, u.z, d);
      d = fmaf(gr[i].w, u.w, d);
      float& a = acc[i][j];
      a = ADD ? a + d : d;
    }
  }
}

// The block's shared memory past the ring.
struct FTiles {
  float* act;                // (GP, W): the A operand, row-major
  float* pe;                 // (GP, PE_PAD)
  float* ped;                // (GP, PED_PAD)
  float* part;               // (NWARP, W) column sums of each warp
  unsigned long long* mask;  // relu' bits: per layer NB words x F_CONSUMERS
};

template <int NB>
__device__ __forceinline__ void put_fbits(unsigned long long* mask, int slot,
                                          const Bits<NB>& b, int tid) {
#pragma unroll
  for (int k = 0; k < NB; ++k) mask[(slot + k) * F_CONSUMERS + tid] = b.w[k];
}
template <int NB>
__device__ __forceinline__ Bits<NB> get_fbits(const unsigned long long* mask,
                                              int slot, int tid) {
  Bits<NB> b;
#pragma unroll
  for (int k = 0; k < NB; ++k) b.w[k] = mask[(slot + k) * F_CONSUMERS + tid];
  return b;
}

// Pass A f32 on the 64-point tile `tile` (its n = min(GP, N - p0) points
// from p0): inputs, the forward, then d_h back through the heads, the view
// branch and the trunk; every plane's rows of the tile and its bias row.
template <class T>
__device__ __forceinline__ void pass_a_f32_tile(
    const Net& net, const Planes& pl, FRing& r, const FTiles& sm,
    const float* __restrict__ pts, const float* __restrict__ dirs,
    const float* __restrict__ gin, float* __restrict__ planes,
    float* __restrict__ bias, int tile, int N, int tid) {
  using L = F32<T>;
  constexpr int W = T::W, WV = T::WV, NBW = L::NBW, NBV = L::NBV;
  const int D = net.depth, NV = net.n_views;
  const int w = tid >> 5, l = tid & 31;
  const int p0 = tile * GP, n = min(GP, N - p0);
  const int HV = PL_H + D, DC = PL_H + D + NV, DV = DC + D;
  auto plane = [&](int j, int width) {
    return planes + pl.off[j] + static_cast<size_t>(p0) * width;
  };
  const float* g = gin + static_cast<size_t>(p0) * 4;
  float* brow = bias + static_cast<size_t>(tile) * (D * W + NV * WV + HEADS);
  // the last tile's column sums over the PE tiles are read
  if constexpr (L::kPartInPe) named_barrier(F_BAR, F_CONSUMERS);

  // ---- inputs: PE, dir-PE and the cotangent's plane (zero past N)
  for (int e = tid; e < GP * PE_PAD; e += F_CONSUMERS) {
    const int row = e / PE_PAD, k = e - row * PE_PAD;
    const float v = row < n ? pe_lane(pts + static_cast<size_t>(p0 + row) * 3,
                                      k, net.multires)
                            : 0.f;
    sm.pe[e] = v;
    __stcs(plane(PL_PE, PE_PAD) + e, v);
  }
  for (int e = tid; e < GP * PED_PAD; e += F_CONSUMERS) {
    const int row = e / PED_PAD, k = e - row * PED_PAD;
    const float v =
        row < n ? pe_lane(dirs + static_cast<size_t>(p0 + row) * 3, k,
                          net.multires_views)
                : 0.f;
    sm.ped[e] = v;
    __stcs(plane(PL_PED, PED_PAD) + e, v);
  }
  for (int e = tid; e < GP * HEADS; e += F_CONSUMERS) {
    const int row = e / HEADS, c = e - row * HEADS;
    __stcs(plane(PL_GB, HEADS) + e, row < n && c < 4 ? g[row * 4 + c] : 0.f);
  }
  if (tid < HEADS) {  // b_heads: the column sums of the cotangent
    float s = 0.f;
    for (int row = 0; row < n && tid < 4; ++row) s += g[row * 4 + tid];
    brow[D * W + NV * WV + tid] = s;
  }
  named_barrier(F_BAR, F_CONSUMERS);

  float acc[8][L::AC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < L::AC; ++j) acc[i][j] = 0.f;

  // ---- forward: the skip layers' PE product before their h product
  for (int i = 0; i < D; ++i) {
    if (i == 0 || net.slot[SLOT_WSKIP + i] != nullptr)
      fprod_w<W>(acc, r, sm.pe, PE_PAD, PE_PAD, w, l);
    if (i > 0) fprod_w<W>(acc, r, sm.act, W, W, w, l);
    named_barrier(F_BAR, F_CONSUMERS);
    put_fbits(sm.mask, NBW * i,
              fwd_store<W>(acc, fvec(net, SLOT_B + i), sm.act,
                           plane(PL_H + i, W), w, l),
              tid);
    named_barrier(F_BAR, F_CONSUMERS);
  }
  for (int v = 0; v < NV; ++v) {  // view layer 0 adds the dir-PE product
    fprod_w<WV>(acc, r, sm.act, v == 0 ? W : WV, v == 0 ? W : WV, w, l);
    if (v == 0)
      fprod_w<WV, 8, (L::KV < PED_PAD ? L::KV : PED_PAD)>(
          acc, r, sm.ped, PED_PAD, PED_PAD, w, l);
    named_barrier(F_BAR, F_CONSUMERS);
    put_fbits(sm.mask, NBW * D + NBV * v,
              fwd_store<WV>(acc, fvec(net, SLOT_BV + v), sm.act,
                            plane(HV + v, WV), w, l),
              tid);
    named_barrier(F_BAR, F_CONSUMERS);
  }

  // ---- backward: d_hv of the last view layer = g @ w_rgb^T
  fheads<WV, false>(acc, g, n, fvec(net, SLOT_WRGB), w, l);
  bwd_store<WV>(acc, get_fbits<NBV>(sm.mask, NBW * D + NBV * (NV - 1), tid),
                sm.act, plane(DV + NV - 1, WV), sm.part,
                brow + D * W + (NV - 1) * WV, w, l, tid);
  for (int v = NV - 1; v >= 1; --v) {  // d_hv(v - 1) = dv(v) @ WV_v^T
    fprod_w<WV>(acc, r, sm.act, WV, WV, w, l);
    named_barrier(F_BAR, F_CONSUMERS);
    bwd_store<WV>(acc,
                  get_fbits<NBV>(sm.mask, NBW * D + NBV * (v - 1), tid),
                  sm.act, plane(DV + v - 1, WV), sm.part,
                  brow + D * W + (v - 1) * WV, w, l, tid);
  }
  // d_h of the last trunk layer = dv(0) @ WV_0^T + g @ w_alpha^T
  fprod_w<W>(acc, r, sm.act, WV, WV, w, l);
  fheads<W, true>(acc, g, n, fvec(net, SLOT_WALPHA), w, l);
  for (int i = D - 1; i >= 0; --i) {  // d_h(i - 1) = dc(i) @ W_i^T
    named_barrier(F_BAR, F_CONSUMERS);
    bwd_store<W>(acc, get_fbits<NBW>(sm.mask, NBW * i, tid), sm.act,
                 plane(DC + i, W), sm.part, brow + i * W, w, l, tid);
    if (i > 0) fprod_w<W>(acc, r, sm.act, W, W, w, l);
  }
}

template <class T>
__global__ void __launch_bounds__(F_THREADS, 1)
k_grad_pass_a_f32(Net net, const __grid_constant__ Planes pl,
                  const float* __restrict__ wstream, int n_stages,
                  const float* __restrict__ pts,
                  const float* __restrict__ dirs,
                  const float* __restrict__ gin, float* __restrict__ planes,
                  float* __restrict__ bias, int N, int tiles_per_block,
                  int n_ring) {
  using L = F32<T>;
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* gbase = smem_raw + (base - raw);
  const int D = net.depth, NV = net.n_views;
  FTiles sm;
  sm.act = reinterpret_cast<float*>(gbase + n_ring * STAGE_BYTES);
  sm.pe = sm.act + GP * T::W;
  sm.ped = sm.pe + GP * PE_PAD;
  sm.part = L::kPartInPe ? sm.pe : sm.ped + GP * PED_PAD;
  sm.mask = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<char*>(sm.act) + L::TILE_BYTES);
  const Chain c{base,
                base + static_cast<uint32_t>(n_ring * STAGE_BYTES +
                                             L::TILE_BYTES +
                                             f32_mask_bytes<T>(D, NV)),
                gbase, n_ring};
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_ring; ++s) {
      mbar_init(c.bars + 8 * s, 1);
      mbar_init(c.bars + 8 * (MAX_RING + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (N + GP - 1) / GP;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  if (threadIdx.x >= F_CONSUMERS) {  // thread 256 streams the weights
    chain_produce(c, reinterpret_cast<const bf16*>(wstream), n_stages,
                  t1 - t0);
  } else {
    FRing r{gbase, c.bars, static_cast<uint32_t>(n_ring), 0u};
    for (int t = t0; t < t1; ++t)
      pass_a_f32_tile<T>(net, pl, r, sm, pts, dirs, gin, planes, bias, t, N,
                         threadIdx.x);
  }
  __syncthreads();
}

// ---- pass B f32: long-K weight-gradient products on FFMAs

constexpr int FB_TILE = 128;   // output tile rows and columns
constexpr int FB_PTS = 32;     // points per stage
constexpr int FB_STAGES = 3;   // cp.async ring depth
constexpr int FB_THREADS = 256;
constexpr int FB_STAGE = 2 * FB_PTS * FB_TILE;  // floats: X then Y
constexpr size_t FB_SMEM = static_cast<size_t>(FB_STAGES) * FB_STAGE * 4;
static_assert(GP % FB_PTS == 0, "a stage holds whole points of one tile");

// One 128 x 128 output tile of dW = X^T @ Y, the gradient of xw x yw
// floats at float offset off: X's columns m0.., Y's columns n0.. (X from
// plane xp of xw floats a row, Y from plane yp of yw).
struct FTask {
  unsigned char xp, yp;
  unsigned short xw, yw, m0, n0;
  int off;
};

template <int MAXT>
struct FTable {
  long long plane[MAXPLANES];
  FTask task[MAXT];
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Block (task, chunk): the chunk's points in stages of FB_PTS, each
// thread's 8 x 8 block (rows 4 ty.. and 64 + 4 ty.., columns 4 tx.. and
// 64 + 4 tx..) summed over the points in order, then written to the
// chunk's partial. Columns past a plane's width load as zeros and are not
// stored.
template <class T>
__global__ void __launch_bounds__(FB_THREADS, 2)
k_grad_pass_b_f32(const __grid_constant__ FTable<max_tasks<T>()> tb,
                  const float* __restrict__ planes,
                  float* __restrict__ partials, long long G, int n_tiles,
                  int n_chunks) {
  extern __shared__ __align__(16) float fsm[];
  const FTask t = tb.task[blockIdx.x];
  const int chunk = blockIdx.y;
  const int c0 = static_cast<int>(static_cast<long long>(chunk) * n_tiles /
                                  n_chunks);
  const int c1 = static_cast<int>(static_cast<long long>(chunk + 1) *
                                  n_tiles / n_chunks);
  const int nk = (c1 - c0) * (GP / FB_PTS);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rows = min(FB_TILE, static_cast<int>(t.xw) - t.m0);
  const int cols = min(FB_TILE, static_cast<int>(t.yw) - t.n0);
  // thread tid copies lane chunk q of points r + 8 j (j < 4) of a stage,
  // of X and of Y; chunks past a plane's width are zero-filled
  const int q = tid & 31, r = tid >> 5;
  const bool okx = 4 * q < rows, oky = 4 * q < cols;
  const float* gx = planes + tb.plane[t.xp] +
                    (static_cast<size_t>(c0) * GP + r) * t.xw + t.m0 +
                    (okx ? 4 * q : 0);
  const float* gy = planes + tb.plane[t.yp] +
                    (static_cast<size_t>(c0) * GP + r) * t.yw + t.n0 +
                    (oky ? 4 * q : 0);
  const size_t sx = static_cast<size_t>(8) * t.xw;
  const size_t sy = static_cast<size_t>(8) * t.yw;
  const uint32_t sdst = smem_addr(fsm) + 16 * (r * (FB_TILE / 4) + q);
  auto load = [&](int k) {  // stage k into slot k % FB_STAGES
    if (k < nk) {
      const uint32_t d = sdst + 4 * (k % FB_STAGES) * FB_STAGE;
      const float* x = gx + 4 * static_cast<size_t>(k) * sx;
      const float* y = gy + 4 * static_cast<size_t>(k) * sy;
#pragma unroll
      for (int j = 0; j < FB_PTS / 8; ++j) {
        cp_async16(d + 4 * 8 * j * FB_TILE, x + j * sx, okx);
        cp_async16(d + 4 * (FB_PTS + 8 * j) * FB_TILE, y + j * sy, oky);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int k = 0; k < FB_STAGES - 1; ++k) load(k);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<FB_STAGES - 2>();
    __syncthreads();  // stage k in; every thread done with stage k - 1
    load(k + FB_STAGES - 1);
    const float* xs = fsm + (k % FB_STAGES) * FB_STAGE;
    const float* ys = xs + FB_PTS * FB_TILE;
#pragma unroll 4
    for (int p = 0; p < FB_PTS; ++p) {
      const float4 x0 =
          *reinterpret_cast<const float4*>(xs + p * FB_TILE + 4 * ty);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xs + p * FB_TILE + 64 + 4 * ty);
      const float4 y0 =
          *reinterpret_cast<const float4*>(ys + p * FB_TILE + 4 * tx);
      const float4 y1 =
          *reinterpret_cast<const float4*>(ys + p * FB_TILE + 64 + 4 * tx);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* out = partials + chunk * G + t.off;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < cols)
        out[static_cast<size_t>(t.m0 + row) * t.yw + t.n0 + col] = acc[i][j];
    }
  }
}

// The 128 x 128 tiles of dW = X^T @ Y (xw x yw floats at offset off), at
// most maxt in all.
static bool add_ftasks(FTask* task, int maxt, int* n, int xp, int xw, int yp,
                       int yw, long long off) {
  for (int m0 = 0; m0 < xw; m0 += FB_TILE)
    for (int n0 = 0; n0 < yw; n0 += FB_TILE) {
      if (*n >= maxt || off < 0) return false;
      FTask& t = task[(*n)++];
      t.xp = static_cast<unsigned char>(xp);
      t.yp = static_cast<unsigned char>(yp);
      t.xw = static_cast<unsigned short>(xw);
      t.yw = static_cast<unsigned short>(yw);
      t.m0 = static_cast<unsigned short>(m0);
      t.n0 = static_cast<unsigned short>(n0);
      t.off = static_cast<int>(off);
    }
  return true;
}

// The host side of the four kernels, each: check, set the shared
// memory, launch; -> the CUDA error.

// bf16 pass A. planes: the operand buffer (plane_off, bf16 elements, as
// kernels/fused_mlp_grad.py:grad_planes); bias: (tiles of 64 points, NB)
// f32; wstream: n_stages stages of the net's pass-A weight stream (16-byte
// aligned); blocks of tiles_per_block tiles of DT points; n_ring: stages of
// the shared-memory ring (2..MAX_RING).
template <class T>
int grad_pass_a(const float* pts, const float* dirs, const float* g,
                void* planes, const long long* plane_off, float* bias, int N,
                int tiles_per_block, const unsigned long long* slots,
                int depth, int n_views, int multires, int multires_views,
                const void* wstream, int n_stages, int n_ring, void* stream) {
  if (tiles_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = pass_a_smem_bytes<T>(n_ring, depth, n_views);
  // the forward trades the heads' stages for the dir-PE stage
  cudaError_t err = chain_prepare(
      k_grad_pass_a<T>, bytes,
      chain_stages<T>(slots, depth, n_views) - T::HEAD_STAGES + 1 +
          grad_back_stages<T>(depth, n_views),
      n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net = make_net(slots, depth, n_views, multires, multires_views, 0);
  Planes pl;
  const int n_planes = 3 + 2 * depth + 2 * n_views;
  for (int i = 0; i < MAXPLANES; ++i)
    pl.off[i] = i < n_planes ? plane_off[i] : 0;
  const int tiles = (N + T::DT - 1) / T::DT;
  const int grid = (tiles + tiles_per_block - 1) / tiles_per_block;
  k_grad_pass_a<T><<<grid, A_THREADS, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      net, pl, static_cast<const bf16*>(wstream), n_stages, pts, dirs, g,
      static_cast<bf16*>(planes), bias, N, tiles_per_block, n_ring);
  return static_cast<int>(cudaGetLastError());
}

// bf16 pass B: partials (n_chunks, G) f32 (every gradient's region is
// written), out (G,) f32 = the partials summed in chunk order.
template <class T>
int grad_pass_b(const void* planes, const long long* plane_off,
                const float* bias, int NB, float* partials, float* out,
                long long G, int n_tiles, int n_chunks,
                const long long* grad_offsets, int depth, int n_views,
                void* stream) {
  constexpr int W = T::W, WV = T::WV, MAXT = max_tasks<T>();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = depth, NV = n_views;
  BTable<MAXT> tb;
  const int n_planes = 3 + 2 * D + 2 * NV;
  for (int i = 0; i < MAXPLANES; ++i)
    tb.plane[i] = i < n_planes ? plane_off[i] : 0;
  const int H = PL_H, HV = PL_H + D, DC = PL_H + D + NV, DV = DC + D;
  const int w = W / 64, wv = WV / 64, pe = PE_PAD / 64, ln = LANES / 64;
  const long long* go = grad_offsets;
  BTask* t = tb.task;
  int n = 0;
  bool ok = add_tasks(t, MAXT, &n, PL_PE, pe, DC, w, PE_PAD, W, go[SLOT_W]);
  for (int i = 1; i < D; ++i) {
    ok = ok && add_tasks(t, MAXT, &n, H + i - 1, w, DC + i, w, W, W,
                         go[SLOT_W + i]);
    if (go[SLOT_WSKIP + i] >= 0)
      ok = ok && add_tasks(t, MAXT, &n, PL_PE, pe, DC + i, w, PE_PAD, W,
                           go[SLOT_WSKIP + i]);
  }
  ok = ok &&
       add_tasks(t, MAXT, &n, H + D - 1, w, DV, wv, W, WV, go[SLOT_WV]);
  ok = ok && add_tasks(t, MAXT, &n, PL_PED, ln, DV, wv, PED_PAD, WV,
                       go[SLOT_WV0D]);
  for (int v = 1; v < NV; ++v)
    ok = ok && add_tasks(t, MAXT, &n, HV + v - 1, wv, DV + v, wv, WV, WV,
                         go[SLOT_WV + v]);
  ok = ok && add_tasks(t, MAXT, &n, H + D - 1, w, PL_GB, ln, W, HEADS,
                       go[SLOT_WALPHA]);
  ok = ok && add_tasks(t, MAXT, &n, HV + NV - 1, wv, PL_GB, ln, WV, HEADS,
                       go[SLOT_WRGB]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = prepare(k_grad_pass_b<T>, B_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_grad_pass_b<T><<<dim3(n, n_chunks), B_THREADS, B_SMEM, s>>>(
      tb, static_cast<const bf16*>(planes), partials, G, n_tiles, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish<T>(bias, NB, n_tiles, n_chunks, grad_offsets, D, NV,
                   partials, out, G, s);
}

// f32 pass A. planes: the f32 operand buffer (plane_off, float offsets, as
// kernels/fused_mlp_grad.py:grad_planes_f32); bias: (tiles of 64 points,
// NB) f32; wstream: n_stages stages of the net's f32 weight stream
// (grad_weight_stream_f32, 16-byte aligned); blocks of tiles_per_block
// 64-point tiles; n_ring: stages of the shared-memory ring (2..MAX_RING).
template <class T>
int grad_pass_a_f32(const float* pts, const float* dirs, const float* g,
                    void* planes, const long long* plane_off, float* bias,
                    int N, int tiles_per_block,
                    const unsigned long long* slots, int depth, int n_views,
                    int multires, int multires_views, const void* wstream,
                    int n_stages, int n_ring, void* stream) {
  if (tiles_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = pass_a_f32_smem_bytes<T>(n_ring, depth, n_views);
  cudaError_t err =
      chain_prepare(k_grad_pass_a_f32<T>, bytes,
                    f32_stages<T>(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net = make_net(slots, depth, n_views, multires, multires_views, 0);
  Planes pl;
  const int n_planes = 3 + 2 * depth + 2 * n_views;
  for (int i = 0; i < MAXPLANES; ++i)
    pl.off[i] = i < n_planes ? plane_off[i] : 0;
  const int tiles = (N + GP - 1) / GP;
  const int grid = (tiles + tiles_per_block - 1) / tiles_per_block;
  k_grad_pass_a_f32<T><<<grid, F_THREADS, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      net, pl, static_cast<const float*>(wstream), n_stages, pts, dirs, g,
      static_cast<float*>(planes), bias, N, tiles_per_block, n_ring);
  return static_cast<int>(cudaGetLastError());
}

// f32 pass B: partials (n_chunks, G) f32 (every gradient's region is
// written), out (G,) f32 = the partials summed in chunk order.
template <class T>
int grad_pass_b_f32(const void* planes, const long long* plane_off,
                    const float* bias, int NB, float* partials, float* out,
                    long long G, int n_tiles, int n_chunks,
                    const long long* grad_offsets, int depth, int n_views,
                    void* stream) {
  constexpr int W = T::W, WV = T::WV, MAXT = max_tasks<T>();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = depth, NV = n_views;
  FTable<MAXT> tb;
  const int n_planes = 3 + 2 * D + 2 * NV;
  for (int i = 0; i < MAXPLANES; ++i)
    tb.plane[i] = i < n_planes ? plane_off[i] : 0;
  const int H = PL_H, HV = PL_H + D, DC = PL_H + D + NV, DV = DC + D;
  const long long* go = grad_offsets;
  FTask* t = tb.task;
  int n = 0;
  bool ok = add_ftasks(t, MAXT, &n, PL_PE, PE_PAD, DC, W, go[SLOT_W]);
  for (int i = 1; i < D; ++i) {
    ok = ok && add_ftasks(t, MAXT, &n, H + i - 1, W, DC + i, W,
                          go[SLOT_W + i]);
    if (go[SLOT_WSKIP + i] >= 0)
      ok = ok && add_ftasks(t, MAXT, &n, PL_PE, PE_PAD, DC + i, W,
                            go[SLOT_WSKIP + i]);
  }
  ok = ok && add_ftasks(t, MAXT, &n, H + D - 1, W, DV, WV, go[SLOT_WV]);
  ok = ok &&
       add_ftasks(t, MAXT, &n, PL_PED, PED_PAD, DV, WV, go[SLOT_WV0D]);
  for (int v = 1; v < NV; ++v)
    ok = ok && add_ftasks(t, MAXT, &n, HV + v - 1, WV, DV + v, WV,
                          go[SLOT_WV + v]);
  ok = ok && add_ftasks(t, MAXT, &n, H + D - 1, W, PL_GB, HEADS,
                        go[SLOT_WALPHA]);
  ok = ok && add_ftasks(t, MAXT, &n, HV + NV - 1, WV, PL_GB, HEADS,
                        go[SLOT_WRGB]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = prepare(k_grad_pass_b_f32<T>, FB_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_grad_pass_b_f32<T><<<dim3(n, n_chunks), FB_THREADS, FB_SMEM, s>>>(
      tb, static_cast<const float*>(planes), partials, G, n_tiles,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish<T>(bias, NB, n_tiles, n_chunks, grad_offsets, D, NV,
                   partials, out, G, s);
}

}  // namespace fr

// The C entries of one width: fr_grad_pass_a_w<W>, fr_grad_pass_b_w<W>,
// fr_grad_pass_a_f32_w<W>, fr_grad_pass_b_f32_w<W> (the f32 pair takes
// the bf16 pair's arguments), their shared-memory sizes and pass B's most
// output tiles (fr_grad_max_tasks_w<W>).
#define FR_GRAD_PASS_A_ENTRY(NAME, FN, WIDTH)                                 \
  int NAME##_w##WIDTH(const float* pts, const float* dirs, const float* g,    \
                      void* planes, const long long* plane_off, float* bias,  \
                      int N, int tiles_per_block,                             \
                      const unsigned long long* slots, int depth,             \
                      int n_views, int multires, int multires_views,          \
                      const void* wstream, int n_stages, int n_ring,          \
                      void* stream) {                                         \
    return fr::FN<fr::Layout<WIDTH>>(                                         \
        pts, dirs, g, planes, plane_off, bias, N, tiles_per_block, slots,     \
        depth, n_views, multires, multires_views, wstream, n_stages, n_ring,  \
        stream);                                                              \
  }
#define FR_GRAD_PASS_B_ENTRY(NAME, FN, WIDTH)                                 \
  int NAME##_w##WIDTH(const void* planes, const long long* plane_off,         \
                      const float* bias, int NB, float* partials, float* out, \
                      long long G, int n_tiles, int n_chunks,                 \
                      const long long* grad_offsets, int depth, int n_views,  \
                      void* stream) {                                         \
    return fr::FN<fr::Layout<WIDTH>>(planes, plane_off, bias, NB, partials,   \
                                     out, G, n_tiles, n_chunks, grad_offsets, \
                                     depth, n_views, stream);                 \
  }
#define FR_GRAD_ENTRIES(WIDTH)                                                \
  extern "C" {                                                                \
  unsigned long long fr_grad_pass_a_smem_bytes_w##WIDTH(int n_ring,           \
                                                        int depth,            \
                                                        int n_views) {        \
    return fr::pass_a_smem_bytes<fr::Layout<WIDTH>>(n_ring, depth, n_views);  \
  }                                                                           \
  unsigned long long fr_grad_pass_a_f32_smem_bytes_w##WIDTH(                  \
      int n_ring, int depth, int n_views) {                                   \
    return fr::pass_a_f32_smem_bytes<fr::Layout<WIDTH>>(n_ring, depth,        \
                                                        n_views);             \
  }                                                                           \
  unsigned long long fr_grad_pass_b_smem_bytes_w##WIDTH() {                   \
    return fr::B_SMEM;                                                        \
  }                                                                           \
  unsigned long long fr_grad_pass_b_f32_smem_bytes_w##WIDTH() {               \
    return fr::FB_SMEM;                                                       \
  }                                                                           \
  int fr_grad_max_tasks_w##WIDTH() {                                          \
    return fr::max_tasks<fr::Layout<WIDTH>>();                                \
  }                                                                           \
  FR_GRAD_PASS_A_ENTRY(fr_grad_pass_a, grad_pass_a, WIDTH)                    \
  FR_GRAD_PASS_A_ENTRY(fr_grad_pass_a_f32, grad_pass_a_f32, WIDTH)            \
  FR_GRAD_PASS_B_ENTRY(fr_grad_pass_b, grad_pass_b, WIDTH)                    \
  FR_GRAD_PASS_B_ENTRY(fr_grad_pass_b_f32, grad_pass_b_f32, WIDTH)            \
  }
