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

// The chunks' bias partials from the per-tile bias rows, then out = the
// partials summed in chunk order (both variants' last two kernels).
static int finish(const float* bias, int NB, int n_tiles, int n_chunks,
                  const long long* grad_offsets, int D, int NV,
                  float* partials, float* out, long long G, cudaStream_t s) {
  GradTable gt;
  for (int i = 0; i < NSLOTS; ++i) gt.off[i] = grad_offsets[i];
  k_bias_partials<<<dim3((NB + 255) / 256, n_chunks), 256, 0, s>>>(
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
constexpr int F_KW = F_STAGE / W, F_KV = F_STAGE / WV;  // K-rows a stage
constexpr int F_BAR = 1;                       // the consumers' barrier
// activation tile, PE, dir-PE and the column sums' scratch (8 warps x W)
constexpr size_t F_TILE_BYTES = 4 * (GP * W + GP * PE_PAD + GP * PED_PAD +
                                     NWARP * W);
static_assert(CONSUMER_WARPS == F_CONSUMERS / 32 && NWARP == 8,
              "each consumer warp releases a stage once");

// relu' bits: 64 a thread (8 bytes) per trunk and per view layer
__host__ __device__ inline size_t f32_mask_bytes(int depth, int n_views) {
  return 8 * F_CONSUMERS * static_cast<size_t>(depth + n_views);
}

// 1,024 bytes to align the base, the ring, the tiles, the relu' bits, then
// the ring's mbarriers.
__host__ __device__ inline size_t pass_a_f32_smem_bytes(int n_ring,
                                                        int depth,
                                                        int n_views) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES + F_TILE_BYTES +
         f32_mask_bytes(depth, n_views) + 16 * MAX_RING;
}

// Stages of pass A f32's weight stream per tile: layer 0, each later
// layer's skip pe-part then its h-part, view layer 0's h-part and dir-PE
// part, the later view layers; then WV_v^T for v = NV-1..1, WV_0^T's
// h-part and W_i^T for i = D-1..1 (265 for the paper model).
inline int f32_stages(const unsigned long long* slots, int depth,
                      int n_views) {
  int n = PE_PAD / F_KW;
  for (int i = 1; i < depth; ++i)
    n += W / F_KW + (slots[SLOT_WSKIP + i] ? PE_PAD / F_KW : 0);
  n += W / F_KV + PED_PAD / F_KV + (n_views - 1) * (WV / F_KV);
  return n + (n_views - 1) * (WV / F_KV) + WV / F_KW + (depth - 1) * (W / F_KW);
}

// The forward's epilogue of a layer of 128 NC columns: h = relu(acc +
// bias) into the activation tile and to the plane rows at dst (both
// row-major, 128 NC floats a row; streaming stores to dst) -> the relu'
// bits, bit 4 NC i + 4 c + q for acc[i][4 c + q]. acc ends zeroed.
template <int NC>
__device__ __forceinline__ unsigned long long fwd_store(
    float (&acc)[8][8], const float* __restrict__ bias, float* act,
    float* __restrict__ dst, int w, int l) {
  constexpr int WIDTH = 128 * NC;
  float4 b[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    b[c] = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * l));
  unsigned long long bits = 0ull;
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
      bits |= m << (4 * NC * i + 4 * c);
      const int off = (8 * w + i) * WIDTH + 128 * c + 4 * l;
      *reinterpret_cast<float4*>(act + off) = h;
      __stcs(reinterpret_cast<float4*>(dst + off), h);
      acc[i][4 * c] = acc[i][4 * c + 1] = 0.f;
      acc[i][4 * c + 2] = acc[i][4 * c + 3] = 0.f;
    }
  return bits;
}

// The backward's epilogue of a layer of 128 NC columns: d = acc masked by
// the relu' bits into the activation tile (the next product's A) and to the
// plane rows at dst; brow[0, 128 NC) = the column sums of d, each thread's
// 8 rows in order, then the 8 warps in order through part. acc ends
// zeroed. The caller has passed the barrier after the tile's last reads;
// the barrier here publishes the tile and part.
template <int NC>
__device__ __forceinline__ void bwd_store(float (&acc)[8][8],
                                          unsigned long long bits,
                                          float* act,
                                          float* __restrict__ dst,
                                          float* part,
                                          float* __restrict__ brow, int w,
                                          int l, int tid) {
  constexpr int WIDTH = 128 * NC;
  float s[4 * NC];
#pragma unroll
  for (int j = 0; j < 4 * NC; ++j) s[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int bit = 4 * NC * i + 4 * c;
      const float4 d =
          make_float4((bits >> bit) & 1ull ? acc[i][4 * c] : 0.f,
                      (bits >> (bit + 1)) & 1ull ? acc[i][4 * c + 1] : 0.f,
                      (bits >> (bit + 2)) & 1ull ? acc[i][4 * c + 2] : 0.f,
                      (bits >> (bit + 3)) & 1ull ? acc[i][4 * c + 3] : 0.f);
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
  named_barrier(F_BAR, F_CONSUMERS);
  for (int col = tid; col < WIDTH; col += F_CONSUMERS) {
    float t = part[col];
#pragma unroll
    for (int v = 1; v < NWARP; ++v) t += part[v * WIDTH + col];
    brow[col] = t;
  }
}

// acc[i][4 c + q] (+)= g[8 w + i] . wh[128 c + 4 l + q][0:4]: the heads'
// K = 4 products with the f32 cotangent g (the tile's rows; rows at or past
// n are zero); wh is (128 NC, HEADS) f32, of which the first 4 lanes count.
template <int NC, bool ADD>
__device__ __forceinline__ void fheads(float (&acc)[8][8],
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
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(
          wh + (128 * c + 4 * l + q) * HEADS));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float d = gr[i].x * u.x;
        d = fmaf(gr[i].y, u.y, d);
        d = fmaf(gr[i].z, u.z, d);
        d = fmaf(gr[i].w, u.w, d);
        float& a = acc[i][4 * c + q];
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
  unsigned long long* mask;  // (D + NV, F_CONSUMERS) relu' bits
};

// Pass A f32 on the 64-point tile `tile` (its n = min(GP, N - p0) points
// from p0): inputs, the forward, then d_h back through the heads, the view
// branch and the trunk; every plane's rows of the tile and its bias row.
__device__ __forceinline__ void pass_a_f32_tile(
    const Net& net, const Planes& pl, FRing& r, const FTiles& sm,
    const float* __restrict__ pts, const float* __restrict__ dirs,
    const float* __restrict__ gin, float* __restrict__ planes,
    float* __restrict__ bias, int tile, int N, int tid) {
  const int D = net.depth, NV = net.n_views;
  const int w = tid >> 5, l = tid & 31;
  const int p0 = tile * GP, n = min(GP, N - p0);
  const int HV = PL_H + D, DC = PL_H + D + NV, DV = DC + D;
  auto plane = [&](int j, int width) {
    return planes + pl.off[j] + static_cast<size_t>(p0) * width;
  };
  const float* g = gin + static_cast<size_t>(p0) * 4;
  float* brow = bias + static_cast<size_t>(tile) * (D * W + NV * WV + HEADS);

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

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // ---- forward: the skip layers' PE product before their h product
  for (int i = 0; i < D; ++i) {
    if (i == 0 || net.slot[SLOT_WSKIP + i] != nullptr)
      fprod<2>(acc, r, sm.pe, PE_PAD, PE_PAD, w, l);
    if (i > 0) fprod<2>(acc, r, sm.act, W, W, w, l);
    named_barrier(F_BAR, F_CONSUMERS);
    sm.mask[i * F_CONSUMERS + tid] = fwd_store<2>(
        acc, fvec(net, SLOT_B + i), sm.act, plane(PL_H + i, W), w, l);
    named_barrier(F_BAR, F_CONSUMERS);
  }
  for (int v = 0; v < NV; ++v) {  // view layer 0 adds the dir-PE product
    fprod<1>(acc, r, sm.act, v == 0 ? W : WV, v == 0 ? W : WV, w, l);
    if (v == 0) fprod<1>(acc, r, sm.ped, PED_PAD, PED_PAD, w, l);
    named_barrier(F_BAR, F_CONSUMERS);
    sm.mask[(D + v) * F_CONSUMERS + tid] = fwd_store<1>(
        acc, fvec(net, SLOT_BV + v), sm.act, plane(HV + v, WV), w, l);
    named_barrier(F_BAR, F_CONSUMERS);
  }

  // ---- backward: d_hv of the last view layer = g @ w_rgb^T
  fheads<1, false>(acc, g, n, fvec(net, SLOT_WRGB), w, l);
  bwd_store<1>(acc, sm.mask[(D + NV - 1) * F_CONSUMERS + tid], sm.act,
               plane(DV + NV - 1, WV), sm.part,
               brow + D * W + (NV - 1) * WV, w, l, tid);
  for (int v = NV - 1; v >= 1; --v) {  // d_hv(v - 1) = dv(v) @ WV_v^T
    fprod<1>(acc, r, sm.act, WV, WV, w, l);
    named_barrier(F_BAR, F_CONSUMERS);
    bwd_store<1>(acc, sm.mask[(D + v - 1) * F_CONSUMERS + tid], sm.act,
                 plane(DV + v - 1, WV), sm.part,
                 brow + D * W + (v - 1) * WV, w, l, tid);
  }
  // d_h of the last trunk layer = dv(0) @ WV_0^T + g @ w_alpha^T
  fprod<2>(acc, r, sm.act, WV, WV, w, l);
  fheads<2, true>(acc, g, n, fvec(net, SLOT_WALPHA), w, l);
  for (int i = D - 1; i >= 0; --i) {  // d_h(i - 1) = dc(i) @ W_i^T
    named_barrier(F_BAR, F_CONSUMERS);
    bwd_store<2>(acc, sm.mask[i * F_CONSUMERS + tid], sm.act,
                 plane(DC + i, W), sm.part, brow + i * W, w, l, tid);
    if (i > 0) fprod<2>(acc, r, sm.act, W, W, w, l);
  }
}

__global__ void __launch_bounds__(F_THREADS, 1)
k_grad_pass_a_f32(Net net, const __grid_constant__ Planes pl,
                  const float* __restrict__ wstream, int n_stages,
                  const float* __restrict__ pts,
                  const float* __restrict__ dirs,
                  const float* __restrict__ gin, float* __restrict__ planes,
                  float* __restrict__ bias, int N, int tiles_per_block,
                  int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* gbase = smem_raw + (base - raw);
  const int D = net.depth, NV = net.n_views;
  FTiles sm;
  sm.act = reinterpret_cast<float*>(gbase + n_ring * STAGE_BYTES);
  sm.pe = sm.act + GP * W;
  sm.ped = sm.pe + GP * PE_PAD;
  sm.part = sm.ped + GP * PED_PAD;
  sm.mask = reinterpret_cast<unsigned long long*>(sm.part + NWARP * W);
  const Chain c{base,
                base + static_cast<uint32_t>(n_ring * STAGE_BYTES +
                                             F_TILE_BYTES +
                                             f32_mask_bytes(D, NV)),
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
      pass_a_f32_tile(net, pl, r, sm, pts, dirs, gin, planes, bias, t, N,
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

struct FTable {
  long long plane[MAXPLANES];
  FTask task[MAXTASKS];
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
__global__ void __launch_bounds__(FB_THREADS, 2)
k_grad_pass_b_f32(const __grid_constant__ FTable tb,
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

// The 128 x 128 tiles of dW = X^T @ Y (xw x yw floats at offset off).
static bool add_ftasks(FTask* task, int* n, int xp, int xw, int yp, int yw,
                       long long off) {
  for (int m0 = 0; m0 < xw; m0 += FB_TILE)
    for (int n0 = 0; n0 < yw; n0 += FB_TILE) {
      if (*n >= MAXTASKS || off < 0) return false;
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

}  // namespace fr

extern "C" {

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
  return finish(bias, NB, n_tiles, n_chunks, grad_offsets, D, NV, partials,
                out, G, s);
}

unsigned long long fr_grad_pass_a_f32_smem_bytes(int n_ring, int depth,
                                                 int n_views) {
  return fr::pass_a_f32_smem_bytes(n_ring, depth, n_views);
}

unsigned long long fr_grad_pass_b_f32_smem_bytes() { return fr::FB_SMEM; }

// f32 pass A. planes: the f32 operand buffer (plane_off, float offsets, as
// kernels/fused_mlp_grad.py:grad_planes_f32); bias: (tiles of 64 points,
// NB) f32; wstream: n_stages stages of the net's f32 weight stream
// (grad_weight_stream_f32, 16-byte aligned); blocks of tiles_per_block
// 64-point tiles; n_ring: stages of the shared-memory ring (2..MAX_RING).
int fr_grad_pass_a_f32(const float* pts, const float* dirs, const float* g,
                       void* planes, const long long* plane_off, float* bias,
                       int N, int tiles_per_block,
                       const unsigned long long* slots, int depth,
                       int n_views, int multires, int multires_views,
                       const void* wstream, int n_stages, int n_ring,
                       void* stream) {
  using namespace fr;
  if (tiles_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = pass_a_f32_smem_bytes(n_ring, depth, n_views);
  cudaError_t err =
      chain_prepare(k_grad_pass_a_f32, bytes,
                    f32_stages(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net = make_net(slots, depth, n_views, multires, multires_views, 0);
  Planes pl;
  const int n_planes = 3 + 2 * depth + 2 * n_views;
  for (int i = 0; i < MAXPLANES; ++i)
    pl.off[i] = i < n_planes ? plane_off[i] : 0;
  const int tiles = (N + GP - 1) / GP;
  const int grid = (tiles + tiles_per_block - 1) / tiles_per_block;
  k_grad_pass_a_f32<<<grid, F_THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, pl, static_cast<const float*>(wstream), n_stages, pts, dirs, g,
      static_cast<float*>(planes), bias, N, tiles_per_block, n_ring);
  return static_cast<int>(cudaGetLastError());
}

// f32 pass B: partials (n_chunks, G) f32 (every gradient's region is
// written), out (G,) f32 = the partials summed in chunk order.
int fr_grad_pass_b_f32(const void* planes, const long long* plane_off,
                       const float* bias, int NB, float* partials,
                       float* out, long long G, int n_tiles, int n_chunks,
                       const long long* grad_offsets, int depth,
                       int n_views, void* stream) {
  using namespace fr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = depth, NV = n_views;
  FTable tb;
  const int n_planes = 3 + 2 * D + 2 * NV;
  for (int i = 0; i < MAXPLANES; ++i)
    tb.plane[i] = i < n_planes ? plane_off[i] : 0;
  const int H = PL_H, HV = PL_H + D, DC = PL_H + D + NV, DV = DC + D;
  const long long* go = grad_offsets;
  int n = 0;
  bool ok = add_ftasks(tb.task, &n, PL_PE, PE_PAD, DC, W, go[SLOT_W]);
  for (int i = 1; i < D; ++i) {
    ok = ok && add_ftasks(tb.task, &n, H + i - 1, W, DC + i, W,
                          go[SLOT_W + i]);
    if (go[SLOT_WSKIP + i] >= 0)
      ok = ok && add_ftasks(tb.task, &n, PL_PE, PE_PAD, DC + i, W,
                            go[SLOT_WSKIP + i]);
  }
  ok = ok && add_ftasks(tb.task, &n, H + D - 1, W, DV, WV, go[SLOT_WV]);
  ok = ok && add_ftasks(tb.task, &n, PL_PED, PED_PAD, DV, WV, go[SLOT_WV0D]);
  for (int v = 1; v < NV; ++v)
    ok = ok && add_ftasks(tb.task, &n, HV + v - 1, WV, DV + v, WV,
                          go[SLOT_WV + v]);
  ok = ok && add_ftasks(tb.task, &n, H + D - 1, W, PL_GB, HEADS,
                        go[SLOT_WALPHA]);
  ok = ok && add_ftasks(tb.task, &n, HV + NV - 1, WV, PL_GB, HEADS,
                        go[SLOT_WRGB]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = prepare(k_grad_pass_b_f32, FB_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_grad_pass_b_f32<<<dim3(n, n_chunks), FB_THREADS, FB_SMEM, s>>>(
      tb, static_cast<const float*>(planes), partials, G, n_tiles,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish(bias, NB, n_tiles, n_chunks, grad_offsets, D, NV, partials,
                out, G, s);
}

}  // extern "C"
