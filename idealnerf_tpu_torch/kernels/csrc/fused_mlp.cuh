// Fused point MLP for Hopper (sm_90a), with a plain C interface loaded
// through ctypes by kernels/fused_mlp.py: templates over the net's widths
// (chain.cuh Layout<W>), instantiated once per width by fused_mlp_w<W>.cu
// (FR_POINT_ENTRIES: fr_point_mlp_w128, ...).
//
// fr_point_mlp  replaces idealnerf_tpu/kernels/fused_mlp.py:
//               fused_point_mlp with fuse_pe=True (_kernel_fused_pe ->
//               _mlp_body): (N, 3) points and (N, 3) view directions ->
//               (N, 4) raw [rgb logits, sigma], the forward of every
//               training field call.
// fr_point_mlp_pe replaces idealnerf_tpu/kernels/fused_mlp.py:
//               fused_point_mlp with fuse_pe=False (_kernel -> _mlp_body):
//               the same MLP from encodings built outside the kernel, (N,
//               PE_PAD) xyz-PE and (N, PED_PAD) dir-PE rows in bf16 -> (N, 4).
//
// What bounds them on the card: tensor-core work. A point costs about 565k
// MACs (the ray kernels' 557k plus its own dir-PE product, 64 x 128 here)
// against 40 bytes of HBM traffic (6 floats in, 4 out; the encoded variant
// reads 192 bytes of PE instead of 24 of coordinates), far above the
// ridge point.
//
// Both run their MLP on the wgmma chain of chain.cuh, the one the ray
// kernels of fused_render.cuh run: one block of 288 threads per SM walks a
// contiguous run of tiles_per_block tiles of DT points (128; 64 at W=512;
// at most one wave of
// blocks: tiles_per_block = ceil(tiles / SMs), kernels/fused_mlp.py:
// point_launch_config), streaming the net's weight stream (70 stages at
// W=256: the ray kernels' 69 plus the dir-PE stage of view layer 0) through
// its ring once
// per tile without draining between tiles. The point tile source
// (PointTile) differs from the ray kernels' in three places:
// - the fill: each warpgroup builds its 64 rows' xyz-PE tile and a K-major
//   dir-PE tile of 64 lanes (lanes PED_PAD..63 zero) in shared memory,
//   from the raw coordinates (f32 phases, sinf/cosf without fast math,
//   bf16 after the sine, as pe_lane rounds them; directions taken as given,
//   not normalised, as the TPU kernel takes them) or, encoded, copied from
//   the bf16 PE rows; rows past N are zeros;
// - view layer 0: the per-point product dir-PE @ W_v0d as one more wgmma
//   stage into the accumulator of h @ W_v0, then bv[0] as the epilogue's
//   bias (the products and roundings of point_mlp_pe_reference; only the
//   order of the f32 sums differs);
// - the heads write rows < N of the (N, 4) f32 output in global memory.
// A point's output does not depend on the launch plan (tiles per block,
// ring depth): every tile runs the same arithmetic in the same order.
//
// In the training step the loss reads K4's raw, while the gradients come
// from the bf16 backward's own recompute of the forward (K6 pass A,
// fused_mlp_grad.cuh), which runs the same tile source and the same stages
// of the same chain: the activations the gradients see are the forward's.
// PointTile lives in chain.cuh for that reason.
#pragma once

#include "chain.cuh"

namespace fr {

// The block's run of tiles: points [p0, p0 + tiles_per_block x DT) of N.
template <bool ENCODED, class T>
__device__ __forceinline__ void point_block(char* smem_raw, const Net& net,
                                            const bf16* __restrict__ wstream,
                                            int n_stages, const void* a,
                                            const void* b, float* out, int N,
                                            int tiles_per_block, int n_ring,
                                            int a_width, int b_width) {
  const Chain c = chain_begin(smem_raw, n_ring, T::POINT_TILES, 1);
  const int p0 = blockIdx.x * tiles_per_block * T::DT;
  const int n_pts = min(tiles_per_block * T::DT, N - p0);
  const size_t elem = ENCODED ? sizeof(bf16) : sizeof(float);
  const PointTile<ENCODED, T> src{
      static_cast<const char*>(a) + static_cast<size_t>(p0) * a_width * elem,
      static_cast<const char*>(b) + static_cast<size_t>(p0) * b_width * elem,
      out + static_cast<size_t>(p0) * 4};
  chain_mlp(net, src, c, wstream, n_stages, n_pts);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
k_point_mlp(Net net, const bf16* __restrict__ wstream, int n_stages,
            const float* __restrict__ pts, const float* __restrict__ dirs,
            float* __restrict__ out, int N, int tiles_per_block,
            int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  point_block<false, T>(smem_raw, net, wstream, n_stages, pts, dirs, out, N,
                     tiles_per_block, n_ring, 3, 3);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
k_point_mlp_pe(Net net, const bf16* __restrict__ wstream, int n_stages,
               const bf16* __restrict__ pe, const bf16* __restrict__ ped,
               float* __restrict__ out, int N, int tiles_per_block,
               int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  point_block<true, T>(smem_raw, net, wstream, n_stages, pe, ped, out, N,
                    tiles_per_block, n_ring, PE_PAD, PED_PAD);
}

template <class T, typename K, typename A>
int launch_points(K kernel, const A* a, const A* b, float* out, int N,
                  int tiles_per_block, const unsigned long long* slots,
                  int depth, int n_views, int multires, int multires_views,
                  const void* wstream, int n_stages, int n_ring,
                  void* stream) {
  if (tiles_per_block < 1) return cudaErrorInvalidValue;
  const size_t bytes = point_smem_bytes<T>(n_ring);
  cudaError_t err = chain_prepare(
      kernel, bytes, chain_stages<T>(slots, depth, n_views) + 1, n_stages,
      n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net = make_net(slots, depth, n_views, multires, multires_views, 0);
  const int tiles = (N + T::DT - 1) / T::DT;
  const int grid = (tiles + tiles_per_block - 1) / tiles_per_block;
  kernel<<<grid, T::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const bf16*>(wstream), n_stages, a, b, out, N,
      tiles_per_block, n_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fr

// The C entries of one width: fr_point_smem_bytes_w<W>, fr_point_mlp_w<W>,
// fr_point_mlp_pe_w<W>. wstream: n_stages stages of the net's weight stream
// with the dir-PE stage (16-byte aligned); blocks of tiles_per_block tiles;
// n_ring: stages of the shared-memory ring (2..MAX_RING).
#define FR_POINT_ENTRIES(WIDTH)                                               \
  extern "C" {                                                                \
  unsigned long long fr_point_smem_bytes_w##WIDTH(int n_ring) {               \
    return fr::point_smem_bytes<fr::Layout<WIDTH>>(n_ring);                   \
  }                                                                           \
  int fr_point_mlp_w##WIDTH(const float* pts, const float* dirs, float* out,  \
                            int N, int tiles_per_block,                       \
                            const unsigned long long* slots, int depth,       \
                            int n_views, int multires, int multires_views,    \
                            const void* wstream, int n_stages, int n_ring,    \
                            void* stream) {                                   \
    using T = fr::Layout<WIDTH>;                                              \
    return fr::launch_points<T>(fr::k_point_mlp<T>, pts, dirs, out, N,        \
                                tiles_per_block, slots, depth, n_views,       \
                                multires, multires_views, wstream, n_stages,  \
                                n_ring, stream);                              \
  }                                                                           \
  int fr_point_mlp_pe_w##WIDTH(const void* pe, const void* ped, float* out,   \
                               int N, int tiles_per_block,                    \
                               const unsigned long long* slots, int depth,    \
                               int n_views, const void* wstream,              \
                               int n_stages, int n_ring, void* stream) {      \
    using T = fr::Layout<WIDTH>;                                              \
    return fr::launch_points<T>(                                              \
        fr::k_point_mlp_pe<T>, static_cast<const fr::bf16*>(pe),              \
        static_cast<const fr::bf16*>(ped), out, N, tiles_per_block, slots,    \
        depth, n_views, 0, 0, wstream, n_stages, n_ring, stream);             \
  }                                                                           \
  }
