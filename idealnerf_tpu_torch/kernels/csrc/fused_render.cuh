// Fused per-ray render kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by kernels/fused_render.py: templates over the
// net's widths (chain.cuh Layout<W>), instantiated once per width by
// fused_render_w<W>.cu (FR_RENDER_ENTRIES), whose entries carry the width
// in their names (fr_render_rays_w128, ...).
//
// fr_render_rays  replaces idealnerf_tpu/kernels/fused_render.py:
//                 fused_render_rays (_render_kernel -> _render_body), the
//                 fine pass of the full-fidelity frame render.
// fr_coarse_hier  replaces idealnerf_tpu/kernels/fused_render.py:
//                 fused_render_coarse_hier (_coarse_hier_kernel ->
//                 _render_body + _pdf_merge), the coarse pass plus the
//                 importance-depth placement.
// fr_render_delta replaces idealnerf_tpu/kernels/fused_render.py:
//                 fused_render_delta (_delta_kernel), the temporal delta
//                 frame: depth placement from the previous frame's per-ray
//                 (z, w) and the cached band, the fine render, and the next
//                 frame's foreground band, in one launch.
//
// What bounds them on the card: tensor-core work. A point costs about 558k
// MACs through the 8x256 trunk and the view branch (149k at W=128, 2.2M at
// 512) against 16 bytes of
// per-point HBM traffic (a depth in, a weight out), so the kernels are far
// above the H100's ridge point; points never exist in HBM (PE is built from
// the ray packet in shared memory) and only per-ray summaries and weights
// are written.
//
// All three run their field MLP on the wgmma chain of chain.cuh
// (chain_mlp: the net's weights streamed as pre-swizzled 16 KB stages
// through a shared-memory ring, two consumer warpgroups of 64 rows), which
// the point kernels of fused_mlp.cuh (K4, K5) run too. Here, one block per
// group of rb rays; the chain's tiles run over the block's rb x S points in
// order, so a tile may straddle rays and the last one may be partial (its
// rows past the block's points are zeros; 128-point tiles, 64-point ones at
// W=512). The ray tile source (RayTile,
// chain.cuh) builds a tile's PE from the ray packets and depths in shared
// memory, adds the per-ray view-layer-0 term pv (load_rays: ped @ wv0d +
// bv0, once per ray) in view layer 0's epilogue, and writes raw rows to
// sm.raw. Around the chain each block runs render_body.cuh's per-ray
// code; the producer warp joins its barriers with a thread index past
// every loop (IDLE):
//     k_render_rays   load_rays, depths read from z, chain, composite
//     k_coarse_hier   load_rays, the near/far linspace, chain, composite,
//                     hier_depths
//     k_render_delta  load_rays, delta_depths, chain, composite,
//                     fg_band_out
// Bound: tensor-core work (43.3 TFLOP for the fine pass of a 450x450 frame
// at W=256, 14.4 for its coarse pass, 2.30 for a delta frame at 129,024
// rays x 16); the weight stream moves about 8.6 KB of L2 traffic per point
// at W=256 (W=512: its 4.3 MB stream serves 64 points, 67 KB a point).
#pragma once

#include "chain.cuh"

namespace fr {

// Per-ray state of the chain kernels (f32, each region 128-byte aligned):
// ro, rd, dn, ped, pv (WV a ray), z, raw, w, cdf, uni, zp, wp as in Smem;
// regions a kernel does not use have no rows (n_cdf, n_union, n_prev 0).
template <class T>
__host__ __device__ inline size_t ray_state_layout(char* base, int rb, int S,
                                                   int n_cdf, int n_union,
                                                   int n_prev, Smem* sm) {
  const size_t n[12] = {static_cast<size_t>(rb) * 3,
                        static_cast<size_t>(rb) * 3,
                        static_cast<size_t>(rb),
                        static_cast<size_t>(rb) * PED_PAD,
                        static_cast<size_t>(rb) * T::WV,
                        static_cast<size_t>(rb) * S,
                        static_cast<size_t>(rb) * S * 4,
                        static_cast<size_t>(rb) * S,
                        static_cast<size_t>(rb) * n_cdf,
                        static_cast<size_t>(rb) * n_union,
                        static_cast<size_t>(rb) * n_prev,
                        static_cast<size_t>(rb) * n_prev};
  float* p[12];
  size_t total = 0;
  for (int i = 0; i < 12; ++i) {
    p[i] = base ? reinterpret_cast<float*>(base + total) : nullptr;
    total += (sizeof(float) * n[i] + 127) & ~static_cast<size_t>(127);
  }
  if (sm != nullptr) {
    *sm = Smem{};
    sm->ro = p[0];
    sm->rd = p[1];
    sm->dn = p[2];
    sm->ped = p[3];
    sm->pv = p[4];
    sm->z = p[5];
    sm->raw = p[6];
    sm->w = p[7];
    sm->cdf = p[8];
    sm->uni = p[9];
    sm->zp = p[10];
    sm->wp = p[11];
  }
  return total;
}

// Dynamic shared memory of a ray kernel: 1,024 bytes to align the base,
// then the ring, the tiles, the mbarriers and the per-ray state.
template <class T>
__host__ __device__ inline size_t chain_smem_bytes(int rb, int S, int n_cdf,
                                                   int n_union, int n_prev,
                                                   int n_ring) {
  return 1024 + ray_state_offset<T>(n_ring) +
         ray_state_layout<T>(nullptr, rb, S, n_cdf, n_union, n_prev, nullptr);
}

// chain_begin for a ray kernel, with the per-ray state laid out into sm.
template <class T>
__device__ __forceinline__ Chain ray_chain_begin(char* smem_raw, int n_ring,
                                                 int rb, int S, int n_cdf,
                                                 int n_union, int n_prev,
                                                 Smem* sm) {
  const Chain c = chain_begin(smem_raw, n_ring, T::TILES, 1);
  ray_state_layout<T>(c.gbase + ray_state_offset<T>(n_ring), rb, S, n_cdf,
                      n_union, n_prev, sm);
  return c;
}

// The fine pass: rays at given depths z (R, S).
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
k_render_rays(Net net, const bf16* __restrict__ wstream, int n_stages,
              const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, const float* __restrict__ bc,
              const float* __restrict__ zin, float* __restrict__ summary,
              float* __restrict__ weights, int R, int S, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem sm;
  const Chain c =
      ray_chain_begin<T>(smem_raw, n_ring, rb, S, 0, 0, 0, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays<T::WV>(net, sm, rays_o, rays_d, ray0, nr, tid);
  for (int e = tid; e < n_pts; e += NTHREADS)
    sm.z[e] = zin[static_cast<size_t>(ray0) * S + e];
  __syncthreads();
  chain_mlp(net, RayTile<T>{sm, S, nr}, c, wstream, n_stages, n_pts);
  composite(net, sm, bc, summary, weights, ray0, nr, S, tid);
}

// The coarse pass on the near/far linspace of S depths, then the fine
// depths z_all (R, S + n_imp) placed from its weights.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
k_coarse_hier(Net net, const bf16* __restrict__ wstream, int n_stages,
              const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, const float* __restrict__ bc,
              float near, float far, float* __restrict__ summary,
              float* __restrict__ weights, float* __restrict__ z_all, int R,
              int S, int n_imp, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem sm;
  const Chain c =
      ray_chain_begin<T>(smem_raw, n_ring, rb, S, S - 1, S + n_imp, 0, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays<T::WV>(net, sm, rays_o, rays_d, ray0, nr, tid);
  // coarse depths: the static near/far linspace, t = s / (S - 1), each
  // step rounded as core/sampling.py:stratified_sample rounds it
  for (int e = tid; e < n_pts; e += NTHREADS) {
    const float t = __fdiv_rn(static_cast<float>(e % S),
                              static_cast<float>(S - 1));
    sm.z[e] = __fadd_rn(__fmul_rn(near, __fsub_rn(1.f, t)),
                        __fmul_rn(far, t));
  }
  __syncthreads();
  chain_mlp(net, RayTile<T>{sm, S, nr}, c, wstream, n_stages, n_pts);
  composite(net, sm, bc, summary, weights, ray0, nr, S, tid);
  hier_depths(sm, z_all, ray0, nr, S, n_imp, tid);
}

// The delta frame: S = s_uni + s_imp + 1 depths per ray placed from the
// previous frame's z_prev / w_prev (R, s_prev) and the cached band.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
k_render_delta(Net net, const bf16* __restrict__ wstream, int n_stages,
               const float* __restrict__ rays_o,
               const float* __restrict__ rays_d, const float* __restrict__ bc,
               const float* __restrict__ z_prev,
               const float* __restrict__ w_prev,
               const float* __restrict__ band_lo,
               const float* __restrict__ band_hi, float far, float q_lo,
               float q_hi, float* __restrict__ summary,
               float* __restrict__ weights, float* __restrict__ z_out, int R,
               int s_prev, int s_uni, int s_imp, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const int S = s_uni + s_imp + 1;
  Smem sm;
  const Chain c = ray_chain_begin<T>(smem_raw, n_ring, rb, S, s_prev - 2,
                                     S - 1, s_prev, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  load_rays<T::WV>(net, sm, rays_o, rays_d, ray0, nr, tid);
  const size_t gp = static_cast<size_t>(ray0) * s_prev;
  for (int e = tid; e < nr * s_prev; e += NTHREADS) {
    sm.zp[e] = z_prev[gp + e];
    sm.wp[e] = w_prev[gp + e];
  }
  __syncthreads();
  delta_depths(sm, band_lo, band_hi, far, ray0, nr, s_prev, s_uni, s_imp,
               tid);
  chain_mlp(net, RayTile<T>{sm, S, nr}, c, wstream, n_stages, n_pts);
  composite(net, sm, bc, summary, weights, ray0, nr, S, tid);
  for (int e = tid; e < n_pts; e += NTHREADS)
    z_out[static_cast<size_t>(ray0) * S + e] = sm.z[e];
  fg_band_out(sm, summary, ray0, nr, S, q_lo, q_hi, tid);
}

// The host side of each kernel: check the stream and the ring, set the
// shared memory, launch; -> the CUDA error.
template <class T>
int render_rays(const float* rays_o, const float* rays_d, const float* bc,
                const float* z, float* summary, float* weights, int R, int S,
                int rb, const unsigned long long* slots, int depth,
                int n_views, int multires, int multires_views, int softplus,
                const void* wstream, int n_stages, int n_ring, void* stream) {
  const size_t bytes = chain_smem_bytes<T>(rb, S, 0, 0, 0, n_ring);
  cudaError_t err =
      chain_prepare(k_render_rays<T>, bytes,
                    chain_stages<T>(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net =
      make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int grid = (R + rb - 1) / rb;
  k_render_rays<T><<<grid, T::THREADS, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const bf16*>(wstream), n_stages, rays_o, rays_d, bc,
      z, summary, weights, R, S, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int coarse_hier(const float* rays_o, const float* rays_d, const float* bc,
                float near, float far, float* summary, float* weights,
                float* z_all, int R, int S, int n_imp, int rb,
                const unsigned long long* slots, int depth, int n_views,
                int multires, int multires_views, int softplus,
                const void* wstream, int n_stages, int n_ring, void* stream) {
  const size_t bytes =
      chain_smem_bytes<T>(rb, S, S - 1, S + n_imp, 0, n_ring);
  cudaError_t err =
      chain_prepare(k_coarse_hier<T>, bytes,
                    chain_stages<T>(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net =
      make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int grid = (R + rb - 1) / rb;
  k_coarse_hier<T><<<grid, T::THREADS, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const bf16*>(wstream), n_stages, rays_o, rays_d, bc,
      near, far, summary, weights, z_all, R, S, n_imp, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int render_delta(const float* rays_o, const float* rays_d, const float* bc,
                 const float* z_prev, const float* w_prev,
                 const float* band_lo, const float* band_hi, float far,
                 float q_lo, float q_hi, float* summary, float* weights,
                 float* z_out, int R, int s_prev, int s_uni, int s_imp,
                 int rb, const unsigned long long* slots, int depth,
                 int n_views, int multires, int multires_views, int softplus,
                 const void* wstream, int n_stages, int n_ring,
                 void* stream) {
  const int S = s_uni + s_imp + 1;
  const size_t bytes =
      chain_smem_bytes<T>(rb, S, s_prev - 2, S - 1, s_prev, n_ring);
  cudaError_t err =
      chain_prepare(k_render_delta<T>, bytes,
                    chain_stages<T>(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net =
      make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int grid = (R + rb - 1) / rb;
  k_render_delta<T><<<grid, T::THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const bf16*>(wstream), n_stages, rays_o, rays_d, bc,
      z_prev, w_prev, band_lo, band_hi, far, q_lo, q_hi, summary, weights,
      z_out, R, s_prev, s_uni, s_imp, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fr

// The C entries of one width: fr_chain_smem_bytes_w<W>, fr_render_rays_w<W>,
// fr_coarse_hier_w<W>, fr_render_delta_w<W>. The chain kernels take
// wstream: n_stages stages of the net's weight stream (16-byte aligned);
// n_ring: stages of the shared-memory ring (2..MAX_RING); one block per
// group of rb rays.
#define FR_RENDER_ENTRIES(WIDTH)                                              \
  extern "C" {                                                                \
  unsigned long long fr_chain_smem_bytes_w##WIDTH(                            \
      int rb, int S, int n_cdf, int n_union, int n_prev, int n_ring) {        \
    return fr::chain_smem_bytes<fr::Layout<WIDTH>>(rb, S, n_cdf, n_union,     \
                                                   n_prev, n_ring);           \
  }                                                                           \
  int fr_render_rays_w##WIDTH(                                                \
      const float* rays_o, const float* rays_d, const float* bc,              \
      const float* z, float* summary, float* weights, int R, int S, int rb,   \
      const unsigned long long* slots, int depth, int n_views, int multires,  \
      int multires_views, int softplus, const void* wstream, int n_stages,    \
      int n_ring, void* stream) {                                             \
    return fr::render_rays<fr::Layout<WIDTH>>(                                \
        rays_o, rays_d, bc, z, summary, weights, R, S, rb, slots, depth,      \
        n_views, multires, multires_views, softplus, wstream, n_stages,       \
        n_ring, stream);                                                      \
  }                                                                           \
  int fr_coarse_hier_w##WIDTH(                                                \
      const float* rays_o, const float* rays_d, const float* bc, float near,  \
      float far, float* summary, float* weights, float* z_all, int R, int S,  \
      int n_imp, int rb, const unsigned long long* slots, int depth,          \
      int n_views, int multires, int multires_views, int softplus,            \
      const void* wstream, int n_stages, int n_ring, void* stream) {          \
    return fr::coarse_hier<fr::Layout<WIDTH>>(                                \
        rays_o, rays_d, bc, near, far, summary, weights, z_all, R, S, n_imp,  \
        rb, slots, depth, n_views, multires, multires_views, softplus,        \
        wstream, n_stages, n_ring, stream);                                   \
  }                                                                           \
  int fr_render_delta_w##WIDTH(                                               \
      const float* rays_o, const float* rays_d, const float* bc,              \
      const float* z_prev, const float* w_prev, const float* band_lo,         \
      const float* band_hi, float far, float q_lo, float q_hi,                \
      float* summary, float* weights, float* z_out, int R, int s_prev,        \
      int s_uni, int s_imp, int rb, const unsigned long long* slots,          \
      int depth, int n_views, int multires, int multires_views,               \
      int softplus, const void* wstream, int n_stages, int n_ring,            \
      void* stream) {                                                         \
    return fr::render_delta<fr::Layout<WIDTH>>(                               \
        rays_o, rays_d, bc, z_prev, w_prev, band_lo, band_hi, far, q_lo,      \
        q_hi, summary, weights, z_out, R, s_prev, s_uni, s_imp, rb, slots,    \
        depth, n_views, multires, multires_views, softplus, wstream,          \
        n_stages, n_ring, stream);                                            \
  }                                                                           \
  }
