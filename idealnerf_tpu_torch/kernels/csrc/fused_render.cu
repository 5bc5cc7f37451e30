// Fused per-ray render kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by kernels/fused_render.py.
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
// MACs through the 8x256 trunk and the view branch against 16 bytes of
// per-point HBM traffic (a depth in, a weight out), so the kernels are far
// above the H100's ridge point; points never exist in HBM (PE is built from
// the ray packet in shared memory) and only per-ray summaries and weights
// are written. The first version uses wmma 16x16x16 fragments with weights
// streamed from L2 per layer (render_body.cuh); wgmma, TMA and persistent
// blocks are left to later work. The delta kernel's depth placement and
// band epilogue are a few hundred scalar operations per ray against
// 16 x 558k MACs; at S = 16 a block owns 16 rays (256 points, four tiles).
#include "render_body.cuh"

namespace fr {

__global__ void __launch_bounds__(NTHREADS, 2)
k_render_rays(Net net, const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, const float* __restrict__ bc,
              const float* __restrict__ zin, float* __restrict__ summary,
              float* __restrict__ weights, int R, int S, int rb) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  smem_layout(smem, rb, S, 0, 0, 0, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0);

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  for (int e = tid; e < nr * S; e += NTHREADS)
    sm.z[e] = zin[static_cast<size_t>(ray0) * S + e];
  __syncthreads();
  render_block(net, sm, bc, summary, weights, ray0, nr, S, rb, warp, lane,
               tid);
}

__global__ void __launch_bounds__(NTHREADS, 2)
k_coarse_hier(Net net, const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, const float* __restrict__ bc,
              float near, float far, float* __restrict__ summary,
              float* __restrict__ weights, float* __restrict__ z_all, int R,
              int S, int n_imp, int rb) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  smem_layout(smem, rb, S, S - 1, S + n_imp, 0, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0);

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  // coarse depths: the static near/far linspace, t = s / (S - 1), each
  // step rounded as core/sampling.py:stratified_sample rounds it
  for (int e = tid; e < nr * S; e += NTHREADS) {
    const float t = __fdiv_rn(static_cast<float>(e % S),
                              static_cast<float>(S - 1));
    sm.z[e] = __fadd_rn(__fmul_rn(near, __fsub_rn(1.f, t)),
                        __fmul_rn(far, t));
  }
  __syncthreads();
  render_block(net, sm, bc, summary, weights, ray0, nr, S, rb, warp, lane,
               tid);
  hier_depths(sm, z_all, ray0, nr, S, n_imp, tid);
}

// S = s_uni + s_imp + 1 depths per ray; z_prev / w_prev are (R, s_prev).
__global__ void __launch_bounds__(NTHREADS, 2)
k_render_delta(Net net, const float* __restrict__ rays_o,
               const float* __restrict__ rays_d, const float* __restrict__ bc,
               const float* __restrict__ z_prev,
               const float* __restrict__ w_prev,
               const float* __restrict__ band_lo,
               const float* __restrict__ band_hi, float far, float q_lo,
               float q_hi, float* __restrict__ summary,
               float* __restrict__ weights, float* __restrict__ z_out, int R,
               int s_prev, int s_uni, int s_imp, int rb) {
  extern __shared__ __align__(128) char smem[];
  const int S = s_uni + s_imp + 1;
  Smem sm;
  smem_layout(smem, rb, S, s_prev - 2, S - 1, s_prev, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0);

  load_rays(net, sm, rays_o, rays_d, ray0, nr, tid);
  const size_t g = static_cast<size_t>(ray0) * s_prev;
  for (int e = tid; e < nr * s_prev; e += NTHREADS) {
    sm.zp[e] = z_prev[g + e];
    sm.wp[e] = w_prev[g + e];
  }
  __syncthreads();
  delta_depths(sm, band_lo, band_hi, far, ray0, nr, s_prev, s_uni, s_imp,
               tid);
  render_block(net, sm, bc, summary, weights, ray0, nr, S, rb, warp, lane,
               tid);
  for (int e = tid; e < nr * S; e += NTHREADS)
    z_out[static_cast<size_t>(ray0) * S + e] = sm.z[e];
  fg_band_out(sm, summary, ray0, nr, S, q_lo, q_hi, tid);
}

}  // namespace fr

extern "C" {

int fr_num_slots() { return fr::NSLOTS; }

unsigned long long fr_smem_bytes(int rb, int S, int n_cdf, int n_union,
                                 int n_prev) {
  return fr::smem_layout(nullptr, rb, S, n_cdf, n_union, n_prev, nullptr);
}

const char* fr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fr_render_rays(const float* rays_o, const float* rays_d, const float* bc,
                   const float* z, float* summary, float* weights, int R,
                   int S, int rb, const unsigned long long* slots, int depth,
                   int n_views, int multires, int multires_views,
                   int softplus, void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, softplus);
  const size_t bytes = fr::smem_layout(nullptr, rb, S, 0, 0, 0, nullptr);
  cudaError_t err = fr::prepare(fr::k_render_rays, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (R + rb - 1) / rb;
  fr::k_render_rays<<<grid, fr::NTHREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, rays_o, rays_d, bc, z, summary, weights, R, S, rb);
  return static_cast<int>(cudaGetLastError());
}

int fr_coarse_hier(const float* rays_o, const float* rays_d, const float* bc,
                   float near, float far, float* summary, float* weights,
                   float* z_all, int R, int S, int n_imp, int rb,
                   const unsigned long long* slots, int depth, int n_views,
                   int multires, int multires_views, int softplus,
                   void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, softplus);
  const size_t bytes =
      fr::smem_layout(nullptr, rb, S, S - 1, S + n_imp, 0, nullptr);
  cudaError_t err = fr::prepare(fr::k_coarse_hier, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (R + rb - 1) / rb;
  fr::k_coarse_hier<<<grid, fr::NTHREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      net, rays_o, rays_d, bc, near, far, summary, weights, z_all, R, S,
      n_imp, rb);
  return static_cast<int>(cudaGetLastError());
}

int fr_render_delta(const float* rays_o, const float* rays_d, const float* bc,
                    const float* z_prev, const float* w_prev,
                    const float* band_lo, const float* band_hi, float far,
                    float q_lo, float q_hi, float* summary, float* weights,
                    float* z_out, int R, int s_prev, int s_uni, int s_imp,
                    int rb, const unsigned long long* slots, int depth,
                    int n_views, int multires, int multires_views,
                    int softplus, void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, softplus);
  const int S = s_uni + s_imp + 1;
  const size_t bytes =
      fr::smem_layout(nullptr, rb, S, s_prev - 2, S - 1, s_prev, nullptr);
  cudaError_t err = fr::prepare(fr::k_render_delta, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (R + rb - 1) / rb;
  fr::k_render_delta<<<grid, fr::NTHREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      net, rays_o, rays_d, bc, z_prev, w_prev, band_lo, band_hi, far, q_lo,
      q_hi, summary, weights, z_out, R, s_prev, s_uni, s_imp, rb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
