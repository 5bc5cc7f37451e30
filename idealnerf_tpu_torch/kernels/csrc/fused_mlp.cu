// Fused point MLP for Hopper (sm_90a), with a plain C interface loaded
// through ctypes by kernels/fused_mlp.py.
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
// What bounds it on the card: tensor-core work, as in fused_render.cu. A
// point costs about 558k MACs against 28 bytes of HBM traffic (6 floats in,
// 4 out), so the kernel is far above the ridge point. One block of 8 warps
// takes one tile of P=64 points: the xyz- and dir-PE are built in shared
// memory from the raw coordinates (f32 phases, bf16 after the sin), then
// the shared wmma body (render_body.cuh:mlp_core) runs the trunk, the view
// branch with the per-point dir-PE product in view layer 0's accumulator,
// and the packed heads, and writes the tile's raw rows. Directions are
// taken as given, not normalised, as the TPU kernel takes them. The
// encoded variant reads 192 bytes of PE per point instead of 24 of
// coordinates, still far below the ridge point: it copies the rows into the
// same shared-memory tiles (zeros past the ragged end) and runs the same
// body, so K4 - K5 is the in-kernel PE's cost.
#include "render_body.cuh"

namespace fr {

__global__ void __launch_bounds__(NTHREADS, 2)
k_point_mlp(Net net, const float* __restrict__ pts,
            const float* __restrict__ dirs, float* __restrict__ out, int N) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  point_smem_layout(smem, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * P;
  const int n = min(P, N - p0);

  for (int e = tid; e < P * PE_PAD; e += NTHREADS) {
    const int row = e / PE_PAD, k = e - row * PE_PAD;
    float v = 0.f;
    if (row < n) {
      const float* x = pts + static_cast<size_t>(p0 + row) * 3;
      const float xx[3] = {x[0], x[1], x[2]};
      v = pe_lane(xx, k, net.multires);
    }
    sm.pe[e] = __float2bfloat16(v);
  }
  for (int e = tid; e < P * PED_PAD; e += NTHREADS) {
    const int row = e / PED_PAD, k = e - row * PED_PAD;
    float v = 0.f;
    if (row < n) {
      const float* d = dirs + static_cast<size_t>(p0 + row) * 3;
      const float dd[3] = {d[0], d[1], d[2]};
      v = pe_lane(dd, k, net.multires_views);
    }
    sm.ped_tile[e] = __float2bfloat16(v);
  }
  __syncthreads();
  mlp_core(net, sm, fvec(net, SLOT_BV), 0, 0, n, 1, 1,
           out + static_cast<size_t>(p0) * 4, warp, lane);
}

__global__ void __launch_bounds__(NTHREADS, 2)
k_point_mlp_pe(Net net, const bf16* __restrict__ pe,
               const bf16* __restrict__ ped, float* __restrict__ out, int N) {
  extern __shared__ __align__(128) char smem[];
  Smem sm;
  point_smem_layout(smem, &sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * P;
  const int n = min(P, N - p0);

  load_rows(sm.pe, pe + static_cast<size_t>(p0) * PE_PAD, P, PE_PAD, n, tid);
  load_rows(sm.ped_tile, ped + static_cast<size_t>(p0) * PED_PAD, P, PED_PAD,
            n, tid);
  __syncthreads();
  mlp_core(net, sm, fvec(net, SLOT_BV), 0, 0, n, 1, 1,
           out + static_cast<size_t>(p0) * 4, warp, lane);
}

}  // namespace fr

extern "C" {

unsigned long long fr_point_mlp_smem_bytes() {
  return fr::point_smem_layout(nullptr, nullptr);
}

int fr_point_mlp(const float* pts, const float* dirs, float* out, int N,
                 const unsigned long long* slots, int depth, int n_views,
                 int multires, int multires_views, void* stream) {
  const fr::Net net =
      fr::make_net(slots, depth, n_views, multires, multires_views, 0);
  const size_t bytes = fr::point_smem_layout(nullptr, nullptr);
  cudaError_t err = fr::prepare(fr::k_point_mlp, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (N + fr::P - 1) / fr::P;
  fr::k_point_mlp<<<grid, fr::NTHREADS, bytes,
                    static_cast<cudaStream_t>(stream)>>>(net, pts, dirs, out,
                                                         N);
  return static_cast<int>(cudaGetLastError());
}

int fr_point_mlp_pe(const void* pe, const void* ped, float* out, int N,
                    const unsigned long long* slots, int depth, int n_views,
                    void* stream) {
  const fr::Net net = fr::make_net(slots, depth, n_views, 0, 0, 0);
  const size_t bytes = fr::point_smem_layout(nullptr, nullptr);
  cudaError_t err = fr::prepare(fr::k_point_mlp_pe, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (N + fr::P - 1) / fr::P;
  fr::k_point_mlp_pe<<<grid, fr::NTHREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(pe),
      static_cast<const fr::bf16*>(ped), out, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
