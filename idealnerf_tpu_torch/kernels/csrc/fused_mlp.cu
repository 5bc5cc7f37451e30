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
// What bounds them on the card: tensor-core work. A point costs about 565k
// MACs (the ray kernels' 557k plus its own dir-PE product, 64 x 128 here)
// against 40 bytes of HBM traffic (6 floats in, 4 out; the encoded variant
// reads 192 bytes of PE instead of 24 of coordinates), far above the
// ridge point.
//
// Both run their MLP on the wgmma chain of chain.cuh, the one the ray
// kernels of fused_render.cu run: one block of 288 threads per SM walks a
// contiguous run of tiles_per_block 128-point tiles (at most one wave of
// blocks: tiles_per_block = ceil(tiles / SMs), kernels/fused_mlp.py:
// point_launch_config), streaming the net's 70-stage weight stream (the ray
// kernels' 69 plus the dir-PE stage of view layer 0) through its ring once
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
// from the bf16 backward's own wmma recompute of the forward (K6 pass A,
// fused_mlp_grad.cu). Both round to bf16 at the same points and differ
// only in the order of their f32 sums, so the activations the gradients
// see agree with the forward's to bf16 rounding (one may land one bf16
// ulp apart).
#include "chain.cuh"

namespace fr {

// The chain's tile source for the block's points (pointers offset to the
// block's first point); ENCODED reads PE rows, otherwise coordinates.
template <bool ENCODED>
struct PointTile {
  static constexpr int kTileBytes = WG_BYTES + PED_TILE;
  static constexpr bool kDirProduct = true;
  const void* a;  // (n, 3) f32 points, or (n, PE_PAD) bf16 xyz-PE rows
  const void* b;  // (n, 3) f32 directions, or (n, PED_PAD) bf16 dir-PE rows
  float* out;     // (n, 4) f32 raw

  // The encodings of chunks C0 + 2 j of a row: xyz-PE j = 0..3 into v[j],
  // dir-PE j = 0, 1 into v[4 + j]. With C0 a template parameter every lane
  // index is known at compile time, so pe_lane's branches fold away and x
  // and d stay in registers (with lanes chosen at run time K4 took about
  // 15 % longer on an H100; PERF.md).
  template <int C0>
  __device__ __forceinline__ static void encode(const Net& net,
                                                const float (&x)[3],
                                                const float (&d)[3],
                                                uint4 (&v)[6]) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      __align__(16) bf16 lanes[8];
      const int c = C0 + 2 * (j < 4 ? j : j - 4);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        lanes[k] = __float2bfloat16(
            j < 4 ? pe_lane(x, 8 * c + k, net.multires)
                  : pe_lane(d, 8 * c + k, net.multires_views));
      v[j] = *reinterpret_cast<const uint4*>(lanes);
    }
  }

  // Thread t of the warpgroup fills row t % 64 of both tiles, its 16-byte
  // chunks (8 lanes each) c0 + 2 j, c0 = t / 64 (the same in every thread
  // of a warp): one row's inputs per thread, all loaded before the first
  // store.
  __device__ __forceinline__ void fill(const Net& net, bf16* pe_g,
                                       bf16* ped_g, int row0, int n_pts,
                                       int wtid) const {
    const int row = wtid & 63, c0 = wtid >> 6;
    const size_t p = row0 + row;
    const bool live = row0 + row < n_pts;
    uint4 v[6];  // xyz-PE chunks c0 + 0, 2, 4, 6; dir-PE chunks c0 + 0, 2
    if constexpr (ENCODED) {
      const uint4* pa = static_cast<const uint4*>(a) + p * (PE_PAD / 8);
      const uint4* pb = static_cast<const uint4*>(b) + p * (PED_PAD / 8);
#pragma unroll
      for (int j = 0; j < 6; ++j)
        v[j] = !live ? make_uint4(0, 0, 0, 0)
                     : j < 4 ? pa[c0 + 2 * j] : pb[c0 + 2 * (j - 4)];
    } else {
      float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
      if (live) {
        const float* pa = static_cast<const float*>(a) + p * 3;
        const float* pb = static_cast<const float*>(b) + p * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          x[k] = pa[k];
          d[k] = pb[k];
        }
      }
      if (c0 == 0)
        encode<0>(net, x, d, v);
      else
        encode<1>(net, x, d, v);
      if (!live) {
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] = make_uint4(0, 0, 0, 0);
      }
    }
    static_assert(PED_PAD == 32, "dir-PE rows are 4 chunks");
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 2 * j;
      *reinterpret_cast<uint4*>(pe_g + swz(row, 8 * c)) = v[j];
      *reinterpret_cast<uint4*>(ped_g + swz(row, 8 * c)) =
          j < 2 ? v[4 + j] : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ const float* view_bias(const Net& net,
                                                    int) const {
    return fvec(net, SLOT_BV);
  }
  __device__ __forceinline__ float* raw() const { return out; }
};

// Shared memory of a point kernel: 1,024 bytes to align the base, the ring
// of n_ring stages, two warpgroups' PE / trunk / view / dir-PE tiles, 128
// bytes of mbarriers.
__host__ __device__ inline size_t point_smem_bytes(int n_ring) {
  return 1024 + static_cast<size_t>(n_ring) * STAGE_BYTES +
         2 * PointTile<false>::kTileBytes + 128;
}

// The block's run of tiles: points [p0, p0 + tiles_per_block x DT) of N.
template <bool ENCODED>
__device__ __forceinline__ void point_block(char* smem_raw, const Net& net,
                                            const bf16* __restrict__ wstream,
                                            int n_stages, const void* a,
                                            const void* b, float* out, int N,
                                            int tiles_per_block, int n_ring,
                                            int a_width, int b_width) {
  const Chain c =
      chain_begin(smem_raw, n_ring, PointTile<ENCODED>::kTileBytes);
  const int p0 = blockIdx.x * tiles_per_block * DT;
  const int n_pts = min(tiles_per_block * DT, N - p0);
  const size_t elem = ENCODED ? sizeof(bf16) : sizeof(float);
  const PointTile<ENCODED> src{
      static_cast<const char*>(a) + static_cast<size_t>(p0) * a_width * elem,
      static_cast<const char*>(b) + static_cast<size_t>(p0) * b_width * elem,
      out + static_cast<size_t>(p0) * 4};
  chain_mlp(net, src, c, wstream, n_stages, n_pts);
}

__global__ void __launch_bounds__(D_THREADS, 1)
k_point_mlp(Net net, const bf16* __restrict__ wstream, int n_stages,
            const float* __restrict__ pts, const float* __restrict__ dirs,
            float* __restrict__ out, int N, int tiles_per_block,
            int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  point_block<false>(smem_raw, net, wstream, n_stages, pts, dirs, out, N,
                     tiles_per_block, n_ring, 3, 3);
}

__global__ void __launch_bounds__(D_THREADS, 1)
k_point_mlp_pe(Net net, const bf16* __restrict__ wstream, int n_stages,
               const bf16* __restrict__ pe, const bf16* __restrict__ ped,
               float* __restrict__ out, int N, int tiles_per_block,
               int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  point_block<true>(smem_raw, net, wstream, n_stages, pe, ped, out, N,
                    tiles_per_block, n_ring, PE_PAD, PED_PAD);
}

template <typename K, typename A>
int launch_points(K kernel, const A* a, const A* b, float* out, int N,
                  int tiles_per_block, const unsigned long long* slots,
                  int depth, int n_views, int multires, int multires_views,
                  const void* wstream, int n_stages, int n_ring,
                  void* stream) {
  if (tiles_per_block < 1) return cudaErrorInvalidValue;
  const size_t bytes = point_smem_bytes(n_ring);
  cudaError_t err = chain_prepare(
      kernel, bytes, chain_stages(slots, depth, n_views) + 1, n_stages,
      n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net net = make_net(slots, depth, n_views, multires, multires_views, 0);
  const int tiles = (N + DT - 1) / DT;
  const int grid = (tiles + tiles_per_block - 1) / tiles_per_block;
  kernel<<<grid, D_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const bf16*>(wstream), n_stages, a, b, out, N,
      tiles_per_block, n_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fr

extern "C" {

unsigned long long fr_point_smem_bytes(int n_ring) {
  return fr::point_smem_bytes(n_ring);
}

// wstream: n_stages stages of the net's weight stream with the dir-PE
// stage (16-byte aligned); blocks of tiles_per_block 128-point tiles;
// n_ring: stages of the shared-memory ring (2..MAX_RING).
int fr_point_mlp(const float* pts, const float* dirs, float* out, int N,
                 int tiles_per_block, const unsigned long long* slots,
                 int depth, int n_views, int multires, int multires_views,
                 const void* wstream, int n_stages, int n_ring,
                 void* stream) {
  return fr::launch_points(fr::k_point_mlp, pts, dirs, out, N,
                           tiles_per_block, slots, depth, n_views, multires,
                           multires_views, wstream, n_stages, n_ring, stream);
}

int fr_point_mlp_pe(const void* pe, const void* ped, float* out, int N,
                    int tiles_per_block, const unsigned long long* slots,
                    int depth, int n_views, const void* wstream, int n_stages,
                    int n_ring, void* stream) {
  return fr::launch_points(fr::k_point_mlp_pe,
                           static_cast<const fr::bf16*>(pe),
                           static_cast<const fr::bf16*>(ped), out, N,
                           tiles_per_block, slots, depth, n_views, 0, 0,
                           wstream, n_stages, n_ring, stream);
}

}  // extern "C"
