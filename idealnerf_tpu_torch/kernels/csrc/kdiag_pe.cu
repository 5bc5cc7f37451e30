// The kernel-diagnosis probes on given encodings, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by kernels/kdiag.py
// beside kdiag.cu's:
//
// kd_ladder    replaces scripts/kdiag2.py (:114, rungs v0-v2): K5
//              (fused_mlp.cuh k_point_mlp_pe) stopped early on its own
//              chain, plan and a prefix of its weight stream: the trunk
//              without the skip's pe-part (v0: a slot table and stream of
//              the net without it, 58 stages for the paper model), the
//              whole trunk (v1, 60), + the view branch with its dir-PE
//              product (v2, 69 of K5's 70); the last activation goes out as
//              bf16 rows (chain.cuh ActivationTile). Rungs v3 and v4 are
//              K5 and K4 themselves, which kernels/kdiag.py launches.
// kd_render_a  replaces scripts/kdiag3.py (kernel_A, :269): the ray-organised
//              MLP from a given (R*S, 64) bf16 xyz-PE and a per-ray (R, 32)
//              dir-PE -> raw (R, S*4), no compositing: K1's chain, stream
//              and launch plan with the PE rows copied into the tile
//              (chain.cuh PeRayTile), pv built per ray as load_rays builds
//              it. Probe B (kdiag.cu) less probe A is the PE built in the
//              kernel.
//
// What bounds them on the card: tensor-core work. A ladder point costs 0.5
// M MACs against 192 bytes in and 256-512 out, a probe A point 557 k
// against its 128-byte PE row in (and its ray's dir-PE) and 16 bytes out.
//
// They live apart from kdiag.cu: compiled in one unit with probe B, they
// made ptxas serialize probe B's wgmma products ("insufficient register
// resources for the wgmma pipeline", C7511) and probe B ran 12 % slower on
// an H100 (PERF.md); alone, kdiag.cu compiles probe B as before.
#include "chain.cuh"
#include "paper.cuh"

namespace fr {
namespace kd {

// -------------------------------------------------- the ladder: K5's chain

// kdiag2 v0-v2 on the block's run of tiles_per_block 128-point tiles (K5's
// plan): ActivationTile's fill of the given encodings, the chain stopped
// after the trunk (LAST_TRUNK: v0 and v1, told apart by the slot table and
// stream) or after the view branch (LAST_VIEW: v2), the last activation
// out as bf16 rows.
template <int LAST>
__global__ void __launch_bounds__(D_THREADS, 1)
k_mlp_ladder(Net net, const bf16* __restrict__ wstream, int n_stages,
             const bf16* __restrict__ pe, const bf16* __restrict__ ped,
             bf16* __restrict__ out, int N, int tiles_per_block,
             int n_ring) {
  using Src = ActivationTile<LAST, PW>;
  extern __shared__ __align__(1024) char smem_raw[];
  const Chain c = chain_begin(smem_raw, n_ring, Src::kTileBytes);
  const size_t p0 = static_cast<size_t>(blockIdx.x) * tiles_per_block * DT;
  const int n_pts = min(tiles_per_block * DT, N - static_cast<int>(p0));
  chain_mlp(net,
            Src{pe + p0 * PE_PAD, ped + p0 * PED_PAD, out + p0 * Src::kWidth},
            c, wstream, n_stages, n_pts);
}

// A rung's launch: the stream must hold the trunk's stages (v0, v1) or
// the trunk's, the view branch's and its dir-PE stage (v2).
template <int LAST>
cudaError_t launch_ladder(const Net& net, const unsigned long long* slots,
                          const void* pe, const void* ped, void* out, int N,
                          int tiles_per_block, const void* wstream,
                          int n_stages, int n_ring, cudaStream_t st) {
  const size_t bytes = point_smem_bytes<PW>(n_ring);
  const int want = trunk_stages<PW>(slots, net.depth) +
                   (LAST == LAST_VIEW ? view_stages<PW>(net.n_views) + 1 : 0);
  cudaError_t err =
      chain_prepare(k_mlp_ladder<LAST>, bytes, want, n_stages, n_ring);
  if (err != cudaSuccess) return err;
  const int tiles = (N + DT - 1) / DT;
  k_mlp_ladder<LAST><<<(tiles + tiles_per_block - 1) / tiles_per_block,
                       D_THREADS, bytes, st>>>(
      net, static_cast<const bf16*>(wstream), n_stages,
      static_cast<const bf16*>(pe), static_cast<const bf16*>(ped),
      static_cast<bf16*>(out), N, tiles_per_block, n_ring);
  return cudaGetLastError();
}

// ------------------------------------------------ probe A: K1's chain

// Probe A's per-ray state: the dir-PE as f32 and pv, each region 128-byte
// aligned.
__host__ __device__ inline size_t probe_a_layout(char* base, int rb,
                                                 Smem* sm) {
  const size_t ped = (sizeof(float) * rb * PED_PAD + 127) & ~size_t{127};
  const size_t pv = (sizeof(float) * rb * WV + 127) & ~size_t{127};
  if (sm != nullptr) {
    *sm = Smem{};
    sm->ped = reinterpret_cast<float*>(base);
    sm->pv = reinterpret_cast<float*>(base + ped);
  }
  return ped + pv;
}

// Dynamic shared memory of probe A: K1's ring, tiles and mbarriers, then
// its per-ray state.
__host__ __device__ inline size_t probe_a_smem(int rb, int n_ring) {
  return 1024 + ray_state_offset<PW>(n_ring) +
         probe_a_layout(nullptr, rb, nullptr);
}

// kdiag3 A: K1's chain on given encodings: the block's dir-PE rows read
// and pv built (view_terms, load_rays' order), then chain_mlp with
// PeRayTile, whose fill copies each point's PE row and whose raw rows go
// to the block's rows of the global (R, S*4) output; no composite.
__global__ void __launch_bounds__(D_THREADS, 1)
k_render_probe_a(Net net, const bf16* __restrict__ wstream, int n_stages,
                 const bf16* __restrict__ pe, const bf16* __restrict__ ped,
                 float* __restrict__ raw, int R, int S, int rb, int n_ring) {
  extern __shared__ __align__(1024) char smem_raw[];
  const Chain c = chain_begin(smem_raw, n_ring, WG_BYTES);
  Smem sm;
  probe_a_layout(c.gbase + ray_state_offset<PW>(n_ring), rb, &sm);
  const int tid = ray_tid();
  const int ray0 = blockIdx.x * rb;
  const int nr = min(rb, R - ray0), n_pts = nr * S;

  for (int e = tid; e < nr * PED_PAD; e += NTHREADS)
    sm.ped[e] =
        __bfloat162float(ped[static_cast<size_t>(ray0) * PED_PAD + e]);
  __syncthreads();
  view_terms<WV>(net, sm, nr, tid);
  const size_t p0 = static_cast<size_t>(ray0) * S;
  chain_mlp(net, PeRayTile<PW>{pe + p0 * PE_PAD, sm.pv, raw + p0 * 4, S, nr}, c,
            wstream, n_stages, n_pts);
}

}  // namespace kd
}  // namespace fr

extern "C" {

// stage 0: trunk only -> (N, 256) bf16 (slots and wstream of the net
// without its skip pe-part); 1: + skip -> (N, 256); 2: + view branch ->
// (N, 128). wstream: n_stages stages of the net's point stream
// (fused_render.chain_weight_stream(net, dir_stage=True)), blocks of
// tiles_per_block 128-point tiles, a ring of n_ring stages.
int kd_ladder(const void* pe, const void* ped, void* out, int N, int stage,
              int tiles_per_block, const unsigned long long* slots,
              int depth, int n_views, const void* wstream, int n_stages,
              int n_ring, void* stream) {
  using namespace fr;
  bool skipless = true;
  for (int i = 0; i < MAXD; ++i) skipless &= slots[SLOT_WSKIP + i] == 0;
  if (tiles_per_block < 1 || (stage == 0 && !skipless))
    return static_cast<int>(cudaErrorInvalidValue);
  const Net net = make_net(slots, depth, n_views, 0, 0, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (stage == 0 || stage == 1)
    err = kd::launch_ladder<LAST_TRUNK>(net, slots, pe, ped, out, N,
                                        tiles_per_block, wstream, n_stages,
                                        n_ring, st);
  if (stage == 2)
    err = kd::launch_ladder<LAST_VIEW>(net, slots, pe, ped, out, N,
                                       tiles_per_block, wstream, n_stages,
                                       n_ring, st);
  return static_cast<int>(err);
}

unsigned long long kd_render_a_smem_bytes(int rb, int, int n_ring) {
  return fr::kd::probe_a_smem(rb, n_ring);
}

// Probe A at K1's launch: wstream, n_stages and n_ring as fr_render_rays
// takes them; one block per group of rb rays.
int kd_render_a(const void* pe, const void* ped, float* raw, int R, int S,
                int rb, const unsigned long long* slots, int depth,
                int n_views, const void* wstream, int n_stages, int n_ring,
                void* stream) {
  const size_t bytes = fr::kd::probe_a_smem(rb, n_ring);
  cudaError_t err = fr::chain_prepare(
      fr::kd::k_render_probe_a, bytes,
      fr::chain_stages<fr::PW>(slots, depth, n_views), n_stages, n_ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fr::Net net = fr::make_net(slots, depth, n_views, 0, 0, 0);
  fr::kd::k_render_probe_a<<<(R + rb - 1) / rb, fr::D_THREADS, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const fr::bf16*>(wstream), n_stages,
      static_cast<const fr::bf16*>(pe), static_cast<const fr::bf16*>(ped),
      raw, R, S, rb, n_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
