// K1-K3 (fused_render.cuh) at W=256: one translation unit per width, so
// that the build compiles the widths in parallel.
#include "fused_render.cuh"

FR_RENDER_ENTRIES(256)

// The entries every width shares.
extern "C" {

int fr_num_slots() { return fr::NSLOTS; }

// The chain's ring: bytes per stage, the most stages it may hold.
int fr_stage_bytes() { return fr::STAGE_BYTES; }
int fr_max_ring() { return fr::MAX_RING; }

const char* fr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
