// K1-K3 (fused_render.cuh) at W=128: one translation unit per width, so
// that the build compiles the widths in parallel.
#include "fused_render.cuh"

FR_RENDER_ENTRIES(128)
