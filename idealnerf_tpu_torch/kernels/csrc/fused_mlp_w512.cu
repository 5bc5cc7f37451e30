// K4 and K5 (fused_mlp.cuh) at W=512: one translation unit per width, so
// that the build compiles the widths in parallel.
#include "fused_mlp.cuh"

FR_POINT_ENTRIES(512)
