// K6's passes (fused_mlp_grad.cuh), bf16 and f32, at W=512: one translation
// unit per width, so that the build compiles the widths in parallel.
#include "fused_mlp_grad.cuh"

FR_GRAD_ENTRIES(512)
