// The paper width's names (W=256, view branch 128) for the
// kernel-diagnosis probes (kdiag.cu, kdiag_pe.cu, kdiag_dtype.cu), which
// run at that width only, as the JAX package's probe scripts do; the
// production kernels take their widths from chain.cuh's Layout<W>.
#pragma once

#include "chain.cuh"

namespace fr {

using PW = Layout<256>;
constexpr int W = PW::W, WV = PW::WV;
constexpr int KC_W = PW::KC_W, KC_V = PW::KC_V;
constexpr int H_TILE = PW::H_TILE, HV_TILE = PW::HV_TILE;
constexpr int WG_BYTES = PW::WG_BYTES;
constexpr int DT = PW::DT;

}  // namespace fr
