// The per-chunk recompute shared by the fused Mamba forward and backward
// kernels: causal depthwise conv + SiLU, x_proj and dt_proj + softplus for T
// tokens of one (batch, group) row, into shared memory. Same formulas and
// bf16 rounding points as mm_unet_tpu/ops/mamba_fused.py::_conv_streams and
// _proj_tiles.
#pragma once

#include "common.cuh"

namespace mmu {

// conv pre-activation at token gt (< L): bias + sum_k w_k x[gt -+ (W-1-k)],
// taps read straight from xz (the halo across a chunk edge is a neighbour's
// tokens); `reverse` is the anti-causal conv of the right-to-left scan
template <typename TI>
__device__ __forceinline__ float conv_pre(const TI* x, const float* cw, float cb, int gt, int L,
                                          int W, bool reverse) {
  float acc = cb;
  for (int k = 0; k < W; ++k) {
    const int s = W - 1 - k;
    const int src = reverse ? gt + s : gt - s;
    if (src >= 0 && src < L) acc += cw[k] * to_f32(x[src]);
  }
  return acc;
}

// u_s [D][T] = round(silu(conv)), xd_s [R+2N][T] = x_proj @ u (the R dt
// rows rounded), dt_s [D][T] = softplus(dt_proj @ x_dbl[:R] + dt_b); all
// zero past L (an identity step of the scan). Ends with __syncthreads().
template <typename TI>
__device__ void recompute_chunk(const TI* x, int D, int L, int T, int t0, int R, int N, int W,
                                bool reverse, const float* cw, const float* cb, const float* xp,
                                const float* dtw, const float* dtb, float* u_s, float* dt_s,
                                float* xd_s) {
  const int E = R + 2 * N;
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T, gt = t0 + t;
    u_s[i] = gt < L
        ? round_to<TI>(silu(conv_pre(x + (size_t)d * L, cw + d * W, cb[d], gt, L, W, reverse)))
        : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < E * T; i += blockDim.x) {
    const int e = i / T, t = i - e * T;
    const float* row = xp + (size_t)e * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += row[d] * u_s[d * T + t];
    xd_s[i] = e < R ? round_to<TI>(acc) : acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T;
    float v = 0.f;
    if (t0 + t < L) {
      float acc = dtb[d];
      for (int r = 0; r < R; ++r) acc += dtw[d * R + r] * xd_s[r * T + t];
      v = softplus(acc);
    }
    dt_s[i] = v;
  }
  __syncthreads();
}

}  // namespace mmu
