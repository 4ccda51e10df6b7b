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
// zero past L (an identity step of the scan). Each row takes T + PAD
// floats: the backward's odd row length puts neighbouring channels' rows,
// and the N state rows read at one token, in distinct shared-memory banks;
// the backward (PAD > 0) also tiles x_proj @ u over registers (T even).
// Ends with __syncthreads().
template <typename TI, int PAD = 0>
__device__ void recompute_chunk(const TI* x, int D, int L, int T, int t0, int R, int N, int W,
                                bool reverse, const float* cw, const float* cb, const float* xp,
                                const float* dtw, const float* dtb, float* u_s, float* dt_s,
                                float* xd_s) {
  const int E = R + 2 * N, ld = T + PAD;
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T, gt = t0 + t;
    u_s[PAD ? d * ld + t : i] = gt < L
        ? round_to<TI>(silu(conv_pre(x + (size_t)d * L, cw + d * W, cb[d], gt, L, W, reverse)))
        : 0.f;
  }
  __syncthreads();
  if constexpr (PAD > 0) {
    // a thread takes 4 rows of x_dbl and the tokens t and t + T / 2, so
    // each weight and u value it reads feeds several products (a clamped
    // row past the edge is read, not written)
    const int Th = T / 2;
    for (int i = threadIdx.x; i < Th * ((E + 3) / 4); i += blockDim.x) {
      const int t = i % Th, e0 = i / Th * 4;
      float a0[4] = {}, a1[4] = {};
      for (int d = 0; d < D; ++d) {
        const float u0 = u_s[d * ld + t], u1 = u_s[d * ld + t + Th];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wv = xp[(size_t)min(e0 + j, E - 1) * D + d];
          a0[j] += wv * u0;
          a1[j] += wv * u1;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j;
        if (e >= E) break;
        xd_s[e * ld + t] = e < R ? round_to<TI>(a0[j]) : a0[j];
        xd_s[e * ld + t + Th] = e < R ? round_to<TI>(a1[j]) : a1[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < E * T; i += blockDim.x) {
      const int e = i / T, t = i - e * T;
      const float* row = xp + (size_t)e * D;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += row[d] * u_s[d * ld + t];
      xd_s[PAD ? e * ld + t : i] = e < R ? round_to<TI>(acc) : acc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T;
    float v = 0.f;
    if (t0 + t < L) {
      float acc = dtb[d];
      for (int r = 0; r < R; ++r) acc += dtw[d * R + r] * xd_s[r * ld + t];
      v = softplus(acc);
    }
    dt_s[PAD ? d * ld + t : i] = v;
  }
  __syncthreads();
}

}  // namespace mmu
