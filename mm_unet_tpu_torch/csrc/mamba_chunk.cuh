// The per-chunk recompute shared by the fused Mamba forward and backward
// kernels: causal depthwise conv + SiLU, x_proj and dt_proj + softplus for T
// tokens of one (batch, group) row, into shared memory. Same formulas and
// bf16 rounding points as mm_unet_tpu/ops/mamba_fused.py::_conv_streams and
// _proj_tiles.
#pragma once

#include "common.cuh"

namespace mmu {

constexpr int kS = 16;     // tokens per sub-chunk whose per-token values live in registers
constexpr int kAhead = 8;  // chunks whose loads a combine pass issues together

// Sums, over the N lanes of each state group, one value per token of a
// sub-chunk, v[j] for token j < kS, and scatters the sums: at each level a
// lane keeps the half of its tokens that its lane bit selects and adds its
// partner's copy of that half, so the group spends kS - 1 shuffles where a
// sum per token would spend kS log2(N). After it, lane n's v[i], i < kS / Ne,
// holds the group's sum for token (n % N) / (N / Ne) * (kS / Ne) + i, where
// Ne = min(N, kS) (for N = 32 lanes n and n ^ 1 hold the same sums). Every
// lane of the warp must call it.
template <int N>
__device__ __forceinline__ void group_sum_scatter(float (&v)[kS], int lane) {
  int cnt = kS;
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    if (cnt > 1) {
      const bool hi = lane & off;
      cnt /= 2;
#pragma unroll
      for (int i = 0; i < kS / 2; ++i) {
        if (i < cnt) {
          const float send = hi ? v[i] : v[i + cnt];
          v[i] = (hi ? v[i + cnt] : v[i]) + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
}

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
// zero past L (an identity step of the scan). Each row takes T + 1 floats:
// the odd row length puts neighbouring channels' rows, and the N state rows
// read at one token, in distinct shared-memory banks. x_proj @ u is tiled
// over registers (T even). Ends with __syncthreads().
template <typename TI>
__device__ void recompute_chunk(const TI* x, int D, int L, int T, int t0, int R, int N, int W,
                                bool reverse, const float* cw, const float* cb, const float* xp,
                                const float* dtw, const float* dtb, float* u_s, float* dt_s,
                                float* xd_s) {
  const int E = R + 2 * N, ld = T + 1;
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T, gt = t0 + t;
    u_s[d * ld + t] = gt < L
        ? round_to<TI>(silu(conv_pre(x + (size_t)d * L, cw + d * W, cb[d], gt, L, W, reverse)))
        : 0.f;
  }
  __syncthreads();
  // a thread takes 4 rows of x_dbl and the tokens t and t + T / 2, so each
  // weight and u value it reads feeds several products (a clamped row past
  // the edge is read, not written)
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
  __syncthreads();
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T;
    float v = 0.f;
    if (t0 + t < L) {
      float acc = dtb[d];
      for (int r = 0; r < R; ++r) acc += dtw[d * R + r] * xd_s[r * ld + t];
      v = softplus(acc);
    }
    dt_s[d * ld + t] = v;
  }
  __syncthreads();
}

}  // namespace mmu
