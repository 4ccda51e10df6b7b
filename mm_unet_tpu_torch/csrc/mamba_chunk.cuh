// The per-chunk recompute shared by the fused Mamba forward and backward
// kernels: causal depthwise conv + SiLU, x_proj and dt_proj + softplus for T
// tokens of one (batch, group) row, into shared memory, and the x_dbl pass
// that both run where a chunk's channels span several blocks. Same formulas and
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

// u_s [nd][T] = round(silu(conv)) of the channels d0 .. d0 + nd - 1 (cw and
// cb index the absolute channel, u_s the block's own rows), zero past L.
// Each row takes T + 1 floats: the odd row length puts neighbouring
// channels' rows, and the N state rows read at one token, in distinct
// shared-memory banks.
template <typename TI>
__device__ void conv_rows(const TI* x, int d0, int nd, int L, int T, int t0, int W, bool reverse,
                          const float* cw, const float* cb, float* u_s) {
  const int ld = T + 1;
  for (int i = threadIdx.x; i < nd * T; i += blockDim.x) {
    const int dl = i / T, t = i - dl * T, gt = t0 + t, d = d0 + dl;
    u_s[dl * ld + t] = gt < L
        ? round_to<TI>(silu(conv_pre(x + (size_t)d * L, cw + d * W, cb[d], gt, L, W, reverse)))
        : 0.f;
  }
}

// xd_s [E][T] = x_proj[:, d0:d0+nd] @ u_s, continued from the sums xd_s
// holds unless `first`; with `last`, the R dt rows are rounded. A thread
// takes 4 rows and the tokens t and t + T / 2 (T even), so each weight and
// u value it reads feeds several products (a clamped row past the edge is
// read, not written); it keeps the same rows and tokens at every call, and
// its sums run over the channels in order, so slices of the channels give
// the sums of one pass over all of them, bit for bit.
template <typename TI>
__device__ void xproj_rows(int D, int d0, int nd, int T, int R, int E, const float* xp,
                           const float* u_s, float* xd_s, bool first, bool last) {
  const int ld = T + 1, Th = T / 2;
  for (int i = threadIdx.x; i < Th * ((E + 3) / 4); i += blockDim.x) {
    const int t = i % Th, e0 = i / Th * 4;
    float a0[4], a1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = min(e0 + j, E - 1);
      a0[j] = first ? 0.f : xd_s[e * ld + t];
      a1[j] = first ? 0.f : xd_s[e * ld + t + Th];
    }
    for (int dl = 0; dl < nd; ++dl) {
      const float u0 = u_s[dl * ld + t], u1 = u_s[dl * ld + t + Th];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = xp[(size_t)min(e0 + j, E - 1) * D + d0 + dl];
        a0[j] += wv * u0;
        a1[j] += wv * u1;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j;
      if (e >= E) break;
      const bool rnd = last && e < R;
      xd_s[e * ld + t] = rnd ? round_to<TI>(a0[j]) : a0[j];
      xd_s[e * ld + t + Th] = rnd ? round_to<TI>(a1[j]) : a1[j];
    }
  }
}

// dt_s [nd][T] = softplus(dt_proj[d0:d0+nd] @ x_dbl[:R] + dt_b), zero past L
__device__ __forceinline__ void dt_rows(int d0, int nd, int L, int T, int t0, int R,
                                        const float* dtw, const float* dtb, const float* xd_s,
                                        float* dt_s) {
  const int ld = T + 1;
  for (int i = threadIdx.x; i < nd * T; i += blockDim.x) {
    const int dl = i / T, t = i - dl * T, d = d0 + dl;
    float v = 0.f;
    if (t0 + t < L) {
      float acc = dtb[d];
      for (int r = 0; r < R; ++r) acc += dtw[d * R + r] * xd_s[r * ld + t];
      v = softplus(acc);
    }
    dt_s[dl * ld + t] = v;
  }
}

// u_s [D][T] = round(silu(conv)), xd_s [R+2N][T] = x_proj @ u (the R dt
// rows rounded), dt_s [D][T] = softplus(dt_proj @ x_dbl[:R] + dt_b); all
// zero past L (an identity step of the scan). Ends with __syncthreads().
template <typename TI>
__device__ void recompute_chunk(const TI* x, int D, int L, int T, int t0, int R, int N, int W,
                                bool reverse, const float* cw, const float* cb, const float* xp,
                                const float* dtw, const float* dtb, float* u_s, float* dt_s,
                                float* xd_s) {
  conv_rows<TI>(x, 0, D, L, T, t0, W, reverse, cw, cb, u_s);
  __syncthreads();
  xproj_rows<TI>(D, 0, D, T, R, R + 2 * N, xp, u_s, xd_s, true, true);
  __syncthreads();
  dt_rows(0, D, L, T, t0, R, dtw, dtb, xd_s, dt_s);
  __syncthreads();
}

constexpr int kXdblThreads = 256;  // threads of a block of the x_dbl pass

// The x_dbl pass of both kernels, where a chunk's channels span several
// blocks: x_dbl of one chunk of one (batch, group) row over all D channels
// into its (E, L) rows xg, the D channels streamed through shared memory Dc
// at a time (u_s: conv + SiLU of a slice, xd_s: the E sums); the R dt rows
// rounded to the stream dtype. x_dbl is the one sum over channels that the
// chunk's scan chains need before they start. Each thread keeps the same
// rows and tokens across the slices (`xproj_rows`), so the sums run over
// the channels in order: the bits of `recompute_chunk`'s x_dbl, in the
// forward and in the backward alike.
template <typename TI>
__device__ void xdbl_chunk(const TI* x, int D, int L, int T, int t0, int R, int E, int W, int Dc,
                           bool reverse, const float* cw, const float* cb, const float* xp,
                           float* u_s, float* xd_s, float* xg) {
  const int ld = T + 1;
  for (int d0 = 0; d0 < D; d0 += Dc) {
    const int nd = min(Dc, D - d0);
    conv_rows<TI>(x, d0, nd, L, T, t0, W, reverse, cw, cb, u_s);
    __syncthreads();
    xproj_rows<TI>(D, d0, nd, T, R, E, xp, u_s, xd_s, d0 == 0, d0 + Dc >= D);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < E * T; i += blockDim.x) {
    const int e = i / T, t = i - e * T, gt = t0 + t;
    if (gt < L) xg[(size_t)e * L + gt] = xd_s[e * ld + t];
  }
}

// The chunk's inputs of one of the blocks a chunk's channels span: the conv
// output u_s and dt_s of its nd channels from d0, and the chunk's x_dbl
// xd_s read from the x_dbl pass's rows xg (0 past L). Ends with
// __syncthreads().
template <typename TI>
__device__ void split_inputs(const TI* x, const float* xg, int d0, int nd, int L, int T, int t0,
                             int R, int N, int W, bool reverse, const float* cw, const float* cb,
                             const float* dtw, const float* dtb, float* u_s, float* dt_s,
                             float* xd_s) {
  const int E = R + 2 * N, ld = T + 1;
  conv_rows<TI>(x, d0, nd, L, T, t0, W, reverse, cw, cb, u_s);
  for (int i = threadIdx.x; i < E * T; i += blockDim.x) {
    const int e = i / T, t = i - e * T, gt = t0 + t;
    xd_s[e * ld + t] = gt < L ? xg[(size_t)e * L + gt] : 0.f;
  }
  __syncthreads();
  dt_rows(d0, nd, L, T, t0, R, dtw, dtb, xd_s, dt_s);
  __syncthreads();
}

}  // namespace mmu
