// Fused Mamba-inner backward for Hopper: the adjoint of mamba_fused_fwd.cu
// (causal conv + SiLU, x_proj, dt_proj + softplus, selective scan, silu(z)
// gate), from the chunk-entry states the forward kept.
//
// Replaces the TPU kernel mm_unet_tpu/ops/mamba_fused.py::_mega_bwd_kernel
// (launched by _mega_core._bwd_call), with core_bwd's host sums over batch.
// Per token, with g the adjoint state (g_t = dy_t C_t + a_{t'} g_{t'}, t' the
// next token in scan order) and dy = dout * silu(z):
//   du = dt * sum_n g B + dy * D          dz = dout * y_pre * silu'(z)
//   ddt_raw = (sum_n g (h - b) A + u sum_n g B) * sigmoid(dt_raw)
//   dB = sum_d g dt u    dC = sum_d h dy  dA = sum_t g (h - b) dt   dD = sum_t dy u
// where h - b = a h_prev (the pre-fold b keeps the cross-chunk term). Then
// x_dbl's gradient [dt_w^T ddt_raw; dB; dC], the conv output's gradient
// x_proj^T dx_dbl + du, through silu' to dpre, and the transposed conv taps.
// Under bf16, ddt_raw and dx_dbl are rounded before their products and dxz
// is written in the stream dtype, where the TPU kernel rounds.
//
// The TPU carries g, the edge decay and the neighbour chunk's dpre across a
// sequential grid axis; Hopper blocks run in no order, so the design
// mirrors the forward's three passes, one block per (batch, chunk of T
// tokens):
//   A. each block recomputes conv, x_proj and dt into shared memory and runs
//      the adjoint across its chunk from a zero carry, emitting the boundary
//      adjoint a_edge * g_edge per (d, n);
//   B. a small kernel walks the chunks against the scan direction per
//      (b, d, n), turning the local boundary adjoints into true carries
//      (a chunk's decay is exp(A * sum dt), the forward's saved sum);
//   C. each block rebuilds h from the saved entry state, walks back with g
//      from the true carry and accumulates every per-token and
//      per-parameter term; then the projection products, dz, and dpre into
//      an f32 (B, G, D, L) scratch;
//   D. a depthwise kernel turns dpre into dx (including the W-1 tokens that
//      cross each chunk edge) and the conv weight and bias gradients.
// Parameter gradients are per-block partials in f32, summed by the wrapper
// (as core_bwd sums over batch on the host): no global atomics, so every
// gradient is the same from run to run.
//
// What bounds it on the H100: not device memory (at D = 128 the bytes it
// must move take about 2% of its time) but the shared-memory and shuffle traffic of pass C, issued
// through the SM's one memory pipe, and the latency of its dependent
// chains. One thread walks one (channel d, state n) chain; per token it
// reads dt, u, dy, B and C and its terms must be summed over the N states
// and over the channels. The design cuts that traffic three ways:
//   - rows of T + 1 floats: every per-chunk row in shared memory has an odd
//     length, so the N state lanes of a channel that read B or C, or add to
//     dB or dC, at one token hit N distinct banks (rows of T floats put
//     them in one bank: N-way conflicts on every token), as do neighbouring
//     channels reading their rows at one token and the small products
//     reading u across channels;
//   - h in registers: pass C walks its chunk in sub-chunks of kS tokens. A
//     first walk keeps the state entering each sub-chunk in shared memory,
//     one column per thread; each sub-chunk's states and decays are rebuilt
//     into unrolled register arrays just before its adjoint walk. One more
//     forward walk buys a per-thread chunk buffer out of local memory (no
//     stack frame);
//   - sums over the states by a scattering butterfly: during a sub-chunk's
//     adjoint each lane keeps its terms of sum_n g B, sum_n g a h_prev A and
//     sum_n h C per token; a halving butterfly then sums them over the state
//     group and leaves each lane the sums of its own tokens (kS - 1 shuffles
//     per quantity where a sum per token takes kS log2 N), and those lanes
//     write du, ddt and y_pre for kS tokens at once. The sums over the
//     warp's channels stay per token (one shuffle level at N = 16), then one
//     shared-memory atomic per (n, t) and warp.
// The small products (x_dbl = x_proj u, its transpose into dpre, and the
// x_proj gradient) take kTile rows or tokens per thread, so a value read
// from shared memory feeds several products. At MM_Net's widest scan (D =
// 128, R = 4, N = 16, T = 64) pass C holds one 512-thread block per SM: 160
// KB of shared memory and 128 registers a thread, both at the SM's limit.
#include <cstdint>

#include "common.cuh"
#include "mamba_chunk.cuh"

namespace {

constexpr int kS = 16;    // tokens per sub-chunk of pass C, whose states live in registers
constexpr int kTile = 4;  // rows (or tokens) per thread in pass C's small products
constexpr int kMaxW = 8;  // widest conv

struct BwdArgs {
  const void* xz;       // (B, G, 2D, L) stream dtype
  const void* dout;     // (B, G, D, L) stream dtype
  void* dxz;            // (B, G, 2D, L) stream dtype
  const float* conv_w;  // (G, D, W), rounded to the stream dtype
  const float* conv_b;  // (G, D)
  const float* x_proj;  // (G, R + 2N, D), rounded
  const float* dt_w;    // (G, D, R), rounded
  const float* dt_b;    // (G, D)
  const float* A;       // (G, D, N)
  const float* Dskip;   // (G, D)
  const float* state;   // (B, G, nC, D, N) chunk-entry states of the forward
  const float* dtsum;   // (B, G, nC, D) sum of dt per chunk (nC > 1)
  float* gcarry;        // (B, G, nC, D, N) boundary adjoints, then true carries
  float* dpre;          // (B, G, D, L) gradient of the conv pre-activation
  float* p_dxp;         // (B*G*nC, R + 2N, D) partials
  float* p_ddtw;        // (B*G*nC, D, R)
  float* p_ddtb;        // (B*G*nC, D)
  float* p_dA;          // (B*G*nC, D, N)
  float* p_dD;          // (B*G*nC, D)
  float* p_dconv;       // (B*G*nCT, D, W + 1): taps, then bias
  int B, G, D, L, N, R, W, T, nC;
  int conv_tile, nCT;   // tokens per block of the conv backward, and blocks
  bool reverse;
};

struct Row {  // one (batch, group) row's pointers
  const float *cw, *cb, *xp, *dtw, *dtb, *A, *Dv;
};

__device__ __forceinline__ Row row_of(const BwdArgs& a, int g) {
  const int D = a.D, E = a.R + 2 * a.N;
  return {a.conv_w + (size_t)g * D * a.W, a.conv_b + (size_t)g * D, a.x_proj + (size_t)g * E * D,
          a.dt_w + (size_t)g * D * a.R, a.dt_b + (size_t)g * D, a.A + (size_t)g * D * a.N,
          a.Dskip + (size_t)g * D};
}

// dy_s [D][T + 1] = dout * silu(z), 0 past L
template <typename TI>
__device__ void load_dy(const BwdArgs& a, int bg, int t0, float* dy_s) {
  const int D = a.D, L = a.L, T = a.T;
  const TI* z = static_cast<const TI*>(a.xz) + ((size_t)bg * 2 + 1) * D * L;
  const TI* dout = static_cast<const TI*>(a.dout) + (size_t)bg * D * L;
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T, gt = t0 + t;
    dy_s[d * (T + 1) + t] =
        gt < L ? mmu::to_f32(dout[(size_t)d * L + gt]) * mmu::silu(mmu::to_f32(z[(size_t)d * L + gt]))
               : 0.f;
  }
}

// Pass A: the adjoint across one chunk from a zero carry; emits a_edge g_edge.
template <typename TI>
__global__ void mamba_bwd_local_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, N = a.N, R = a.R, ld = T + 1;
  float* u_s = smem;
  float* dt_s = u_s + D * ld;
  float* xd_s = dt_s + D * ld;
  float* dy_s = xd_s + (R + 2 * N) * ld;
  const int c = blockIdx.x, bg = blockIdx.y, t0 = c * T;
  const Row w = row_of(a, bg % a.G);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * a.L;
  load_dy<TI>(a, bg, t0, dy_s);
  mmu::recompute_chunk<TI, 1>(x, D, a.L, T, t0, R, N, a.W, a.reverse, w.cw, w.cb, w.xp, w.dtw,
                              w.dtb, u_s, dt_s, xd_s);
  const float* Cs = xd_s + (R + N) * ld;
  const size_t sbase = (size_t)bg * a.nC + c;
  for (int p = threadIdx.x; p < D * N; p += blockDim.x) {
    const int d = p / N, n = p - d * N;
    const float a_dn = w.A[p];
    float carry = 0.f;
    for (int s = 0; s < T; ++s) {
      const int t = a.reverse ? s : T - 1 - s;  // against the scan direction
      const float g = dy_s[d * ld + t] * Cs[n * ld + t] + carry;
      carry = expf(dt_s[d * ld + t] * a_dn) * g;
    }
    a.gcarry[sbase * D * N + p] = carry;
  }
}

// Pass B: local boundary adjoints -> the true adjoint entering each chunk
// from its successor in scan order. The walk is one dependent chain per
// (b, d, n) with a load per chunk: the loads of kAhead chunks are issued
// together, so a chain waits on memory once per kAhead chunks.
constexpr int kAhead = 8;
__global__ void __launch_bounds__(128) mamba_bwd_combine_kernel(BwdArgs a) {
  const int D = a.D, N = a.N, nC = a.nC;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.B * a.G * D * N) return;
  const int n = i % N, d = (i / N) % D;
  const int64_t bg = i / ((int64_t)D * N);
  const float a_dn = a.A[((size_t)(bg % a.G) * D + d) * N + n];
  float carry = 0.f;
  for (int s0 = 0; s0 < nC; s0 += kAhead) {
    float local[kAhead], dts[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j, c = a.reverse ? s : nC - 1 - s;
      const size_t sc = (size_t)bg * nC + c;
      local[j] = s < nC ? a.gcarry[(sc * D + d) * N + n] : 0.f;
      dts[j] = s < nC ? a.dtsum[sc * D + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j, c = a.reverse ? s : nC - 1 - s;
      if (s < nC) {
        a.gcarry[(((size_t)bg * nC + c) * D + d) * N + n] = carry;
        carry = local[j] + expf(a_dn * dts[j]) * carry;
      }
    }
  }
}

// Sums, over the N lanes of each state group, one value per token of a
// sub-chunk, v[j] for token j < kS, and scatters the sums: at each level a
// lane keeps the half of its tokens that its lane bit selects and adds its
// partner's copy of that half, so the group spends kS - 1 shuffles where a
// sum per token would spend kS log2(N). After it, lane n's v[i], i < kS / Ne,
// holds the group's sum for token (n % N) / (N / Ne) * (kS / Ne) + i, where
// Ne = min(N, kS) (for N = 32 lanes n and n ^ 1 hold the same sums).
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

// Pass C: the full adjoint of one chunk and every term but the conv's.
template <typename TI, int N>
__global__ void __launch_bounds__(512) mamba_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, R = a.R, L = a.L;
  const int E = R + 2 * N, ld = T + 1;  // rows of T + 1 floats
  float* u_s = smem;            // [D] rows: conv output
  float* dt_s = u_s + D * ld;   // [D] dt, overwritten by ddt_raw
  float* xd_s = dt_s + D * ld;  // [E] x_dbl
  float* dy_s = xd_s + E * ld;  // [D] dy, overwritten by y_pre
  float* du_s = dy_s + D * ld;  // [D] du of the scan
  float* xg_s = du_s + D * ld;  // [E] dx_dbl: R dt rows, then dB and dC
  float* dB_s = xg_s + R * ld;
  float* dC_s = dB_s + N * ld;
  float* ck_s = dC_s + N * ld;  // [T / kS][blockDim] sub-chunk entry states

  const int c = blockIdx.x, bg = blockIdx.y, t0 = c * T;
  const Row w = row_of(a, bg % a.G);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L;
  load_dy<TI>(a, bg, t0, dy_s);
  for (int i = threadIdx.x; i < 2 * N * ld; i += blockDim.x) dB_s[i] = 0.f;
  mmu::recompute_chunk<TI, 1>(x, D, L, T, t0, R, N, a.W, a.reverse, w.cw, w.cb, w.xp, w.dtw,
                              w.dtb, u_s, dt_s, xd_s);

  const float* Bs = xd_s + R * ld;
  const float* Cs = Bs + N * ld;
  const int lane = threadIdx.x & 31, nsub = T / kS;
  constexpr int kNe = N < kS ? N : kS;  // lanes of a group that end with distinct sums
  constexpr int kRep = N / kNe;         // lanes that hold each of them
  const size_t blk = (size_t)bg * a.nC + c;  // this chunk: states and partials
  // every lane of a warp runs every walk (lanes past D * N with zero
  // inputs), so the shuffles below always see the full warp
  for (int p0 = 0; p0 < D * N; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < D * N;
    const int pp = live ? p : 0;
    const int d = pp / N, n = pp - d * N;
    const float* dt_d = dt_s + d * ld;
    const float* u_d = u_s + d * ld;
    const float a_dn = w.A[pp];
    const float Dd = w.Dv[d];
    // walk 1, in scan order: the state entering each sub-chunk, into this
    // thread's column of ck_s
    float h = live ? a.state[blk * D * N + pp] : 0.f;
    for (int k = 0; k < nsub; ++k) {
      ck_s[k * blockDim.x + threadIdx.x] = h;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const int s = k * kS + j, t = a.reverse ? T - 1 - s : s;
        const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
        h = expf(dtv * a_dn) * h + dtv * uv * Bs[n * ld + t];
      }
    }
    float carry = (live && a.nC > 1) ? a.gcarry[blk * D * N + pp] : 0.f;
    float dA_acc = 0.f, dD_acc = 0.f;
    for (int k = nsub - 1; k >= 0; --k) {  // sub-chunks against the scan direction
      // rebuild the sub-chunk's states and decays into registers
      float hr[kS], ar[kS], pa[kS];
      h = ck_s[k * blockDim.x + threadIdx.x];
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const int s = k * kS + j, t = a.reverse ? T - 1 - s : s;
        const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
        ar[j] = expf(dtv * a_dn);
        h = ar[j] * h + dtv * uv * Bs[n * ld + t];
        hr[j] = h;
      }
      // the adjoint: g and this lane's terms per token; the sums over the
      // warp's channels at once, the sums over the states after the walk
#pragma unroll
      for (int j = kS - 1; j >= 0; --j) {
        const int s = k * kS + j, t = a.reverse ? T - 1 - s : s;
        const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
        const float dyv = live ? dy_s[d * ld + t] : 0.f;
        const float Bv = Bs[n * ld + t], Cv = Cs[n * ld + t];
        const float g = dyv * Cv + carry;
        const float gah = g * (hr[j] - dtv * uv * Bv);  // g * a * h_prev
        float vB = g * dtv * uv, vC = hr[j] * dyv;
        for (int off = N; off < 32; off <<= 1) {  // sums over the warp's channels
          vB += __shfl_xor_sync(0xffffffffu, vB, off);
          vC += __shfl_xor_sync(0xffffffffu, vC, off);
        }
        if (lane < N) {  // lane == n for live lanes; a dead lane here adds 0
          atomicAdd(&dB_s[lane * ld + t], vB);
          atomicAdd(&dC_s[lane * ld + t], vC);
        }
        dA_acc += gah * dtv;
        carry = ar[j] * g;
        ar[j] = g * Bv;       // now the terms of sum_n g B,
        pa[j] = gah * a_dn;   // sum_n g a h_prev A
        hr[j] = hr[j] * Cv;   // and sum_n h C
      }
      // every lane of the group has read dt, u, dy of the sub-chunk's
      // tokens: the sums' owners overwrite them
      group_sum_scatter<N>(ar, lane);
      group_sum_scatter<N>(pa, lane);
      group_sum_scatter<N>(hr, lane);
      if (live && n % kRep == 0) {
#pragma unroll
        for (int i = 0; i < kS / kNe; ++i) {
          const int s = k * kS + n / kRep * (kS / kNe) + i, t = a.reverse ? T - 1 - s : s;
          const float dtv = dt_d[t], uv = u_d[t], dyv = dy_s[d * ld + t];
          dD_acc += dyv * uv;
          du_s[d * ld + t] = dtv * ar[i] + dyv * Dd;
          dt_s[d * ld + t] = (pa[i] + uv * ar[i]) * (-expm1f(-dtv));  // sigmoid(dt_raw)
          dy_s[d * ld + t] = hr[i] + Dd * uv;                          // y_pre
        }
      }
    }
    for (int off = N / 2; off > 0; off >>= 1) dD_acc += __shfl_xor_sync(0xffffffffu, dD_acc, off);
    if (live) {
      a.p_dA[blk * D * N + p] = dA_acc;
      if (n == 0) a.p_dD[blk * D + d] = dD_acc;
    }
  }
  __syncthreads();

  const TI* z = x + (size_t)D * L;
  const TI* dout = static_cast<const TI*>(a.dout) + (size_t)bg * D * L;
  TI* dxz = static_cast<TI*>(a.dxz) + (size_t)bg * 2 * D * L;
  // dz = dout * y_pre * silu'(z), coalesced along L
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T, gt = t0 + t;
    if (gt < L) {
      const float zv = mmu::to_f32(z[(size_t)d * L + gt]);
      const float sz = 1.f / (1.f + expf(-zv));
      const float dz =
          mmu::to_f32(dout[(size_t)d * L + gt]) * dy_s[d * ld + t] * (sz + zv * sz * (1.f - sz));
      dxz[(size_t)(D + d) * L + gt] = mmu::from_f32<TI>(dz);
    }
  }
  // dt_proj weight and bias partials (the weight's product takes the rounded ddt_raw)
  for (int i = threadIdx.x; i < D * (R + 1); i += blockDim.x) {
    const int d = i / (R + 1), r = i - d * (R + 1);
    float acc = 0.f;
    if (r < R) {
      for (int t = 0; t < T; ++t) acc += mmu::round_to<TI>(dt_s[d * ld + t]) * xd_s[r * ld + t];
      a.p_ddtw[(blk * D + d) * R + r] = acc;
    } else {
      for (int t = 0; t < T; ++t) acc += dt_s[d * ld + t];
      a.p_ddtb[blk * D + d] = acc;
    }
  }
  // dx_dbl = [dt_w^T ddt_raw; dB; dC], rounded to the stream dtype
  for (int i = threadIdx.x; i < R * T; i += blockDim.x) {
    const int r = i / T, t = i - r * T;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += w.dtw[d * R + r] * mmu::round_to<TI>(dt_s[d * ld + t]);
    xg_s[r * ld + t] = mmu::round_to<TI>(acc);
  }
  for (int i = threadIdx.x; i < 2 * N * ld; i += blockDim.x) dB_s[i] = mmu::round_to<TI>(dB_s[i]);
  __syncthreads();
  // x_proj partial: dx_dbl @ u^T. A thread takes kTile rows of dx_dbl and
  // the channels d and d + Dh, so each value it reads feeds several
  // products (a clamped row or channel past the edge is read, not written)
  const int Dh = (D + 1) / 2;
  for (int i = threadIdx.x; i < Dh * ((E + kTile - 1) / kTile); i += blockDim.x) {
    const int d0 = i % Dh, e0 = i / Dh * kTile, d1 = min(d0 + Dh, D - 1);
    float acc0[kTile] = {}, acc1[kTile] = {};
    for (int t = 0; t < T; ++t) {
      const float u0 = u_s[d0 * ld + t], u1 = u_s[d1 * ld + t];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float xv = xg_s[min(e0 + j, E - 1) * ld + t];
        acc0[j] += xv * u0;
        acc1[j] += xv * u1;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (e0 + j >= E) break;
      float* out = a.p_dxp + (blk * E + e0 + j) * D;
      out[d0] = acc0[j];
      if (d0 + Dh < D) out[d0 + Dh] = acc1[j];
    }
  }
  // dpre = (x_proj^T dx_dbl + du) * silu'(pre), in token order; a thread
  // takes kTile tokens T / kTile apart of one channel, each weight read once
  const int W = a.W, Tq = T / kTile;
  for (int i = threadIdx.x; i < D * Tq; i += blockDim.x) {
    const int d = i / Tq, tq = i - d * Tq;
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = du_s[d * ld + tq + j * Tq];
    for (int e = 0; e < E; ++e) {
      const float wv = w.xp[(size_t)e * D + d];
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] += wv * xg_s[e * ld + tq + j * Tq];
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int gt = t0 + tq + j * Tq;
      if (gt >= L) break;
      const float pre =
          mmu::conv_pre(x + (size_t)d * L, w.cw + d * W, w.cb[d], gt, L, W, a.reverse);
      const float sp = 1.f / (1.f + expf(-pre));
      a.dpre[((size_t)bg * D + d) * L + gt] = acc[j] * sp * (1.f + pre * (1.f - sp));
    }
  }
}

// Pass D: dx from dpre through the transposed taps, and per-block partials
// of the conv weight and bias gradients. One block per (tile of tokens,
// channel, batch-group row).
template <typename TI>
__global__ void __launch_bounds__(256) mamba_bwd_conv_kernel(BwdArgs a) {
  const int ct = blockIdx.x, d = blockIdx.y, bg = blockIdx.z;
  const int D = a.D, L = a.L, W = a.W;
  const TI* x = static_cast<const TI*>(a.xz) + ((size_t)bg * 2 * D + d) * L;
  const float* dp = a.dpre + ((size_t)bg * D + d) * L;
  TI* dx = static_cast<TI*>(a.dxz) + ((size_t)bg * 2 * D + d) * L;
  const float* cw = a.conv_w + ((size_t)(bg % a.G) * D + d) * W;
  float acc[kMaxW], accb = 0.f;  // taps, bias
#pragma unroll
  for (int k = 0; k < kMaxW; ++k) acc[k] = 0.f;
  const int end = min(L, (ct + 1) * a.conv_tile);
  for (int j = ct * a.conv_tile + threadIdx.x; j < end; j += blockDim.x) {
    float v = 0.f;
    const float dpj = dp[j];
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < W) {
        const int s = W - 1 - k;
        const int t = a.reverse ? j - s : j + s;  // the output whose tap k read x[j]
        if (t >= 0 && t < L) v += cw[k] * dp[t];
        const int src = a.reverse ? j + s : j - s;  // what output j's tap k read
        if (src >= 0 && src < L) acc[k] += dpj * mmu::to_f32(x[src]);
      }
    }
    accb += dpj;
    dx[j] = mmu::from_f32<TI>(v);
  }
  __shared__ float red[kMaxW + 1][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= kMaxW; ++k) {
    float v = k < kMaxW ? acc[k] : accb;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x <= W) {  // taps 0..W-1, then the bias
    const int k = threadIdx.x < W ? threadIdx.x : kMaxW;
    float v = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) v += red[k][i];
    a.p_dconv[(((size_t)bg * a.nCT + ct) * D + d) * (W + 1) + threadIdx.x] = v;
  }
}

// pass C for the state count N, a compile-time constant of its sums
template <typename TI, int N>
cudaError_t launch_chunk(const BwdArgs& a, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_bwd_chunk_kernel<TI, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) mamba_bwd_chunk_kernel<TI, N><<<grid, threads, smem, stream>>>(a);
  return err;
}

template <typename TI>
int launch(const BwdArgs& a, int threads, size_t smem_local, size_t smem_chunk,
           cudaStream_t stream) {
  const dim3 grid(a.nC, a.B * a.G);
  cudaError_t err;
  if (a.nC > 1) {
    err = cudaFuncSetAttribute(mamba_bwd_local_kernel<TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_local);
    if (err != cudaSuccess) return err;
    mamba_bwd_local_kernel<TI><<<grid, threads, smem_local, stream>>>(a);
    const int64_t chains = (int64_t)a.B * a.G * a.D * a.N;
    mamba_bwd_combine_kernel<<<(unsigned)((chains + 127) / 128), 128, 0, stream>>>(a);
  }
  switch (a.N) {
    case 1: err = launch_chunk<TI, 1>(a, grid, threads, smem_chunk, stream); break;
    case 2: err = launch_chunk<TI, 2>(a, grid, threads, smem_chunk, stream); break;
    case 4: err = launch_chunk<TI, 4>(a, grid, threads, smem_chunk, stream); break;
    case 8: err = launch_chunk<TI, 8>(a, grid, threads, smem_chunk, stream); break;
    case 16: err = launch_chunk<TI, 16>(a, grid, threads, smem_chunk, stream); break;
    default: err = launch_chunk<TI, 32>(a, grid, threads, smem_chunk, stream); break;
  }
  if (err != cudaSuccess) return err;
  mamba_bwd_conv_kernel<TI><<<dim3(a.nCT, a.D, a.B * a.G), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mamba_fused_bwd(const void* xz, const void* dout, void* dxz, const void* conv_w,
                               const void* conv_b, const void* x_proj, const void* dt_w,
                               const void* dt_b, const void* A, const void* Dskip,
                               const void* state, const void* dtsum, void* gcarry, void* dpre,
                               void* p_dxp, void* p_ddtw, void* p_ddtb, void* p_dA, void* p_dD,
                               void* p_dconv, int B, int G, int D, int L, int N, int R, int W,
                               int T, int conv_tile, int reverse, int is_bf16, void* stream) {
  if (T % kS || W > kMaxW || N > 32 || (N & (N - 1)) || R > D || conv_tile < 1)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.xz = xz;
  a.dout = dout;
  a.dxz = dxz;
  a.conv_w = static_cast<const float*>(conv_w);
  a.conv_b = static_cast<const float*>(conv_b);
  a.x_proj = static_cast<const float*>(x_proj);
  a.dt_w = static_cast<const float*>(dt_w);
  a.dt_b = static_cast<const float*>(dt_b);
  a.A = static_cast<const float*>(A);
  a.Dskip = static_cast<const float*>(Dskip);
  a.state = static_cast<const float*>(state);
  a.dtsum = static_cast<const float*>(dtsum);
  a.gcarry = static_cast<float*>(gcarry);
  a.dpre = static_cast<float*>(dpre);
  a.p_dxp = static_cast<float*>(p_dxp);
  a.p_ddtw = static_cast<float*>(p_ddtw);
  a.p_ddtb = static_cast<float*>(p_ddtb);
  a.p_dA = static_cast<float*>(p_dA);
  a.p_dD = static_cast<float*>(p_dD);
  a.p_dconv = static_cast<float*>(p_dconv);
  a.B = B; a.G = G; a.D = D; a.L = L; a.N = N; a.R = R; a.W = W; a.T = T;
  a.nC = (L + T - 1) / T;
  a.conv_tile = conv_tile;
  a.nCT = (L + conv_tile - 1) / conv_tile;
  a.reverse = reverse != 0;
  // one thread per (channel, state) pair, in whole warps, at most 512
  const int pairs = D * N;
  const int threads = pairs >= 512 ? 512 : ((pairs + 31) / 32) * 32;
  const int E = R + 2 * N;
  const size_t smem_local = (size_t)(3 * D + E) * (T + 1) * sizeof(float);
  const size_t smem_chunk =
      ((size_t)(4 * D + 2 * E) * (T + 1) + (size_t)(T / kS) * threads) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, threads, smem_local, smem_chunk, st)
                 : launch<float>(a, threads, smem_local, smem_chunk, st);
}
