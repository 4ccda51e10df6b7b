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
// mirrors the forward's passes over chunks of T tokens (the forward's T),
// and splits a chunk's D channels over nb blocks of Dc channels (nb = 1
// for D <= 64 channels: MM_Net's offset Mambas):
//   X. (nb > 1) one block per (batch, chunk) computes x_dbl = x_proj u into
//      an f32 (B, G, E, L) scratch, streaming the D channels through shared
//      memory Dc at a time (conv + SiLU of the slice, then its products);
//      the only sum over channels of the recompute, done once per chunk
//      (`mmu::xdbl_chunk`, the forward's x_dbl pass too);
//   A. (more than one chunk) one block per (batch, chunk, channel block)
//      recomputes the conv and dt of its channels (with nb = 1 also x_dbl),
//      and runs the adjoint across the chunk from a zero carry, emitting the
//      boundary adjoint a_edge * g_edge per (d, n);
//   B. a small kernel walks the chunks against the scan direction per
//      (b, d, n), turning the local boundary adjoints into true carries
//      (a chunk's decay is exp(A * sum dt), the forward's saved sum);
//   C. one block per (batch, chunk, channel block), the nb blocks of a
//      chunk one thread-block cluster: each rebuilds h from the saved entry
//      state, walks back with g from the true carry and accumulates every
//      per-token and per-parameter term of its channels, and its partial of
//      dx_dbl over its channels. The cluster sums the partials through
//      distributed shared memory: each block sums a share of dx_dbl's
//      elements over the cluster's blocks in rank order, then reads the
//      other shares back from their owners. Then dz, the x_proj gradient of
//      its channels, and dpre into an f32 (B, G, D, L) scratch;
//   D. a depthwise kernel turns dpre into dx (including the W-1 tokens that
//      cross each chunk edge) and the conv weight and bias gradients.
// Parameter gradients are per-block partials in f32, summed by the wrapper
// (as core_bwd sums over batch on the host). Every sum has a fixed order
// (no atomics, global or shared), so every gradient is the same from run
// to run.
//
// What bounds it on the H100: not device memory (at D = 128 the bytes it
// must move take about 2% of its time) but the shared-memory and shuffle traffic of pass C, issued
// through the SM's one memory pipe, and the latency of its dependent
// chains. One thread walks one (channel d, state n) chain; per token it
// reads dt, u, dy, B and C and its terms must be summed over the N states
// and over the channels. The design cuts that traffic three ways:
//   - rows of T + 1 floats: every per-chunk row in shared memory has an odd
//     length, so the N state lanes of a channel that read B or C at one
//     token hit N distinct banks (rows of T floats put them in one bank:
//     N-way conflicts on every token), as do neighbouring channels reading
//     their rows at one token and the small products reading u across
//     channels;
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
//     write du, ddt and y_pre for kS tokens at once. dB and dC, sums over
//     the channels, are summed over a warp's channels per token by
//     shuffles, left per warp in shared memory, and summed over the warps in
//     warp order after each sub-chunk.
// The channel split bounds a block's shared memory by Dc, not D, and with
// 256 threads and at most 128 registers a thread two pass-C blocks fit on
// an SM (__launch_bounds__(256, 2)): while one waits at a barrier or in its
// small products, the other walks its chains. At MM_Net's widest scan (D =
// 128, R = 4, N = 16, T = 64: nb = 2 blocks of 64 channels) pass C takes
// 104 KB; at the Mamba LM's D = 1536 (E = 80, T = 16: 8 blocks of 192) 80 KB.
// The small products (x_dbl = x_proj u, its transpose into dpre, and the
// x_proj gradient) take kTile rows or tokens per thread, so a value read
// from shared memory feeds several products.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "mamba_chunk.cuh"

namespace cg = cooperative_groups;

namespace {

using mmu::group_sum_scatter;
using mmu::kAhead;
using mmu::kS;                // tokens per sub-chunk of pass C, whose states live in registers
constexpr int kTile = 4;      // rows (or tokens) per thread in pass C's small products
constexpr int kMaxW = 8;      // widest conv
constexpr int kThreads = 256;  // most threads of a block of passes A and C
constexpr int kMaxCluster = 8;  // most blocks of a cluster (the portable size)

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
  float* xdbl;          // (B, G, R + 2N, L) x_dbl from pass X (nb > 1)
  float* p_dxp;         // (B*G*nC, R + 2N, D) partials
  float* p_ddtw;        // (B*G*nC, D, R)
  float* p_ddtb;        // (B*G*nC, D)
  float* p_dA;          // (B*G*nC, D, N)
  float* p_dD;          // (B*G*nC, D)
  float* p_dconv;       // (B*G*nCT, D, W + 1): taps, then bias
  int B, G, D, L, N, R, W, T, nC;
  int Dc, nb;           // channels per block of passes A and C, and blocks per chunk
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

// waits of a cluster barrier split in two: after its arrive a block touches
// no other block's shared memory, and it waits before it exits, so no block
// leaves while another still reads its memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// dy_s [nd][T + 1] = dout * silu(z) of the channels d0 .. d0 + nd - 1, 0 past L
template <typename TI>
__device__ void load_dy(const BwdArgs& a, int bg, int t0, int d0, int nd, float* dy_s) {
  const int D = a.D, L = a.L, T = a.T;
  const TI* z = static_cast<const TI*>(a.xz) + (((size_t)bg * 2 + 1) * D + d0) * L;
  const TI* dout = static_cast<const TI*>(a.dout) + ((size_t)bg * D + d0) * L;
  for (int i = threadIdx.x; i < nd * T; i += blockDim.x) {
    const int dl = i / T, t = i - dl * T, gt = t0 + t;
    dy_s[dl * (T + 1) + t] =
        gt < L ? mmu::to_f32(dout[(size_t)dl * L + gt]) * mmu::silu(mmu::to_f32(z[(size_t)dl * L + gt]))
               : 0.f;
  }
}

// The chunk's inputs of a block of passes A and C: the conv output and dt
// of its nd channels from d0, and the chunk's x_dbl: recomputed whole by
// the one block of a chunk (nb = 1, as the forward computes them), else
// read from pass X's scratch (`mmu::split_inputs`). Ends with
// __syncthreads().
template <typename TI>
__device__ void chunk_inputs(const BwdArgs& a, const Row& w, const TI* x, int bg, int t0, int d0,
                             int nd, float* u_s, float* dt_s, float* xd_s) {
  if (a.nb == 1) {
    mmu::recompute_chunk<TI>(x, a.D, a.L, a.T, t0, a.R, a.N, a.W, a.reverse, w.cw, w.cb, w.xp,
                             w.dtw, w.dtb, u_s, dt_s, xd_s);
    return;
  }
  mmu::split_inputs<TI>(x, a.xdbl + (size_t)bg * (a.R + 2 * a.N) * a.L, d0, nd, a.L, a.T, t0,
                        a.R, a.N, a.W, a.reverse, w.cw, w.cb, w.dtw, w.dtb, u_s, dt_s, xd_s);
}

// Pass X (`mmu::xdbl_chunk`): x_dbl of one chunk over all D channels, Dc at
// a time, into the scratch, in the forward's summation order.
template <typename TI>
__global__ void __launch_bounds__(mmu::kXdblThreads) mamba_bwd_xdbl_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, L = a.L, E = a.R + 2 * a.N, Dc = a.Dc;
  const int c = blockIdx.x, bg = blockIdx.y;
  const Row w = row_of(a, bg % a.G);
  float* u_s = smem;                 // [Dc] rows: the slice's conv output
  float* xd_s = u_s + Dc * (T + 1);  // [E] x_dbl sums
  mmu::xdbl_chunk<TI>(static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L, D, L, T, c * T,
                      a.R, E, a.W, Dc, a.reverse, w.cw, w.cb, w.xp, u_s, xd_s,
                      a.xdbl + (size_t)bg * E * L);
}

// Pass A: the adjoint across one chunk from a zero carry, for the block's
// channels; emits a_edge g_edge.
template <typename TI>
__global__ void __launch_bounds__(kThreads) mamba_bwd_local_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, N = a.N, R = a.R, ld = T + 1, Dc = a.Dc;
  float* u_s = smem;
  float* dt_s = u_s + Dc * ld;
  float* xd_s = dt_s + Dc * ld;
  float* dy_s = xd_s + (R + 2 * N) * ld;
  const int k = blockIdx.x % a.nb, c = blockIdx.x / a.nb, bg = blockIdx.y, t0 = c * T;
  const int d0 = k * Dc, nd = min(Dc, D - d0);
  const Row w = row_of(a, bg % a.G);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * a.L;
  load_dy<TI>(a, bg, t0, d0, nd, dy_s);
  chunk_inputs<TI>(a, w, x, bg, t0, d0, nd, u_s, dt_s, xd_s);
  const float* Cs = xd_s + (R + N) * ld;
  const size_t sbase = ((size_t)bg * a.nC + c) * D * N + (size_t)d0 * N;
  for (int p = threadIdx.x; p < nd * N; p += blockDim.x) {
    const int dl = p / N, n = p - dl * N;
    const float a_dn = w.A[(size_t)d0 * N + p];
    float carry = 0.f;
    for (int s = 0; s < T; ++s) {
      const int t = a.reverse ? s : T - 1 - s;  // against the scan direction
      const float g = dy_s[dl * ld + t] * Cs[n * ld + t] + carry;
      carry = expf(dt_s[dl * ld + t] * a_dn) * g;
    }
    a.gcarry[sbase + p] = carry;
  }
}

// Pass B: local boundary adjoints -> the true adjoint entering each chunk
// from its successor in scan order. The walk is one dependent chain per
// (b, d, n) with a load per chunk: the loads of kAhead chunks are issued
// together, so a chain waits on memory once per kAhead chunks.
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

// Pass C: the full adjoint of one chunk for the block's channels and every
// term but the conv's; the nb blocks of a chunk form a cluster that sums
// dx_dbl over the channels.
template <typename TI, int N>
__global__ void __launch_bounds__(kThreads, 2) mamba_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, R = a.R, L = a.L, Dc = a.Dc, nb = a.nb;
  const int E = R + 2 * N, ld = T + 1;    // rows of T + 1 floats
  constexpr int kWarpRows = 2 * N * (kS + 1);  // a warp's dB and dC of one sub-chunk
  float* u_s = smem;             // [Dc] rows: conv output
  float* dt_s = u_s + Dc * ld;   // [Dc] dt, overwritten by ddt_raw
  float* xd_s = dt_s + Dc * ld;  // [E] x_dbl
  float* dy_s = xd_s + E * ld;   // [Dc] dy, overwritten by y_pre
  float* du_s = dy_s + Dc * ld;  // [Dc] du of the scan
  float* xg_s = du_s + Dc * ld;  // [E] dx_dbl: R dt rows, then dB and dC
  float* dB_s = xg_s + R * ld;   // [2N] dB, then dC
  float* ck_s = xg_s + E * ld;   // [T / kS][blockDim] sub-chunk entry states
  float* wb_s = ck_s + (T / kS) * blockDim.x;  // [warps][2N][kS + 1] per-warp dB, dC

  const int k = blockIdx.x % nb, c = blockIdx.x / nb, bg = blockIdx.y, t0 = c * T;
  const int d0 = k * Dc, nd = min(Dc, D - d0);
  const Row w = row_of(a, bg % a.G);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L;
  load_dy<TI>(a, bg, t0, d0, nd, dy_s);
  for (int i = threadIdx.x; i < 2 * N * ld; i += blockDim.x) dB_s[i] = 0.f;
  chunk_inputs<TI>(a, w, x, bg, t0, d0, nd, u_s, dt_s, xd_s);

  const float* Bs = xd_s + R * ld;
  const float* Cs = Bs + N * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nsub = T / kS;
  constexpr int kNe = N < kS ? N : kS;  // lanes of a group that end with distinct sums
  constexpr int kRep = N / kNe;         // lanes that hold each of them
  const size_t blk = (size_t)bg * a.nC + c;           // this chunk: states and partials
  const size_t sb = blk * D * N + (size_t)d0 * N;     // this block's chains in them
  float* wb = wb_s + warp * kWarpRows;
  // every lane of the block runs every walk (lanes past nd * N with zero
  // inputs), so the shuffles always see the full warp and every thread
  // reaches the barriers
  for (int p0 = 0; p0 < nd * N; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < nd * N;
    const int pp = live ? p : 0;
    const int dl = pp / N, n = pp - dl * N, d = d0 + dl;
    const float* dt_d = dt_s + dl * ld;
    const float* u_d = u_s + dl * ld;
    const float a_dn = w.A[(size_t)d * N + n];
    const float Dd = w.Dv[d];
    // walk 1, in scan order: the state entering each sub-chunk, into this
    // thread's column of ck_s
    float h = live ? a.state[sb + pp] : 0.f;
    for (int kk = 0; kk < nsub; ++kk) {
      ck_s[kk * blockDim.x + threadIdx.x] = h;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const int s = kk * kS + j, t = a.reverse ? T - 1 - s : s;
        const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
        h = expf(dtv * a_dn) * h + dtv * uv * Bs[n * ld + t];
      }
    }
    float carry = (live && a.nC > 1) ? a.gcarry[sb + pp] : 0.f;
    float dA_acc = 0.f, dD_acc = 0.f;
    for (int kk = nsub - 1; kk >= 0; --kk) {  // sub-chunks against the scan direction
      // rebuild the sub-chunk's states and decays into registers
      float hr[kS], ar[kS], pa[kS];
      h = ck_s[kk * blockDim.x + threadIdx.x];
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const int s = kk * kS + j, t = a.reverse ? T - 1 - s : s;
        const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
        ar[j] = expf(dtv * a_dn);
        h = ar[j] * h + dtv * uv * Bs[n * ld + t];
        hr[j] = h;
      }
      // the adjoint: g and this lane's terms per token; the sums over the
      // warp's channels at once, the sums over the states after the walk
#pragma unroll
      for (int j = kS - 1; j >= 0; --j) {
        const int s = kk * kS + j, t = a.reverse ? T - 1 - s : s;
        const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
        const float dyv = live ? dy_s[dl * ld + t] : 0.f;
        const float Bv = Bs[n * ld + t], Cv = Cs[n * ld + t];
        const float g = dyv * Cv + carry;
        const float gah = g * (hr[j] - dtv * uv * Bv);  // g * a * h_prev
        float vB = g * dtv * uv, vC = hr[j] * dyv;
        for (int off = N; off < 32; off <<= 1) {  // sums over the warp's channels
          vB += __shfl_xor_sync(0xffffffffu, vB, off);
          vC += __shfl_xor_sync(0xffffffffu, vC, off);
        }
        if (lane < N) {  // lane == n for live lanes; a dead warp leaves 0
          wb[lane * (kS + 1) + j] = vB;
          wb[(N + lane) * (kS + 1) + j] = vC;
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
          const int s = kk * kS + n / kRep * (kS / kNe) + i, t = a.reverse ? T - 1 - s : s;
          const float dtv = dt_d[t], uv = u_d[t], dyv = dy_s[dl * ld + t];
          dD_acc += dyv * uv;
          du_s[dl * ld + t] = dtv * ar[i] + dyv * Dd;
          dt_s[dl * ld + t] = (pa[i] + uv * ar[i]) * (-expm1f(-dtv));  // sigmoid(dt_raw)
          dy_s[dl * ld + t] = hr[i] + Dd * uv;                          // y_pre
        }
      }
      // the sub-chunk's dB and dC: the warps' sums, added in warp order
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * N * kS; i += blockDim.x) {
        const int r = i / kS, j = i - r * kS;
        const int s = kk * kS + j, t = a.reverse ? T - 1 - s : s;
        float v = 0.f;
        for (int wi = 0; wi < nw; ++wi) v += wb_s[wi * kWarpRows + r * (kS + 1) + j];
        dB_s[r * ld + t] += v;
      }
      __syncthreads();
    }
    for (int off = N / 2; off > 0; off >>= 1) dD_acc += __shfl_xor_sync(0xffffffffu, dD_acc, off);
    if (live) {
      a.p_dA[sb + p] = dA_acc;
      if (n == 0) a.p_dD[blk * D + d] = dD_acc;
    }
  }

  const TI* z = x + (size_t)D * L;
  const TI* dout = static_cast<const TI*>(a.dout) + (size_t)bg * D * L;
  TI* dxz = static_cast<TI*>(a.dxz) + (size_t)bg * 2 * D * L;
  // dz = dout * y_pre * silu'(z), coalesced along L
  for (int i = threadIdx.x; i < nd * T; i += blockDim.x) {
    const int dl = i / T, t = i - dl * T, gt = t0 + t, d = d0 + dl;
    if (gt < L) {
      const float zv = mmu::to_f32(z[(size_t)d * L + gt]);
      const float sz = 1.f / (1.f + expf(-zv));
      const float dz =
          mmu::to_f32(dout[(size_t)d * L + gt]) * dy_s[dl * ld + t] * (sz + zv * sz * (1.f - sz));
      dxz[(size_t)(D + d) * L + gt] = mmu::from_f32<TI>(dz);
    }
  }
  // dt_proj weight and bias partials (the weight's product takes the rounded ddt_raw)
  for (int i = threadIdx.x; i < nd * (R + 1); i += blockDim.x) {
    const int dl = i / (R + 1), r = i - dl * (R + 1), d = d0 + dl;
    float acc = 0.f;
    if (r < R) {
      for (int t = 0; t < T; ++t) acc += mmu::round_to<TI>(dt_s[dl * ld + t]) * xd_s[r * ld + t];
      a.p_ddtw[(blk * D + d) * R + r] = acc;
    } else {
      for (int t = 0; t < T; ++t) acc += dt_s[dl * ld + t];
      a.p_ddtb[blk * D + d] = acc;
    }
  }
  // this block's partial of dx_dbl's R dt rows, dt_w^T ddt_raw over its channels
  for (int i = threadIdx.x; i < R * T; i += blockDim.x) {
    const int r = i / T, t = i - r * T;
    float acc = 0.f;
    for (int dl = 0; dl < nd; ++dl)
      acc += w.dtw[(size_t)(d0 + dl) * R + r] * mmu::round_to<TI>(dt_s[dl * ld + t]);
    xg_s[r * ld + t] = acc;
  }
  // dx_dbl = [dt_w^T ddt_raw; dB; dC], summed over the channels and rounded
  // to the stream dtype
  if (nb == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < E * T; i += blockDim.x) {
      const int e = i / T, o = e * ld + i - e * T;
      xg_s[o] = mmu::round_to<TI>(xg_s[o]);
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int per = (E * T + nb - 1) / nb;  // elements each block sums
    cluster.sync();                         // every block's partial is in its xg_s
    for (int f = rank * per + threadIdx.x; f < min(E * T, (rank + 1) * per); f += blockDim.x) {
      const int e = f / T, o = e * ld + f - e * T;
      float v = 0.f;
      for (int r = 0; r < nb; ++r) v += cluster.map_shared_rank(xg_s, r)[o];
      xg_s[o] = mmu::round_to<TI>(v);
    }
    cluster.sync();  // every share summed by its owner
    for (int f = threadIdx.x; f < E * T; f += blockDim.x) {
      const int r = f / per;
      if (r != rank) {
        const int e = f / T, o = e * ld + f - e * T;
        xg_s[o] = cluster.map_shared_rank(xg_s, r)[o];
      }
    }
    cluster_arrive();
  }
  __syncthreads();
  // x_proj partial: dx_dbl @ u^T over the block's channels. A thread takes
  // kTile rows of dx_dbl and the channels dl and dl + Dh, so each value it
  // reads feeds several products (a clamped row or channel past the edge
  // is read, not written)
  const int Dh = (nd + 1) / 2;
  for (int i = threadIdx.x; i < Dh * ((E + kTile - 1) / kTile); i += blockDim.x) {
    const int dl0 = i % Dh, e0 = i / Dh * kTile, dl1 = min(dl0 + Dh, nd - 1);
    float acc0[kTile] = {}, acc1[kTile] = {};
    for (int t = 0; t < T; ++t) {
      const float u0 = u_s[dl0 * ld + t], u1 = u_s[dl1 * ld + t];
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
      float* out = a.p_dxp + (blk * E + e0 + j) * D + d0;
      out[dl0] = acc0[j];
      if (dl0 + Dh < nd) out[dl0 + Dh] = acc1[j];
    }
  }
  // dpre = (x_proj^T dx_dbl + du) * silu'(pre), in token order; a thread
  // takes kTile tokens T / kTile apart of one channel, each weight read once
  const int W = a.W, Tq = T / kTile;
  for (int i = threadIdx.x; i < nd * Tq; i += blockDim.x) {
    const int dl = i / Tq, tq = i - dl * Tq, d = d0 + dl;
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = du_s[dl * ld + tq + j * Tq];
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
  if (nb > 1) cluster_wait();
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

// the launch of passes A and C at these sizes: threads per block (one per
// (channel, state) pair of a block, in whole warps, at most kThreads) and
// each pass's f32 shared memory in bytes, as ops/mamba_fused.py::_bwd_plan
// computes them
struct Plan {
  int nb, threads;
  size_t smem_x, smem_a, smem_c;
};

Plan plan_of(int D, int R, int N, int T, int Dc) {
  Plan p;
  p.nb = (D + Dc - 1) / Dc;
  const int pairs = Dc * N;
  p.threads = pairs >= kThreads ? kThreads : ((pairs + 31) / 32) * 32;
  const size_t E = R + 2 * N, ld = T + 1, f = sizeof(float);
  p.smem_x = (Dc + E) * ld * f;
  p.smem_a = (3 * Dc + E) * ld * f;
  p.smem_c = ((4 * Dc + 2 * E) * ld + (size_t)(T / kS) * p.threads +
              (size_t)(p.threads / 32) * 2 * N * (kS + 1)) * f;
  return p;
}

using Kernel = void (*)(BwdArgs);

// pass C for the state count N, a compile-time constant of its sums
template <typename TI>
Kernel chunk_kernel(int N) {
  switch (N) {
    case 1: return mamba_bwd_chunk_kernel<TI, 1>;
    case 2: return mamba_bwd_chunk_kernel<TI, 2>;
    case 4: return mamba_bwd_chunk_kernel<TI, 4>;
    case 8: return mamba_bwd_chunk_kernel<TI, 8>;
    case 16: return mamba_bwd_chunk_kernel<TI, 16>;
    default: return mamba_bwd_chunk_kernel<TI, 32>;
  }
}

// passes X (nb > 1), A and B (more than one chunk), C and D; with
// `occupancy` set, instead of a launch: the resident blocks per SM of
// passes X, A and C, and the clusters of pass C the card holds at once (0
// for nb = 1)
template <typename TI>
int run(const BwdArgs& a, cudaStream_t stream, int* occupancy) {
  const Plan p = plan_of(a.D, a.R, a.N, a.T, a.Dc);
  const Kernel xk = mamba_bwd_xdbl_kernel<TI>, ak = mamba_bwd_local_kernel<TI>;
  const Kernel ck = chunk_kernel<TI>(a.N);
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(xk, attr, (int)p.smem_x);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ak, attr, (int)p.smem_a);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ck, attr, (int)p.smem_c);
  if (err != cudaSuccess) return err;

  const dim3 grid(a.nb * a.nC, a.B * a.G);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem_c;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.nb;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (occupancy) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], xk, mmu::kXdblThreads,
                                                        p.smem_x);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[1], ak, p.threads, p.smem_a);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[2], ck, p.threads, p.smem_c);
    occupancy[3] = 0;
    if (err == cudaSuccess && a.nb > 1) err = cudaOccupancyMaxActiveClusters(&occupancy[3], ck, &cfg);
    return err;
  }
  if (a.nb > 1) xk<<<dim3(a.nC, a.B * a.G), mmu::kXdblThreads, p.smem_x, stream>>>(a);
  if (a.nC > 1) {
    ak<<<grid, p.threads, p.smem_a, stream>>>(a);
    const int64_t chains = (int64_t)a.B * a.G * a.D * a.N;
    mamba_bwd_combine_kernel<<<(unsigned)((chains + 127) / 128), 128, 0, stream>>>(a);
  }
  if (a.nb > 1) {
    err = cudaLaunchKernelEx(&cfg, ck, a);
    if (err != cudaSuccess) return err;
  } else {
    ck<<<grid, p.threads, p.smem_c, stream>>>(a);
  }
  mamba_bwd_conv_kernel<TI><<<dim3(a.nCT, a.D, a.B * a.G), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

bool valid(int D, int R, int N, int W, int T, int Dc) {
  return T % kS == 0 && W <= kMaxW && N >= 1 && N <= 32 && !(N & (N - 1)) && R <= D && Dc >= 1 &&
         (D + Dc - 1) / Dc <= kMaxCluster;
}

}  // namespace

extern "C" int mamba_fused_bwd(const void* xz, const void* dout, void* dxz, const void* conv_w,
                               const void* conv_b, const void* x_proj, const void* dt_w,
                               const void* dt_b, const void* A, const void* Dskip,
                               const void* state, const void* dtsum, void* gcarry, void* dpre,
                               void* xdbl, void* p_dxp, void* p_ddtw, void* p_ddtb, void* p_dA,
                               void* p_dD, void* p_dconv, int B, int G, int D, int L, int N, int R,
                               int W, int T, int Dc, int conv_tile, int reverse, int is_bf16,
                               void* stream) {
  if (!valid(D, R, N, W, T, Dc) || conv_tile < 1 || (Dc < D && xdbl == nullptr))
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
  a.xdbl = static_cast<float*>(xdbl);
  a.p_dxp = static_cast<float*>(p_dxp);
  a.p_ddtw = static_cast<float*>(p_ddtw);
  a.p_ddtb = static_cast<float*>(p_ddtb);
  a.p_dA = static_cast<float*>(p_dA);
  a.p_dD = static_cast<float*>(p_dD);
  a.p_dconv = static_cast<float*>(p_dconv);
  a.B = B; a.G = G; a.D = D; a.L = L; a.N = N; a.R = R; a.W = W; a.T = T;
  a.nC = (L + T - 1) / T;
  a.Dc = Dc < D ? Dc : D;
  a.nb = (D + a.Dc - 1) / a.Dc;
  a.conv_tile = conv_tile;
  a.nCT = (L + conv_tile - 1) / conv_tile;
  a.reverse = reverse != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(a, st, nullptr) : run<float>(a, st, nullptr);
}

// resident blocks per SM of passes X, A and C (out[0..2]) and the clusters
// of pass C the card holds at once (out[3]) at the launch mamba_fused_bwd
// makes for these sizes
extern "C" int mamba_fused_bwd_blocks_per_sm(int D, int R, int N, int T, int Dc, int is_bf16,
                                             int* out) {
  if (!valid(D, R, N, 4, T, Dc)) return cudaErrorInvalidValue;
  BwdArgs a = {};
  a.D = D; a.R = R; a.N = N; a.T = T; a.B = 1; a.G = 1; a.nC = 1;
  a.Dc = Dc < D ? Dc : D;
  a.nb = (D + a.Dc - 1) / a.Dc;
  return is_bf16 ? run<__nv_bfloat16>(a, nullptr, out) : run<float>(a, nullptr, out);
}
