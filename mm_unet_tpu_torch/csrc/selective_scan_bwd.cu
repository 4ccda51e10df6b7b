// Chunked selective scan, backward, for Hopper: the adjoint of
// selective_scan_fwd.cu from the chunk-entry states the forward kept.
//
// Replaces two TPU kernels of mm_unet_tpu/ops/pallas_scan.py with one: the
// fused _bwd_kernel_fused (launched by _scan_core_fused._bwd_call) and the
// bare _bwd_kernel (launched by _scan_core._bwd_call), with their host sums
// over batch, channel blocks and tokens (core_bwd). Per token, with g the
// adjoint state (g_t = dy_t C_t + a_{t+1} g_{t+1}), dy = dout * silu(z) (dout
// without z) and b_t = dt u B_t:
//   du = dt sum_n g B + dy D            dz = dout y_pre silu'(z)
//   ddt = sum_n g (h - b) A + u sum_n g B, times sigmoid(raw) under softplus
//   dB = sum_d g dt u   dC = sum_d h dy   dA = sum_t g (h - b) dt
//   dD = sum_t dy u     dbias = sum_t ddt
// where h - b = a h_prev: the pre-fold b keeps the cross-chunk term a_0 h_in.
// Every gradient is computed in f32 and written in its input's dtype. The
// last state's gradient dlast (B, Dm, N) f32, when given, is the adjoint that
// enters the last token from beyond it: pass B starts its walk from it (pass
// C of a single chunk from it directly), and pass C carries it into du, ddt,
// dA and dB like any other carry. Without it the last state takes no
// gradient.
//
// What bounds it on the H100: the bytes of u, delta, z, dout, B, C in and
// du, ddelta, dz, dB, dC out, about twice the forward's; the arithmetic is
// about three times the forward's (the scan rebuilt, then the adjoint walk,
// with three sums over the states per token), still under the byte bound at
// the f32 peak. The chains of dependent exp/multiply-adds along L are the
// forward's, so the design mirrors the forward's three passes, one block per
// (batch, channel block, chunk of T tokens):
//   A. each block runs the adjoint across its chunk from a zero carry and
//      emits the boundary adjoint a_0 g_0 per (d, n);
//   B. a small kernel walks the chunks backwards per (b, d, n), turning the
//      local boundary adjoints into true carries (a chunk's decay is
//      exp(A * sum dt), the forward's saved sum);
//   C. each block rebuilds h across its chunk from the saved entry state,
//      walks back with g from the true carry, and accumulates every term.
// Parameter and dB / dC sums leave as per-block partials in f32, which the
// wrapper adds up (no atomics anywhere: the result does not depend on the
// order blocks or warps run in).
//
// What holds it back is not device memory (its bytes take a few percent of
// its time) but pass C's shared-memory and shuffle traffic and its
// dependent chains. One thread walks one (channel, state) chain; per token
// it reads dt, u, dy, B and C, and its terms are summed over the N states
// (du, ddt, dz) and over the block's channels (a varying dB, dC). Pass C
// cuts that traffic four ways (the fused Mamba backward's pass C, in
// mamba_fused_bwd.cu, takes the first three in its own form):
//   - rows of T + 4 floats (selective_scan.cuh) read four tokens per
//     16-byte load: the 16 state lanes of a channel that read B or C take
//     two wavefronts for four tokens, a warp's channel rows one; a constant
//     B or C is read as zero rows plus the lane's constant, so no walk
//     branches on the layout;
//   - h in registers: the chunk is walked in sub-chunks of kS tokens; a
//     first walk keeps the state entering each sub-chunk in shared memory,
//     and each sub-chunk's states and decays are rebuilt into unrolled
//     register arrays just before its adjoint walk (no local-memory buffer);
//   - sums over the states by the scattering butterfly (group_sum_scatter,
//     mamba_chunk.cuh): kS - 1 shuffles per quantity and sub-chunk where a
//     sum per token takes kS log2 NP; each owner lane then writes du, ddt
//     and dz for its tokens. It is templated on NP, the state lanes rounded
//     up to a power of two, with the lanes past N holding zeros;
//   - dB / dC over the block's channels without atomics (sm_90 has no
//     shared float add: a shared atomicAdd is a compare-and-swap loop): per
//     token the warp sums its channels by shuffles and its first lane group
//     writes the warp's cell of a sub-chunk buffer; after a barrier each
//     (state, token) is summed over the warps in a fixed order by one thread
//     and stored as the block's partial. The buffer is doubled, so one
//     barrier per sub-chunk suffices.
#include <cstdint>

#include "common.cuh"
#include "mamba_chunk.cuh"
#include "selective_scan.cuh"

namespace {

using mmu::kAhead;
using mmu::kS;  // tokens per sub-chunk of pass C, whose states live in registers
using mmu::ScanArgs;

struct BwdOut {
  const void* dout;  // (B, Dm, L) stream dtype
  const float* dlast;  // (B, Dm, N) gradient of the last state, or null
  void* du;          // (B, Dm, L) stream dtype
  void* ddelta;      // (B, Dm, L) stream dtype
  void* dz;          // (B, Dm, L) stream dtype, or null without z
  float* gcarry;     // (B, nC, Dm, N) boundary adjoints, then true carries
  float* p_dA;       // (B, nC, Dm, N)
  float* p_dD;       // (B, nC, Dm), or null without D
  float* p_dbias;    // (B, nC, Dm), or null without bias
  float* p_dB;       // varying: (B, Dm / span, nDB, N, L); constant: (B, nC, Dm, N)
  float* p_dC;
};

// dy_s [CH][T + 4] = dout * silu(z) (dout without z), 0 past L
template <typename TI>
__device__ void stage_dy(const ScanArgs& a, const BwdOut& o, const mmu::Blk& k, int t0, int ld,
                         float* dy_s) {
  const TI* dout = static_cast<const TI*>(o.dout);
  const TI* z = static_cast<const TI*>(a.z);
  for (int i = threadIdx.x; i < a.chans * a.T; i += blockDim.x) {
    const int c = i / a.T, t = i - c * a.T, gt = t0 + t;
    float v = 0.f;
    if (c < k.live && gt < a.L) {
      const size_t off = ((size_t)k.b * a.Dm + k.d0 + c) * a.L + gt;
      v = mmu::to_f32(dout[off]);
      if (z) v *= mmu::silu(mmu::to_f32(z[off]));
    }
    dy_s[c * ld + t] = v;
  }
}

// Pass A: the adjoint across one chunk from a zero carry; emits a_0 g_0.
template <typename TI, typename TB>
__global__ void __launch_bounds__(512) scan_bwd_local_kernel(ScanArgs a, BwdOut o) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, NP = a.NP, ld = T + 4;
  float* dt_s = smem;                 // [CH][T + 4]
  float* dy_s = dt_s + a.chans * ld;  // [CH][T + 4]
  float* C_s = dy_s + a.chans * ld;   // [NP][T + 4] varying C
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  mmu::stage_dt<TI>(a, k, t0, ld, dt_s);
  stage_dy<TI>(a, o, k, t0, ld, dy_s);
  mmu::stage_bc<TB>(a, k, a.c_var ? a.Cm : nullptr, a.cs, a.c_gdiv, t0, ld, NP, C_s);
  __syncthreads();
  const int ci = threadIdx.x / NP, n = threadIdx.x - ci * NP;
  if (ci >= k.live || n >= N) return;  // no shuffles in this pass
  const int d = k.d0 + ci;
  const float a_dn = a.A[(size_t)d * N + n];
  const float Cc = a.c_var ? 0.f : mmu::bc_const<TB>(a.Cm, a.cs, d, n);
  const float* dts = dt_s + ci * ld;
  const float* dys = dy_s + ci * ld;
  const float* Cn = C_s + n * ld;
  float carry = 0.f;
  for (int s = T - kS; s >= 0; s -= kS) {
#pragma unroll
    for (int q = kS - 4; q >= 0; q -= 4) {
      const mmu::Quad dt4 = mmu::quad(dts + s + q), dy4 = mmu::quad(dys + s + q);
      const mmu::Quad c4 = mmu::quad(Cn + s + q);
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const float g = dy4.v[j] * (c4.v[j] + Cc) + carry;
        carry = expf(dt4.v[j] * a_dn) * g;
      }
    }
  }
  o.gcarry[(((size_t)k.b * a.nC + c) * a.Dm + d) * N + n] = carry;
}

// Pass B: local boundary adjoints -> the true adjoint entering each chunk
// from the chunk after it. The walk is one dependent chain per (b, d, n)
// with a load per chunk: the loads of kAhead chunks are issued together, so
// a chain waits on memory once per kAhead chunks.
__global__ void __launch_bounds__(128) scan_bwd_combine_kernel(ScanArgs a, BwdOut o) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.Bsz * a.Dm * a.N) return;
  const int n = i % a.N, d = (i / a.N) % a.Dm;
  const int64_t b = i / ((int64_t)a.Dm * a.N);
  const float a_dn = a.A[(size_t)d * a.N + n];
  float carry = o.dlast ? o.dlast[i] : 0.f;  // i = (b, d, n), the last state's layout
  for (int s0 = 0; s0 < a.nC; s0 += kAhead) {
    float local[kAhead], dts[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const size_t sc = (size_t)b * a.nC + (a.nC - 1 - s0 - j);  // against the scan direction
      local[j] = s0 + j < a.nC ? o.gcarry[(sc * a.Dm + d) * a.N + n] : 0.f;
      dts[j] = s0 + j < a.nC ? a.dtsum[sc * a.Dm + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (s0 + j < a.nC) {
        const size_t sc = (size_t)b * a.nC + (a.nC - 1 - s0 - j);
        o.gcarry[(sc * a.Dm + d) * a.N + n] = carry;
        carry = local[j] + expf(a_dn * dts[j]) * carry;
      }
    }
  }
}

// Pass C: the full adjoint of one chunk and every gradient term. NP is the
// lanes of a channel's state group (N rounded up to a power of two).
template <typename TI, typename TB, int NP>
__global__ void __launch_bounds__(512) scan_bwd_chunk_kernel(ScanArgs a, BwdOut o) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, CH = a.chans, ld = T + 4, nsub = T / kS;
  float* u_s = smem;             // [CH][T + 4] u, then du
  float* dt_s = u_s + CH * ld;   // [CH][T + 4] dt, then ddelta
  float* dy_s = dt_s + CH * ld;  // [CH][T + 4] dy = dout * silu(z)
  float* do_s = dy_s + CH * ld;  // [CH][T + 4] dout (with z)
  float* z_s = do_s + CH * ld;   // [CH][T + 4] z, then dz (with z)
  float* B_s = z_s + CH * ld;    // [NP][T + 4] B, zero past N (all zero if constant)
  float* C_s = B_s + NP * ld;    // [NP][T + 4] C, likewise
  float* ck_s = C_s + NP * ld;   // [T / kS][blockDim] each thread's sub-chunk entry states
  // [2 sub-chunks][2][warps][kS][NP + 1]: each warp's terms of dB and dC for
  // a sub-chunk, summed over its channels (odd rows: the block's sum reads
  // them by token), double-buffered over the sub-chunks
  const int W = blockDim.x / 32, pw = kS * (NP + 1);
  float* part = ck_s + nsub * blockDim.x;
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  const bool has_z = a.z != nullptr;
  mmu::stage_rows<TI>(a, k, a.u, t0, ld, u_s);
  mmu::stage_dt<TI>(a, k, t0, ld, dt_s);
  mmu::stage_rows<TI>(a, k, o.dout, t0, ld, has_z ? do_s : dy_s);
  if (has_z) mmu::stage_rows<TI>(a, k, a.z, t0, ld, z_s);
  // a constant B or C reads zero rows plus its per-thread constant, so that
  // the walks below take no branch on the layout
  mmu::stage_bc<TB>(a, k, a.b_var ? a.Bm : nullptr, a.bs, a.b_gdiv, t0, ld, NP, B_s);
  mmu::stage_bc<TB>(a, k, a.c_var ? a.Cm : nullptr, a.cs, a.c_gdiv, t0, ld, NP, C_s);
  __syncthreads();
  if (has_z) {  // dy once per (channel, token), not once per state lane
    for (int i = threadIdx.x; i < CH * ld; i += blockDim.x) dy_s[i] = do_s[i] * mmu::silu(z_s[i]);
    __syncthreads();
  }

  // every lane of a warp runs every walk (dead lanes with zero inputs: a
  // channel past the span has dt = u = dy = 0, a lane past N has A = B = C
  // = 0), so the shuffles below always see the full warp
  constexpr int kNe = NP < kS ? NP : kS;  // lanes of a group that end with distinct sums
  constexpr int kRep = NP / kNe;          // lanes that hold each of them
  const int ci = threadIdx.x / NP, n = threadIdx.x % NP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const bool chan = ci < k.live;
  const bool live = chan && n < N;
  const int d = k.d0 + ci;
  const float a_dn = live ? a.A[(size_t)d * N + n] : 0.f;
  const float Bc = (live && !a.b_var) ? mmu::bc_const<TB>(a.Bm, a.bs, d, n) : 0.f;
  const float Cc = (live && !a.c_var) ? mmu::bc_const<TB>(a.Cm, a.cs, d, n) : 0.f;
  const float Dd = (chan && a.Dskip) ? a.Dskip[d] : 0.f;
  const size_t sidx = (((size_t)k.b * a.nC + c) * a.Dm + d) * N + n;
  float* us = u_s + ci * ld;
  float* dts = dt_s + ci * ld;
  const float* dys = dy_s + ci * ld;
  const float* dos = do_s + ci * ld;
  float* zs = z_s + ci * ld;
  const float* Bn = B_s + n * ld;
  const float* Cn = C_s + n * ld;

  // walk 1, in scan order: the state entering each sub-chunk, into this
  // thread's column of ck_s
  float h = live ? a.state[sidx] : 0.f;
  for (int s = 0; s < nsub; ++s) {
    ck_s[s * blockDim.x + threadIdx.x] = h;
#pragma unroll
    for (int q = 0; q < kS; q += 4) {
      const int t = s * kS + q;
      const mmu::Quad dt4 = mmu::quad(dts + t), u4 = mmu::quad(us + t);
      const mmu::Quad b4 = mmu::quad(Bn + t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h = expf(dt4.v[j] * a_dn) * h + dt4.v[j] * u4.v[j] * (b4.v[j] + Bc);
    }
  }
  float carry = 0.f;
  if (live && a.nC > 1) carry = o.gcarry[sidx];
  else if (live && o.dlast) carry = o.dlast[((size_t)k.b * a.Dm + d) * N + n];
  float dA_acc = 0.f, dB_acc = 0.f, dC_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;
  for (int s = nsub - 1; s >= 0; --s) {  // sub-chunks against the scan direction
    // rebuild the sub-chunk's states and decays into registers
    float hr[kS], ar[kS], pa[kS];
    float* pb = part + (s & 1) * 2 * W * pw;
    h = ck_s[s * blockDim.x + threadIdx.x];
#pragma unroll
    for (int q = 0; q < kS; q += 4) {
      const int t = s * kS + q;
      const mmu::Quad dt4 = mmu::quad(dts + t), u4 = mmu::quad(us + t);
      const mmu::Quad b4 = mmu::quad(Bn + t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ar[q + j] = expf(dt4.v[j] * a_dn);
        h = ar[q + j] * h + dt4.v[j] * u4.v[j] * (b4.v[j] + Bc);
        hr[q + j] = h;
      }
    }
    // the adjoint: g and this lane's terms per token; the sums over the
    // warp's channels at once (each warp its own cells of `part`), the sums
    // over the states after the walk
#pragma unroll
    for (int q = kS - 4; q >= 0; q -= 4) {
      const int t = s * kS + q;
      const mmu::Quad dt4 = mmu::quad(dts + t), u4 = mmu::quad(us + t), dy4 = mmu::quad(dys + t);
      const mmu::Quad b4 = mmu::quad(Bn + t), c4 = mmu::quad(Cn + t);
#pragma unroll
      for (int jj = 3; jj >= 0; --jj) {
        const int j = q + jj;
        const float dtu = dt4.v[jj] * u4.v[jj], dyv = dy4.v[jj];
        const float Bv = b4.v[jj] + Bc, Cv = c4.v[jj] + Cc;
        const float g = dyv * Cv + carry;
        const float gah = g * (hr[j] - dtu * Bv);  // g a h_prev
        float vB = g * dtu, vC = hr[j] * dyv;
        dB_acc += vB;  // a constant B's and C's sums over the tokens
        dC_acc += vC;
#pragma unroll
        for (int off = NP; off < 32; off <<= 1) {
          vB += __shfl_xor_sync(0xffffffffu, vB, off);
          vC += __shfl_xor_sync(0xffffffffu, vC, off);
        }
        if (lane < NP) {  // lane == n
          pb[(warp * kS + j) * (NP + 1) + lane] = vB;
          pb[((W + warp) * kS + j) * (NP + 1) + lane] = vC;
        }
        dA_acc += gah * dt4.v[jj];
        carry = ar[j] * g;
        ar[j] = g * Bv;          // now the terms of sum_n g B,
        pa[j] = gah * a_dn;      // sum_n g a h_prev A
        hr[j] = hr[j] * Cv;      // and sum_n h C
      }
    }
    // every lane of the group has read u, dt and dy of the sub-chunk's
    // tokens: the sums' owners overwrite u and dt, and z with dz
    mmu::group_sum_scatter<NP>(ar, lane);
    mmu::group_sum_scatter<NP>(pa, lane);
    mmu::group_sum_scatter<NP>(hr, lane);
    if (chan && n % kRep == 0) {
#pragma unroll
      for (int i = 0; i < kS / kNe; ++i) {
        const int t = s * kS + n / kRep * (kS / kNe) + i;
        const float dtv = dts[t], uv = us[t], dyv = dys[t];
        float ddt = pa[i] + uv * ar[i];
        if (a.softplus) ddt *= -expm1f(-dtv);  // sigmoid(raw) = 1 - exp(-softplus(raw))
        dD_acc += dyv * uv;
        dbias_acc += ddt;
        us[t] = dtv * ar[i] + dyv * Dd;
        dts[t] = ddt;
        if (has_z) {
          const float zv = zs[t], sz = 1.f / (1.f + expf(-zv));
          zs[t] = dos[t] * (hr[i] + Dd * uv) * (sz + zv * sz * (1.f - sz));
        }
      }
    }
    if (a.b_var || a.c_var) {
      // this block's partial of a varying dB / dC for the sub-chunk's
      // tokens, summed over the warps in a fixed order, each (n, token)
      // by one thread: row blockIdx.x of (B * spans * nDB, N, L)
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * N * kS; i += blockDim.x) {
        const int q = i / (N * kS), nn = i / kS % N, j = i % kS, gt = t0 + s * kS + j;
        if (!(q ? a.c_var : a.b_var) || gt >= a.L) continue;
        const float* p = pb + q * W * pw + j * (NP + 1) + nn;
        float sum = 0.f;
        for (int w = 0; w < W; ++w) sum += p[w * pw];
        (q ? o.p_dC : o.p_dB)[((size_t)blockIdx.x * N + nn) * a.L + gt] = sum;
      }
    }
  }
#pragma unroll
  for (int off = NP / 2; off > 0; off >>= 1) {  // the owners' sums over the group
    dD_acc += __shfl_xor_sync(0xffffffffu, dD_acc, off);
    dbias_acc += __shfl_xor_sync(0xffffffffu, dbias_acc, off);
  }
  if (live) {
    o.p_dA[sidx] = dA_acc;
    if (!a.b_var) o.p_dB[sidx] = dB_acc;
    if (!a.c_var) o.p_dC[sidx] = dC_acc;
  }
  if (chan && n == 0) {
    const size_t cidx = ((size_t)k.b * a.nC + c) * a.Dm + d;
    if (o.p_dD) o.p_dD[cidx] = dD_acc;
    if (o.p_dbias) o.p_dbias[cidx] = dbias_acc;
  }
  __syncthreads();

  // per-token gradients in the stream dtype, coalesced along L
  TI* du = static_cast<TI*>(o.du);
  TI* ddelta = static_cast<TI*>(o.ddelta);
  TI* dz = static_cast<TI*>(o.dz);
  for (int i = threadIdx.x; i < CH * T; i += blockDim.x) {
    const int cj = i / T, t = i - cj * T, gt = t0 + t;
    if (cj >= k.live || gt >= a.L) continue;
    const size_t off = ((size_t)k.b * a.Dm + k.d0 + cj) * a.L + gt;
    du[off] = mmu::from_f32<TI>(u_s[cj * ld + t]);
    ddelta[off] = mmu::from_f32<TI>(dt_s[cj * ld + t]);
    if (has_z) dz[off] = mmu::from_f32<TI>(z_s[cj * ld + t]);
  }
}

template <typename TI, typename TB, int NP>
cudaError_t launch_chunk(const ScanArgs& a, const BwdOut& o, dim3 grid, int threads,
                         cudaStream_t stream) {
  const size_t smem = ((size_t)(5 * a.chans + 2 * NP) * (a.T + 4) +
                       (size_t)(a.T / kS) * threads + 4 * (threads / 32) * kS * (NP + 1)) *
                      sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(scan_bwd_chunk_kernel<TI, TB, NP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  scan_bwd_chunk_kernel<TI, TB, NP><<<grid, threads, smem, stream>>>(a, o);
  return cudaSuccess;
}

template <typename TI, typename TB>
int launch(const ScanArgs& a, const BwdOut& o, cudaStream_t stream) {
  const dim3 grid(a.Bsz * (a.Dm / a.span) * a.nDB, a.nC);
  const int threads = a.chans * a.NP;
  const size_t smem_local = (size_t)(2 * a.chans + a.NP) * (a.T + 4) * sizeof(float);
  cudaError_t err;
  if (a.nC > 1) {
    err = cudaFuncSetAttribute(scan_bwd_local_kernel<TI, TB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_local);
    if (err != cudaSuccess) return err;
    scan_bwd_local_kernel<TI, TB><<<grid, threads, smem_local, stream>>>(a, o);
    const int64_t chains = (int64_t)a.Bsz * a.Dm * a.N;
    scan_bwd_combine_kernel<<<(unsigned)((chains + 127) / 128), 128, 0, stream>>>(a, o);
  }
  switch (a.NP) {
    case 1: err = launch_chunk<TI, TB, 1>(a, o, grid, threads, stream); break;
    case 2: err = launch_chunk<TI, TB, 2>(a, o, grid, threads, stream); break;
    case 4: err = launch_chunk<TI, TB, 4>(a, o, grid, threads, stream); break;
    case 8: err = launch_chunk<TI, TB, 8>(a, o, grid, threads, stream); break;
    case 16: err = launch_chunk<TI, TB, 16>(a, o, grid, threads, stream); break;
    default: err = launch_chunk<TI, TB, 32>(a, o, grid, threads, stream); break;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_bwd(const void* u, const void* delta, const void* z, const void* Bm,
                                  const void* Cm, const void* A, const void* bias,
                                  const void* Dskip, const void* state, const void* dtsum,
                                  const void* dout, const void* dlast, void* du, void* ddelta,
                                  void* dz,
                                  void* gcarry, void* p_dA, void* p_dD, void* p_dbias,
                                  void* p_dB, void* p_dC, const int64_t* bc_strides, int b_gdiv,
                                  int c_gdiv, int b_var, int c_var, int Bsz, int Dm, int L, int N,
                                  int T, int span, int chans, int softplus, int is_bf16,
                                  int bc_bf16, void* stream) {
  mmu::ScanArgs a;
  if (!mmu::fill_scan_args(a, u, delta, z, Bm, Cm, A, bias, Dskip, const_cast<void*>(state),
                           const_cast<void*>(dtsum), bc_strides, b_gdiv, c_gdiv, b_var, c_var,
                           Bsz, Dm, L, N, T, span, chans, softplus) ||
      T % kS != 0)  // pass C walks whole sub-chunks
    return cudaErrorInvalidValue;
  BwdOut o;
  o.dout = dout; o.dlast = static_cast<const float*>(dlast); o.du = du; o.ddelta = ddelta; o.dz = dz;
  o.gcarry = static_cast<float*>(gcarry);
  o.p_dA = static_cast<float*>(p_dA);
  o.p_dD = static_cast<float*>(p_dD);
  o.p_dbias = static_cast<float*>(p_dbias);
  o.p_dB = static_cast<float*>(p_dB);
  o.p_dC = static_cast<float*>(p_dC);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bc_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, o, st)
                   : launch<__nv_bfloat16, float>(a, o, st);
  return bc_bf16 ? launch<float, __nv_bfloat16>(a, o, st) : launch<float, float>(a, o, st);
}
