// Chunked selective scan, forward, for Hopper:
//   dt  = softplus(delta + bias)              (bias, softplus optional)
//   h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t  (state f32)
//   y_t = C_t . h_t + D u_t, gated by silu(z_t)  (D, z optional)
// with the last state on request.
//
// Replaces two TPU kernels of mm_unet_tpu/ops/pallas_scan.py with one: the
// fused _fwd_kernel_fused (launched by _scan_core_fused._fwd_call: softplus
// prologue, D-skip and gate epilogue in the kernel) and the bare _fwd_kernel
// (launched by _scan_core._fwd_call: y and the last state; prologue and
// epilogue left to XLA). Here the prologue and epilogue are flags, so both
// are this kernel. The output is written in the stream dtype; the state and
// every sum are f32.
//
// What bounds it on the H100: the bytes of u, delta, z and the output (the
// state never leaves the chip), about 0.44 GB for dkDualNet's stage-2 scan
// at batch 8 in f32, 0.13 ms at 3.35 TB/s; its arithmetic, an expf and a few
// FMAs per (b, d, n, t), is a tenth of that at the f32 peak. The scan itself
// is a chain of dependent exp/multiply-adds along L per (b, d, n), and
// dkDualNet's widest-L scan has only 8 * 192 * 16 chains, too few to fill 132
// SMs if each walked all 16,384 tokens. So, as the fused Mamba forward, L is
// cut into chunks of T tokens, one block per (batch, channel block, chunk):
//   1. each block scans its chunk from a zero state and keeps the end state
//      and the chunk's sum of dt (its decay is exp(A * sum dt));
//   2. a small kernel combines the chunks in order per (b, d, n), turning end
//      states into true entry states in place (kept for the backward);
//   3. each block rescans its chunk from its entry state and writes the
//      output; the last chunk's final state is the last state.
// u, dt and the group's B/C chunk are staged in shared memory once per pass,
// read coalesced along L, in rows of T + 1 floats (the N state lanes of a
// channel read their B or C rows at one token in distinct banks). Pass 3
// walks its chunk in sub-chunks of kS tokens, keeps each lane's C . h terms
// of a sub-chunk in registers and sums them over the state group by the
// scattering butterfly (group_sum_scatter, mamba_chunk.cuh; kS - 1 shuffles
// where a sum per token takes kS log2 NP), templated on NP, the state lanes
// rounded up to a power of two with the lanes past N holding zeros. Pass 2
// issues the loads of kAhead chunks together.
#include <cstdint>

#include "common.cuh"
#include "mamba_chunk.cuh"
#include "selective_scan.cuh"

namespace {

using mmu::kAhead;
using mmu::kS;  // tokens per sub-chunk of pass 3, whose C . h terms live in registers
using mmu::ScanArgs;

// Pass 1: each block scans its chunk from a zero state and keeps the end
// state and the chunk's sum of dt (no sums over the states: dead lanes leave).
template <typename TI, typename TB>
__global__ void __launch_bounds__(512) scan_fwd_local_kernel(ScanArgs a) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, NP = a.NP, CH = a.chans, ld = T + 1;
  float* u_s = smem;            // [CH][T + 1] u
  float* dt_s = u_s + CH * ld;  // [CH][T + 1] dt
  float* B_s = dt_s + CH * ld;  // [N][T + 1] varying B
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  mmu::stage_rows<TI>(a, k, a.u, t0, ld, u_s);
  mmu::stage_dt<TI>(a, k, t0, ld, dt_s);
  if (a.b_var) mmu::stage_bc<TB>(a, k, a.Bm, a.bs, a.b_gdiv, t0, ld, N, B_s);
  __syncthreads();
  const int ci = threadIdx.x / NP, n = threadIdx.x % NP;
  if (ci >= k.live || n >= N) return;
  const int d = k.d0 + ci;
  const float a_dn = a.A[(size_t)d * N + n];
  const float Bc = a.b_var ? 0.f : mmu::bc_const<TB>(a.Bm, a.bs, d, n);
  const float* dts = dt_s + ci * ld;
  const float* us = u_s + ci * ld;
  const float* Bn = B_s + n * ld;
  float h = 0.f, sum_dt = 0.f;
  for (int s = 0; s < T; s += kS) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const float dtv = dts[s + j];
      h = expf(dtv * a_dn) * h + dtv * us[s + j] * (a.b_var ? Bn[s + j] : Bc);
      sum_dt += dtv;
    }
  }
  const size_t sidx = (((size_t)k.b * a.nC + c) * a.Dm + d) * N + n;
  a.state[sidx] = h;
  if (n == 0) a.dtsum[((size_t)k.b * a.nC + c) * a.Dm + d] = sum_dt;
}

// Pass 3: each block rescans its chunk from its entry state and writes the
// output. NP is the lanes of a channel's state group (N rounded up to a
// power of two); C . h is summed over them per sub-chunk of kS tokens by the
// scattering butterfly.
template <typename TI, typename TB, int NP>
__global__ void __launch_bounds__(512) scan_fwd_kernel(ScanArgs a, void* out, float* last) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, CH = a.chans, ld = T + 1;
  float* u_s = smem;            // [CH][T + 1] u
  float* dt_s = u_s + CH * ld;  // [CH][T + 1] dt, overwritten with C . h
  float* B_s = dt_s + CH * ld;  // [NP][T + 1] varying B, rows past N zero
  float* C_s = B_s + NP * ld;   // [NP][T + 1] varying C
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  mmu::stage_rows<TI>(a, k, a.u, t0, ld, u_s);
  mmu::stage_dt<TI>(a, k, t0, ld, dt_s);
  if (a.b_var) mmu::stage_bc<TB>(a, k, a.Bm, a.bs, a.b_gdiv, t0, ld, NP, B_s);
  if (a.c_var) mmu::stage_bc<TB>(a, k, a.Cm, a.cs, a.c_gdiv, t0, ld, NP, C_s);
  __syncthreads();

  // one thread per (channel ci, state n); every lane runs the loop (dead
  // lanes with zero inputs), so the shuffles always see whole warps
  constexpr int kNe = NP < kS ? NP : kS;  // lanes of a group that end with distinct sums
  constexpr int kRep = NP / kNe;          // lanes that hold each of them
  const int ci = threadIdx.x / NP, n = threadIdx.x % NP, lane = threadIdx.x & 31;
  const bool live = ci < k.live && n < N;
  const int d = k.d0 + ci;
  const float a_dn = live ? a.A[(size_t)d * N + n] : 0.f;
  const float Bc = (live && !a.b_var) ? mmu::bc_const<TB>(a.Bm, a.bs, d, n) : 0.f;
  const float Cc = (live && !a.c_var) ? mmu::bc_const<TB>(a.Cm, a.cs, d, n) : 0.f;
  const size_t sidx = (((size_t)k.b * a.nC + c) * a.Dm + d) * N + n;
  float h = 0.f;
  if (live) {
    if (a.nC > 1) h = a.state[sidx];
    else a.state[sidx] = 0.f;  // one chunk: no pass 1; the backward reads a zero entry state
  }
  float* dts = dt_s + ci * ld;
  const float* us = u_s + ci * ld;
  const float* Bn = B_s + n * ld;
  const float* Cn = C_s + n * ld;
  for (int s = 0; s < T; s += kS) {
    float yp[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const float dtv = dts[s + j];
      h = expf(dtv * a_dn) * h + dtv * us[s + j] * (a.b_var ? Bn[s + j] : Bc);
      yp[j] = h * (a.c_var ? Cn[s + j] : Cc);
    }
    // every lane of the group has read the sub-chunk's dt: the sums' owners
    // overwrite it with C . h
    mmu::group_sum_scatter<NP>(yp, lane);
    if (n % kRep == 0) {
#pragma unroll
      for (int i = 0; i < kS / kNe; ++i) dts[s + n / kRep * (kS / kNe) + i] = yp[i];
    }
  }
  if (last && live && c == a.nC - 1) last[((size_t)k.b * a.Dm + d) * N + n] = h;
  __syncthreads();

  // epilogue: + D u, gate with silu(z), write in the stream dtype, coalesced along L
  const TI* z = static_cast<const TI*>(a.z);
  TI* o = static_cast<TI*>(out);
  for (int i = threadIdx.x; i < CH * T; i += blockDim.x) {
    const int cj = i / T, t = i - cj * T, gt = t0 + t;
    if (cj >= k.live || gt >= a.L) continue;
    const int dj = k.d0 + cj;
    const size_t off = ((size_t)k.b * a.Dm + dj) * a.L + gt;
    float y = dt_s[cj * ld + t];
    if (a.Dskip) y += a.Dskip[dj] * u_s[cj * ld + t];
    if (z) y *= mmu::silu(mmu::to_f32(z[off]));
    o[off] = mmu::from_f32<TI>(y);
  }
}

// Pass 2: for each (b, d, n), walk the chunks in order and replace each
// chunk's zero-entry end state by its true entry state. The walk is one
// dependent chain with a load per chunk: the loads of kAhead chunks are
// issued together, so a chain waits on memory once per kAhead chunks.
__global__ void __launch_bounds__(128) scan_combine_kernel(ScanArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.Bsz * a.Dm * a.N) return;
  const int n = i % a.N, d = (i / a.N) % a.Dm;
  const int64_t b = i / ((int64_t)a.Dm * a.N);
  const float a_dn = a.A[(size_t)d * a.N + n];
  float carry = 0.f;
  for (int c0 = 0; c0 < a.nC; c0 += kAhead) {
    float h_end[kAhead], dts[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const size_t sc = (size_t)b * a.nC + c0 + j;
      h_end[j] = c0 + j < a.nC ? a.state[(sc * a.Dm + d) * a.N + n] : 0.f;
      dts[j] = c0 + j < a.nC ? a.dtsum[sc * a.Dm + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < a.nC) {
        a.state[(((size_t)b * a.nC + c0 + j) * a.Dm + d) * a.N + n] = carry;
        carry = expf(a_dn * dts[j]) * carry + h_end[j];
      }
    }
  }
}

template <typename TI, typename TB, int NP>
cudaError_t launch_final(const ScanArgs& a, void* out, float* last, dim3 grid, int threads,
                         cudaStream_t stream) {
  const size_t smem = (size_t)(2 * a.chans + 2 * NP) * (a.T + 1) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(scan_fwd_kernel<TI, TB, NP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  scan_fwd_kernel<TI, TB, NP><<<grid, threads, smem, stream>>>(a, out, last);
  return cudaSuccess;
}

template <typename TI, typename TB>
int launch(const ScanArgs& a, void* out, float* last, cudaStream_t stream) {
  const dim3 grid(a.Bsz * (a.Dm / a.span) * a.nDB, a.nC);
  const int threads = a.chans * a.NP;
  cudaError_t err;
  if (a.nC > 1) {
    const size_t smem = (size_t)(2 * a.chans + a.N) * (a.T + 1) * sizeof(float);
    err = cudaFuncSetAttribute(scan_fwd_local_kernel<TI, TB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    scan_fwd_local_kernel<TI, TB><<<grid, threads, smem, stream>>>(a);
    const int64_t chains = (int64_t)a.Bsz * a.Dm * a.N;
    scan_combine_kernel<<<(unsigned)((chains + 127) / 128), 128, 0, stream>>>(a);
  }
  switch (a.NP) {
    case 1: err = launch_final<TI, TB, 1>(a, out, last, grid, threads, stream); break;
    case 2: err = launch_final<TI, TB, 2>(a, out, last, grid, threads, stream); break;
    case 4: err = launch_final<TI, TB, 4>(a, out, last, grid, threads, stream); break;
    case 8: err = launch_final<TI, TB, 8>(a, out, last, grid, threads, stream); break;
    case 16: err = launch_final<TI, TB, 16>(a, out, last, grid, threads, stream); break;
    default: err = launch_final<TI, TB, 32>(a, out, last, grid, threads, stream); break;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_fwd(const void* u, const void* delta, const void* z, const void* Bm,
                                  const void* Cm, const void* A, const void* bias,
                                  const void* Dskip, void* out, void* state, void* dtsum,
                                  void* last, const int64_t* bc_strides, int b_gdiv, int c_gdiv,
                                  int b_var, int c_var, int Bsz, int Dm, int L, int N, int T,
                                  int span, int chans, int softplus, int is_bf16, int bc_bf16,
                                  void* stream) {
  mmu::ScanArgs a;
  if (!mmu::fill_scan_args(a, u, delta, z, Bm, Cm, A, bias, Dskip, state, dtsum, bc_strides, b_gdiv,
                           c_gdiv, b_var, c_var, Bsz, Dm, L, N, T, span, chans, softplus) ||
      T % kS != 0)  // the passes walk whole sub-chunks
    return cudaErrorInvalidValue;
  float* lst = static_cast<float*>(last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bc_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, out, lst, st)
                   : launch<__nv_bfloat16, float>(a, out, lst, st);
  return bc_bf16 ? launch<float, __nv_bfloat16>(a, out, lst, st) : launch<float, float>(a, out, lst, st);
}
