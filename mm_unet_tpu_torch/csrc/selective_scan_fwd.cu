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
// read coalesced along L; C . h is a shuffle reduction inside the NP-lane
// group of a channel.
#include <cstdint>

#include "common.cuh"
#include "selective_scan.cuh"

namespace {

using mmu::ScanArgs;

// FINAL = false: pass 1 (zero entry state; emit end state and sum of dt).
// FINAL = true: pass 3 (entry state from the combine; emit the output).
template <typename TI, typename TB, bool FINAL>
__global__ void __launch_bounds__(512) scan_fwd_kernel(ScanArgs a, void* out, float* last) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, NP = a.NP, CH = a.chans;
  float* u_s = smem;            // [CH][T] u
  float* dt_s = u_s + CH * T;   // [CH][T] dt; pass 3 overwrites it with C . h
  float* B_s = dt_s + CH * T;   // [N][T] varying B
  float* C_s = B_s + N * T;     // [N][T] varying C (pass 3)
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  mmu::stage_rows<TI>(a, k, a.u, t0, u_s);
  mmu::stage_dt<TI>(a, k, t0, dt_s);
  if (a.b_var) mmu::stage_bc<TB>(a, k, a.Bm, a.bs, a.b_gdiv, t0, B_s);
  if (FINAL && a.c_var) mmu::stage_bc<TB>(a, k, a.Cm, a.cs, a.c_gdiv, t0, C_s);
  __syncthreads();

  // one thread per (channel ci, state n); every lane runs the loop (dead
  // lanes with zero inputs), so the shuffles always see whole warps
  const int ci = threadIdx.x / NP, n = threadIdx.x - ci * NP;
  const bool live = ci < k.live && n < N;
  const int d = k.d0 + ci;
  const float a_dn = live ? a.A[(size_t)d * N + n] : 0.f;
  const float Bc = (live && !a.b_var) ? mmu::bc_const<TB>(a.Bm, a.bs, d, n) : 0.f;
  const float Cc = (FINAL && live && !a.c_var) ? mmu::bc_const<TB>(a.Cm, a.cs, d, n) : 0.f;
  const size_t sidx = (((size_t)k.b * a.nC + c) * a.Dm + d) * N + n;
  float h = 0.f, sum_dt = 0.f;
  if (FINAL && live) {
    if (a.nC > 1) h = a.state[sidx];
    else a.state[sidx] = 0.f;  // one chunk: no pass 1; the backward reads a zero entry state
  }
  float* dts = dt_s + ci * T;
  const float* us = u_s + ci * T;
  for (int t = 0; t < T; ++t) {
    const float dtv = dts[t];
    const float Bv = a.b_var ? (n < N ? B_s[n * T + t] : 0.f) : Bc;
    h = expf(dtv * a_dn) * h + dtv * us[t] * Bv;
    if (FINAL) {
      float yp = h * (a.c_var ? (n < N ? C_s[n * T + t] : 0.f) : Cc);
      for (int off = NP / 2; off > 0; off >>= 1) yp += __shfl_xor_sync(0xffffffffu, yp, off);
      // every lane of the group has read dt[ci][t] before the shuffle
      if (n == 0) dts[t] = yp;
    } else {
      sum_dt += dtv;
    }
  }
  if (!FINAL) {
    if (live) a.state[sidx] = h;
    if (live && n == 0) a.dtsum[((size_t)k.b * a.nC + c) * a.Dm + d] = sum_dt;
    return;
  }
  if (last && live && c == a.nC - 1) last[((size_t)k.b * a.Dm + d) * N + n] = h;
  __syncthreads();

  // epilogue: + D u, gate with silu(z), write in the stream dtype, coalesced along L
  const TI* z = static_cast<const TI*>(a.z);
  TI* o = static_cast<TI*>(out);
  for (int i = threadIdx.x; i < CH * T; i += blockDim.x) {
    const int cj = i / T, gt = t0 + (i - cj * T);
    if (cj >= k.live || gt >= a.L) continue;
    const int dj = k.d0 + cj;
    const size_t off = ((size_t)k.b * a.Dm + dj) * a.L + gt;
    float y = dt_s[i];
    if (a.Dskip) y += a.Dskip[dj] * u_s[i];
    if (z) y *= mmu::silu(mmu::to_f32(z[off]));
    o[off] = mmu::from_f32<TI>(y);
  }
}

// Pass 2: for each (b, d, n), walk the chunks in order and replace each
// chunk's zero-entry end state by its true entry state.
__global__ void scan_combine_kernel(ScanArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.Bsz * a.Dm * a.N) return;
  const int n = i % a.N, d = (i / a.N) % a.Dm;
  const int64_t b = i / ((int64_t)a.Dm * a.N);
  const float a_dn = a.A[(size_t)d * a.N + n];
  float carry = 0.f;
  for (int c = 0; c < a.nC; ++c) {
    const size_t sc = (size_t)b * a.nC + c;
    const size_t k = (sc * a.Dm + d) * a.N + n;
    const float h_end = a.state[k];
    const float decay = expf(a_dn * a.dtsum[sc * a.Dm + d]);
    a.state[k] = carry;
    carry = decay * carry + h_end;
  }
}

template <typename TI, typename TB>
int launch(const ScanArgs& a, void* out, float* last, cudaStream_t stream) {
  const dim3 grid(a.Bsz * (a.Dm / a.span) * a.nDB, a.nC);
  const int threads = a.chans * a.NP;
  const size_t smem = (size_t)(2 * a.chans + 2 * a.N) * a.T * sizeof(float);
  cudaError_t err;
  if (a.nC > 1) {
    err = cudaFuncSetAttribute(scan_fwd_kernel<TI, TB, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    scan_fwd_kernel<TI, TB, false><<<grid, threads, smem, stream>>>(a, out, last);
    const int64_t chains = (int64_t)a.Bsz * a.Dm * a.N;
    scan_combine_kernel<<<(unsigned)((chains + 255) / 256), 256, 0, stream>>>(a);
  }
  err = cudaFuncSetAttribute(scan_fwd_kernel<TI, TB, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scan_fwd_kernel<TI, TB, true><<<grid, threads, smem, stream>>>(a, out, last);
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
                           c_gdiv, b_var, c_var, Bsz, Dm, L, N, T, span, chans, softplus))
    return cudaErrorInvalidValue;
  float* lst = static_cast<float*>(last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bc_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, out, lst, st)
                   : launch<__nv_bfloat16, float>(a, out, lst, st);
  return bc_bf16 ? launch<float, __nv_bfloat16>(a, out, lst, st) : launch<float, float>(a, out, lst, st);
}
