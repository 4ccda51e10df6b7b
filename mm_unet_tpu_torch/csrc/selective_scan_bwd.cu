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
// Every gradient is computed in f32 and written in its input's dtype; the
// last state takes no gradient.
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
//   C. each block rebuilds h across its chunk from the saved entry state
//      into a per-thread buffer, walks back with g from the true carry, and
//      accumulates every term: sums over the states by shuffles inside the
//      NP-lane group of a channel; sums over channels of a varying dB / dC
//      pre-summed across the warp and added with one shared-memory atomic per
//      (n, t); per-parameter sums as per-thread registers. Parameter and
//      dB / dC sums leave as per-block partials in f32, which the wrapper
//      adds up (no global atomics: the result does not depend on the order
//      blocks run in).
#include <cstdint>

#include "common.cuh"
#include "selective_scan.cuh"

namespace {

using mmu::ScanArgs;

constexpr int kMaxT = 128;  // longest chunk: the per-thread h buffer

struct BwdOut {
  const void* dout;  // (B, Dm, L) stream dtype
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

// dy_s [CH][T] = dout * silu(z) (dout without z), 0 past L
template <typename TI>
__device__ void stage_dy(const ScanArgs& a, const BwdOut& o, const mmu::Blk& k, int t0,
                         float* dy_s) {
  const TI* dout = static_cast<const TI*>(o.dout);
  const TI* z = static_cast<const TI*>(a.z);
  for (int i = threadIdx.x; i < a.chans * a.T; i += blockDim.x) {
    const int c = i / a.T, gt = t0 + (i - c * a.T);
    float v = 0.f;
    if (c < k.live && gt < a.L) {
      const size_t off = ((size_t)k.b * a.Dm + k.d0 + c) * a.L + gt;
      v = mmu::to_f32(dout[off]);
      if (z) v *= mmu::silu(mmu::to_f32(z[off]));
    }
    dy_s[i] = v;
  }
}

// Pass A: the adjoint across one chunk from a zero carry; emits a_0 g_0.
template <typename TI, typename TB>
__global__ void __launch_bounds__(512) scan_bwd_local_kernel(ScanArgs a, BwdOut o) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, NP = a.NP;
  float* dt_s = smem;                // [CH][T]
  float* dy_s = dt_s + a.chans * T;  // [CH][T]
  float* C_s = dy_s + a.chans * T;   // [N][T] varying C
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  mmu::stage_dt<TI>(a, k, t0, dt_s);
  stage_dy<TI>(a, o, k, t0, dy_s);
  if (a.c_var) mmu::stage_bc<TB>(a, k, a.Cm, a.cs, a.c_gdiv, t0, C_s);
  __syncthreads();
  const int ci = threadIdx.x / NP, n = threadIdx.x - ci * NP;
  if (ci >= k.live || n >= N) return;  // no shuffles in this pass
  const int d = k.d0 + ci;
  const float a_dn = a.A[(size_t)d * N + n];
  const float Cc = a.c_var ? 0.f : mmu::bc_const<TB>(a.Cm, a.cs, d, n);
  const float* dts = dt_s + ci * T;
  const float* dys = dy_s + ci * T;
  float carry = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float g = dys[t] * (a.c_var ? C_s[n * T + t] : Cc) + carry;
    carry = expf(dts[t] * a_dn) * g;
  }
  o.gcarry[(((size_t)k.b * a.nC + c) * a.Dm + d) * N + n] = carry;
}

// Pass B: local boundary adjoints -> the true adjoint entering each chunk
// from the chunk after it.
__global__ void scan_bwd_combine_kernel(ScanArgs a, BwdOut o) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.Bsz * a.Dm * a.N) return;
  const int n = i % a.N, d = (i / a.N) % a.Dm;
  const int64_t b = i / ((int64_t)a.Dm * a.N);
  const float a_dn = a.A[(size_t)d * a.N + n];
  float carry = 0.f;
  for (int c = a.nC - 1; c >= 0; --c) {
    const size_t sc = (size_t)b * a.nC + c;
    const size_t k = (sc * a.Dm + d) * a.N + n;
    const float local = o.gcarry[k];
    o.gcarry[k] = carry;
    carry = local + expf(a_dn * a.dtsum[sc * a.Dm + d]) * carry;
  }
}

// Pass C: the full adjoint of one chunk and every gradient term.
template <typename TI, typename TB>
__global__ void __launch_bounds__(512) scan_bwd_chunk_kernel(ScanArgs a, BwdOut o) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, NP = a.NP, CH = a.chans;
  float* u_s = smem;            // [CH][T] u, then du
  float* dt_s = u_s + CH * T;   // [CH][T] dt, then ddelta
  float* do_s = dt_s + CH * T;  // [CH][T] dout
  float* z_s = do_s + CH * T;   // [CH][T] z, then dz
  float* B_s = z_s + CH * T;    // [N][T] varying B
  float* C_s = B_s + N * T;     // [N][T] varying C
  float* dB_s = C_s + N * T;    // [N][T] sum over the block's channels (varying B)
  float* dC_s = dB_s + N * T;   // [N][T] (varying C)
  const mmu::Blk k = mmu::block_of(a);
  const int c = blockIdx.y, t0 = c * T;
  mmu::stage_rows<TI>(a, k, a.u, t0, u_s);
  mmu::stage_dt<TI>(a, k, t0, dt_s);
  mmu::stage_rows<TI>(a, k, o.dout, t0, do_s);
  const bool has_z = a.z != nullptr;
  if (has_z) mmu::stage_rows<TI>(a, k, a.z, t0, z_s);
  if (a.b_var) mmu::stage_bc<TB>(a, k, a.Bm, a.bs, a.b_gdiv, t0, B_s);
  if (a.c_var) mmu::stage_bc<TB>(a, k, a.Cm, a.cs, a.c_gdiv, t0, C_s);
  for (int i = threadIdx.x; i < 2 * N * T; i += blockDim.x) dB_s[i] = 0.f;
  __syncthreads();

  // every lane of a warp runs both walks (dead lanes with zero inputs), so
  // the shuffles below always see the full warp
  const int ci = threadIdx.x / NP, n = threadIdx.x - ci * NP;
  const int lane = threadIdx.x & 31;
  const bool chan = ci < k.live;
  const bool live = chan && n < N;
  const int d = k.d0 + ci;
  const float a_dn = live ? a.A[(size_t)d * N + n] : 0.f;
  const float Bc = (live && !a.b_var) ? mmu::bc_const<TB>(a.Bm, a.bs, d, n) : 0.f;
  const float Cc = (live && !a.c_var) ? mmu::bc_const<TB>(a.Cm, a.cs, d, n) : 0.f;
  const float Dd = (chan && a.Dskip) ? a.Dskip[d] : 0.f;
  const size_t sidx = (((size_t)k.b * a.nC + c) * a.Dm + d) * N + n;
  float* us = u_s + ci * T;
  float* dts = dt_s + ci * T;
  const float* dos = do_s + ci * T;
  float* zs = z_s + ci * T;

  float hbuf[kMaxT];
  float h = live ? a.state[sidx] : 0.f;
  for (int t = 0; t < T; ++t) {  // rebuild h in scan order
    const float Bv = a.b_var ? (n < N ? B_s[n * T + t] : 0.f) : Bc;
    h = expf(dts[t] * a_dn) * h + dts[t] * us[t] * Bv;
    hbuf[t] = h;
  }
  float carry = (live && a.nC > 1) ? o.gcarry[sidx] : 0.f;
  float dA_acc = 0.f, dB_acc = 0.f, dC_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;
  for (int t = T - 1; t >= 0; --t) {  // the adjoint, against the scan direction
    const float dtv = dts[t], uv = us[t], dov = dos[t];
    const float zv = has_z ? zs[t] : 0.f;
    const float sz = has_z ? 1.f / (1.f + expf(-zv)) : 0.f;
    const float dy = has_z ? dov * zv * sz : dov;
    const float Bv = a.b_var ? (n < N ? B_s[n * T + t] : 0.f) : Bc;
    const float Cv = a.c_var ? (n < N ? C_s[n * T + t] : 0.f) : Cc;
    const float hv = hbuf[t];
    const float g = dy * Cv + carry;
    const float gah = g * (hv - dtv * uv * Bv);  // g a h_prev
    float gB = g * Bv, pA = gah * a_dn, yp = hv * Cv;
    for (int off = NP / 2; off > 0; off >>= 1) {  // sums over the states
      gB += __shfl_xor_sync(0xffffffffu, gB, off);
      pA += __shfl_xor_sync(0xffffffffu, pA, off);
      yp += __shfl_xor_sync(0xffffffffu, yp, off);
    }
    float vB = g * dtv * uv, vC = hv * dy;
    if (a.b_var) {
      for (int off = NP; off < 32; off <<= 1) vB += __shfl_xor_sync(0xffffffffu, vB, off);
      if (lane < N) atomicAdd(&dB_s[lane * T + t], vB);  // lane == n; a dead channel adds 0
    } else {
      dB_acc += vB;
    }
    if (a.c_var) {
      for (int off = NP; off < 32; off <<= 1) vC += __shfl_xor_sync(0xffffffffu, vC, off);
      if (lane < N) atomicAdd(&dC_s[lane * T + t], vC);
    } else {
      dC_acc += vC;
    }
    dA_acc += gah * dtv;
    carry = expf(dtv * a_dn) * g;
    // every lane of the group read u, dt, z [ci][t] before the shuffles
    if (chan && n == 0) {
      float ddt = pA + uv * gB;
      if (a.softplus) ddt *= -expm1f(-dtv);  // sigmoid(raw) = 1 - exp(-softplus(raw))
      dD_acc += dy * uv;
      dbias_acc += ddt;
      us[t] = dtv * gB + dy * Dd;
      dts[t] = ddt;
      if (has_z) zs[t] = dov * (yp + Dd * uv) * (sz + zv * sz * (1.f - sz));
    }
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
    const int cj = i / T, gt = t0 + (i - cj * T);
    if (cj >= k.live || gt >= a.L) continue;
    const size_t off = ((size_t)k.b * a.Dm + k.d0 + cj) * a.L + gt;
    du[off] = mmu::from_f32<TI>(u_s[i]);
    ddelta[off] = mmu::from_f32<TI>(dt_s[i]);
    if (has_z) dz[off] = mmu::from_f32<TI>(z_s[i]);
  }
  // this block's partial of a varying dB / dC: row blockIdx.x of (B * spans * nDB, N, L)
  for (int i = threadIdx.x; i < N * T; i += blockDim.x) {
    const int nn = i / T, gt = t0 + (i - nn * T);
    if (gt >= a.L) continue;
    const size_t off = ((size_t)blockIdx.x * N + nn) * a.L + gt;
    if (a.b_var) o.p_dB[off] = dB_s[i];
    if (a.c_var) o.p_dC[off] = dC_s[i];
  }
}

template <typename TI, typename TB>
int launch(const ScanArgs& a, const BwdOut& o, cudaStream_t stream) {
  const dim3 grid(a.Bsz * (a.Dm / a.span) * a.nDB, a.nC);
  const int threads = a.chans * a.NP;
  const size_t smem_local = (size_t)(2 * a.chans + a.N) * a.T * sizeof(float);
  const size_t smem_chunk = (size_t)(4 * a.chans + 4 * a.N) * a.T * sizeof(float);
  cudaError_t err;
  if (a.nC > 1) {
    err = cudaFuncSetAttribute(scan_bwd_local_kernel<TI, TB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_local);
    if (err != cudaSuccess) return err;
    scan_bwd_local_kernel<TI, TB><<<grid, threads, smem_local, stream>>>(a, o);
    const int64_t chains = (int64_t)a.Bsz * a.Dm * a.N;
    scan_bwd_combine_kernel<<<(unsigned)((chains + 255) / 256), 256, 0, stream>>>(a, o);
  }
  err = cudaFuncSetAttribute(scan_bwd_chunk_kernel<TI, TB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_chunk);
  if (err != cudaSuccess) return err;
  scan_bwd_chunk_kernel<TI, TB><<<grid, threads, smem_chunk, stream>>>(a, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_bwd(const void* u, const void* delta, const void* z, const void* Bm,
                                  const void* Cm, const void* A, const void* bias,
                                  const void* Dskip, const void* state, const void* dtsum,
                                  const void* dout, void* du, void* ddelta, void* dz,
                                  void* gcarry, void* p_dA, void* p_dD, void* p_dbias,
                                  void* p_dB, void* p_dC, const int64_t* bc_strides, int b_gdiv,
                                  int c_gdiv, int b_var, int c_var, int Bsz, int Dm, int L, int N,
                                  int T, int span, int chans, int softplus, int is_bf16,
                                  int bc_bf16, void* stream) {
  mmu::ScanArgs a;
  if (!mmu::fill_scan_args(a, u, delta, z, Bm, Cm, A, bias, Dskip, const_cast<void*>(state),
                           const_cast<void*>(dtsum), bc_strides, b_gdiv, c_gdiv, b_var, c_var,
                           Bsz, Dm, L, N, T, span, chans, softplus) ||
      T > kMaxT)
    return cudaErrorInvalidValue;
  BwdOut o;
  o.dout = dout; o.du = du; o.ddelta = ddelta; o.dz = dz;
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
