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
// What bounds it on the H100: as the forward, the chain of dependent
// exp/multiply-adds per (b, channel, state) along L, run twice (rebuild h,
// then the adjoint walk), and for MM_Net's narrow MMConv scans (D = 6 or 2)
// too few chains to fill the card if each walked all of L. The TPU carries
// g, the edge decay and the neighbour chunk's dpre across a sequential grid
// axis; Hopper blocks run in no order, so the design mirrors the forward's
// three passes, one block per (batch, chunk of T tokens):
//   A. each block recomputes conv, x_proj and dt into shared memory and runs
//      the adjoint across its chunk from a zero carry, emitting the boundary
//      adjoint a_edge * g_edge per (d, n);
//   B. a small kernel walks the chunks against the scan direction per
//      (b, d, n), turning the local boundary adjoints into true carries
//      (a chunk's decay is exp(A * sum dt), the forward's saved sum);
//   C. each block rebuilds h across its chunk from the saved entry state
//      into a per-thread buffer, walks back with g from the true carry, and
//      accumulates every per-token and per-parameter term: sums over the N
//      states by shuffles inside an N-lane group, sums over channels by
//      shared-memory atomics; then the projection products, dz, and dpre
//      into an f32 (B, G, D, L) scratch;
//   D. a depthwise kernel turns dpre into dx (including the W-1 tokens that
//      cross each chunk edge) and the conv weight and bias gradients.
// Parameter gradients are per-block partials in f32, summed by the wrapper
// (as core_bwd sums over batch on the host).
#include <cstdint>

#include "common.cuh"
#include "mamba_chunk.cuh"

namespace {

constexpr int kMaxT = 256;       // longest chunk the wrapper picks: the h buffer
constexpr int kMaxW = 8;         // widest conv

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

// dy_s [D][T] = dout * silu(z), 0 past L
template <typename TI>
__device__ void load_dy(const BwdArgs& a, int bg, int t0, float* dy_s) {
  const int D = a.D, L = a.L, T = a.T;
  const TI* z = static_cast<const TI*>(a.xz) + ((size_t)bg * 2 + 1) * D * L;
  const TI* dout = static_cast<const TI*>(a.dout) + (size_t)bg * D * L;
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, gt = t0 + (i - d * T);
    dy_s[i] = gt < L ? mmu::to_f32(dout[(size_t)d * L + gt]) *
                           mmu::silu(mmu::to_f32(z[(size_t)d * L + gt]))
                     : 0.f;
  }
}

// Pass A: the adjoint across one chunk from a zero carry; emits a_edge g_edge.
template <typename TI>
__global__ void mamba_bwd_local_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, N = a.N, R = a.R;
  float* u_s = smem;
  float* dt_s = u_s + D * T;
  float* xd_s = dt_s + D * T;
  float* dy_s = xd_s + (R + 2 * N) * T;
  const int c = blockIdx.x, bg = blockIdx.y, t0 = c * T;
  const Row w = row_of(a, bg % a.G);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * a.L;
  load_dy<TI>(a, bg, t0, dy_s);
  mmu::recompute_chunk<TI>(x, D, a.L, T, t0, R, N, a.W, a.reverse, w.cw, w.cb, w.xp, w.dtw,
                           w.dtb, u_s, dt_s, xd_s);
  const float* Cs = xd_s + (R + N) * T;
  const size_t sbase = (size_t)bg * a.nC + c;
  for (int p = threadIdx.x; p < D * N; p += blockDim.x) {
    const int d = p / N, n = p - d * N;
    const float a_dn = w.A[p];
    float carry = 0.f;
    for (int s = 0; s < T; ++s) {
      const int t = a.reverse ? s : T - 1 - s;  // against the scan direction
      const float g = dy_s[d * T + t] * Cs[n * T + t] + carry;
      carry = expf(dt_s[d * T + t] * a_dn) * g;
    }
    a.gcarry[sbase * D * N + p] = carry;
  }
}

// Pass B: local boundary adjoints -> the true adjoint entering each chunk
// from its successor in scan order.
__global__ void mamba_bwd_combine_kernel(BwdArgs a) {
  const int D = a.D, N = a.N, nC = a.nC;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.B * a.G * D * N) return;
  const int n = i % N, d = (i / N) % D;
  const int64_t bg = i / ((int64_t)D * N);
  const float a_dn = a.A[((size_t)(bg % a.G) * D + d) * N + n];
  float carry = 0.f;
  for (int s = 0; s < nC; ++s) {
    const int c = a.reverse ? s : nC - 1 - s;
    const size_t sc = (size_t)bg * nC + c;
    const size_t k = (sc * D + d) * N + n;
    const float local = a.gcarry[k];
    a.gcarry[k] = carry;
    carry = local + expf(a_dn * a.dtsum[sc * D + d]) * carry;
  }
}

// Pass C: the full adjoint of one chunk and every term but the conv's.
template <typename TI>
__global__ void __launch_bounds__(512) mamba_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, N = a.N, R = a.R, L = a.L;
  const int E = R + 2 * N;
  float* u_s = smem;           // [D][T] conv output
  float* dt_s = u_s + D * T;   // [D][T] dt, overwritten by ddt_raw
  float* xd_s = dt_s + D * T;  // [E][T] x_dbl
  float* dy_s = xd_s + E * T;  // [D][T] dy, overwritten by y_pre, then dx_dbl's dt rows
  float* du_s = dy_s + D * T;  // [D][T] du of the scan
  float* dB_s = du_s + D * T;  // [N][T] dB, then [N][T] dC right after it
  float* dC_s = dB_s + N * T;

  const int c = blockIdx.x, bg = blockIdx.y, t0 = c * T;
  const Row w = row_of(a, bg % a.G);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L;
  load_dy<TI>(a, bg, t0, dy_s);
  for (int i = threadIdx.x; i < 2 * N * T; i += blockDim.x) dB_s[i] = 0.f;
  mmu::recompute_chunk<TI>(x, D, L, T, t0, R, N, a.W, a.reverse, w.cw, w.cb, w.xp, w.dtw, w.dtb,
                           u_s, dt_s, xd_s);

  const float* Bs = xd_s + R * T;
  const float* Cs = Bs + N * T;
  const int lane = threadIdx.x & 31;
  const size_t blk = (size_t)bg * a.nC + c;  // this chunk: states and partials
  float hbuf[kMaxT];
  // every lane of a warp runs both walks (lanes past D * N with zero
  // inputs), so the shuffles below always see the full warp
  for (int p0 = 0; p0 < D * N; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < D * N;
    const int pp = live ? p : 0;
    const int d = pp / N, n = pp - d * N;
    const float a_dn = w.A[pp];
    const float Dd = w.Dv[d];
    float h = live ? a.state[blk * D * N + pp] : 0.f;
    for (int s = 0; s < T; ++s) {  // rebuild h in scan order
      const int t = a.reverse ? T - 1 - s : s;
      const float dtv = live ? dt_s[d * T + t] : 0.f;
      const float uv = live ? u_s[d * T + t] : 0.f;
      h = expf(dtv * a_dn) * h + dtv * uv * Bs[n * T + t];
      hbuf[t] = h;
    }
    float carry = (live && a.nC > 1) ? a.gcarry[blk * D * N + pp] : 0.f;
    float dA_acc = 0.f, dD_acc = 0.f;
    for (int s = 0; s < T; ++s) {  // the adjoint, against the scan direction
      const int t = a.reverse ? s : T - 1 - s;
      const float dtv = live ? dt_s[d * T + t] : 0.f;
      const float uv = live ? u_s[d * T + t] : 0.f;
      const float dyv = live ? dy_s[d * T + t] : 0.f;
      const float Bv = Bs[n * T + t], Cv = Cs[n * T + t];
      const float hv = hbuf[t];
      const float g = dyv * Cv + carry;
      const float gah = g * (hv - dtv * uv * Bv);  // g * a * h_prev
      float gB = g * Bv, pA = gah * a_dn, yp = hv * Cv;
      for (int off = N / 2; off > 0; off >>= 1) {  // sums over n
        gB += __shfl_xor_sync(0xffffffffu, gB, off);
        pA += __shfl_xor_sync(0xffffffffu, pA, off);
        yp += __shfl_xor_sync(0xffffffffu, yp, off);
      }
      float vB = g * dtv * uv, vC = hv * dyv;
      for (int off = N; off < 32; off <<= 1) {  // sums over the warp's channels
        vB += __shfl_xor_sync(0xffffffffu, vB, off);
        vC += __shfl_xor_sync(0xffffffffu, vC, off);
      }
      if (lane < N) {  // lane == n for live lanes; a dead lane here adds 0
        atomicAdd(&dB_s[lane * T + t], vB);
        atomicAdd(&dC_s[lane * T + t], vC);
      }
      dA_acc += gah * dtv;
      carry = expf(dtv * a_dn) * g;
      // every lane of the group read dt, dy [d][t] before the shuffles
      if (live && n == 0) {
        dD_acc += dyv * uv;
        du_s[d * T + t] = dtv * gB + dyv * Dd;
        dt_s[d * T + t] = (pA + uv * gB) * (-expm1f(-dtv));  // sigmoid(dt_raw)
        dy_s[d * T + t] = yp + Dd * uv;                      // y_pre
      }
    }
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
    const int d = i / T, gt = t0 + (i - d * T);
    if (gt < L) {
      const float zv = mmu::to_f32(z[(size_t)d * L + gt]);
      const float sz = 1.f / (1.f + expf(-zv));
      const float dz =
          mmu::to_f32(dout[(size_t)d * L + gt]) * dy_s[i] * (sz + zv * sz * (1.f - sz));
      dxz[(size_t)(D + d) * L + gt] = mmu::from_f32<TI>(dz);
    }
  }
  // dt_proj weight and bias partials (the weight's product takes the rounded ddt_raw)
  for (int i = threadIdx.x; i < D * (R + 1); i += blockDim.x) {
    const int d = i / (R + 1), r = i - d * (R + 1);
    float acc = 0.f;
    if (r < R) {
      for (int t = 0; t < T; ++t) acc += mmu::round_to<TI>(dt_s[d * T + t]) * xd_s[r * T + t];
      a.p_ddtw[(blk * D + d) * R + r] = acc;
    } else {
      for (int t = 0; t < T; ++t) acc += dt_s[d * T + t];
      a.p_ddtb[blk * D + d] = acc;
    }
  }
  __syncthreads();  // y_pre is read; its rows take dx_dbl's dt rows
  // dx_dbl = [dt_w^T ddt_raw; dB; dC], rounded to the stream dtype
  float* dxd = dy_s;  // rows [0, R) here, rows [R, E) are dB_s, dC_s
  for (int i = threadIdx.x; i < R * T; i += blockDim.x) {
    const int r = i / T, t = i - r * T;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += w.dtw[d * R + r] * mmu::round_to<TI>(dt_s[d * T + t]);
    dxd[i] = mmu::round_to<TI>(acc);
  }
  for (int i = threadIdx.x; i < 2 * N * T; i += blockDim.x) dB_s[i] = mmu::round_to<TI>(dB_s[i]);
  __syncthreads();
  // x_proj partial: dx_dbl @ u^T
  for (int i = threadIdx.x; i < E * D; i += blockDim.x) {
    const int e = i / D, d = i - e * D;
    const float* row = e < R ? dxd + e * T : dB_s + (e - R) * T;
    float acc = 0.f;
    for (int t = 0; t < T; ++t) acc += row[t] * u_s[d * T + t];
    a.p_dxp[(blk * E + e) * D + d] = acc;
  }
  // dpre = (x_proj^T dx_dbl + du) * silu'(pre), in token order
  const int W = a.W;
  for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
    const int d = i / T, t = i - d * T, gt = t0 + t;
    if (gt >= L) continue;
    float acc = du_s[i];
    for (int e = 0; e < E; ++e) {
      const float* row = e < R ? dxd + e * T : dB_s + (e - R) * T;
      acc += w.xp[(size_t)e * D + d] * row[t];
    }
    const float pre = mmu::conv_pre(x + (size_t)d * L, w.cw + d * W, w.cb[d], gt, L, W, a.reverse);
    const float sp = 1.f / (1.f + expf(-pre));
    a.dpre[((size_t)bg * D + d) * L + gt] = acc * sp * (1.f + pre * (1.f - sp));
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
    mamba_bwd_combine_kernel<<<(unsigned)((chains + 255) / 256), 256, 0, stream>>>(a);
  }
  err = cudaFuncSetAttribute(mamba_bwd_chunk_kernel<TI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_chunk);
  if (err != cudaSuccess) return err;
  mamba_bwd_chunk_kernel<TI><<<grid, threads, smem_chunk, stream>>>(a);
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
  if (T > kMaxT || W > kMaxW || N > 32 || (N & (N - 1)) || R > D || conv_tile < 1)
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
  const size_t smem_local = (size_t)(3 * D + E) * T * sizeof(float);
  const size_t smem_chunk = (size_t)(4 * D + E + 2 * N) * T * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, threads, smem_local, smem_chunk, st)
                 : launch<float>(a, threads, smem_local, smem_chunk, st);
}
