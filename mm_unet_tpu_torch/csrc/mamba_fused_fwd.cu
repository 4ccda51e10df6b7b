// Fused Mamba-inner forward for Hopper: causal depthwise conv + SiLU,
// x_proj, dt_proj + softplus, the selective scan and the silu(z) gate in one
// pass over the packed in_proj output xz.
//
// Replaces the TPU kernel mm_unet_tpu/ops/mamba_fused.py::_mega_fwd_kernel
// (launched by _mega_core._fwd_call). Same semantics: rows [0, D) of xz are
// the conv/scan stream, rows [D, 2D) the gate; `reverse` scans right-to-left
// with an anti-causal conv, with no flipped copies. Streams are f32 or bf16
// with f32 arithmetic and state; under bf16 the conv output, the dt rows of
// x_dbl and the gated output are rounded where the TPU kernel rounds them.
// The conv output, x_dbl, dt, B and C live only in shared memory.
//
// What bounds it on the H100: the scan is a chain of dependent
// exp/multiply-adds per (b, channel, state) along L, and MM_Net's MMConv
// scans have only D = 6 or 2 channels (D * N = 96 or 32 recurrences per
// image) over up to 65,536 tokens, far too few chains to fill 132 SMs if each
// walked the whole sequence. The design cuts L into chunks of T tokens, one
// block per (batch, chunk):
//   1. each block scans its chunk from a zero state and keeps the end state
//      and the chunk's sum of dt (its decay is exp(A * sum dt));
//   2. a small kernel combines the chunks in scan order per (b, d, n),
//      turning end states into true entry states in place;
//   3. each block rescans its chunk from its entry state and writes y.
// Passes 1 and 3 both recompute conv, x_proj and dt from xz (cheap next to
// the scan) instead of writing them to device memory. Inside a block one
// thread owns one (channel, state) pair; the C-contraction over the N states
// is a shuffle reduction inside an N-lane group.
#include <cstdint>

#include "common.cuh"
#include "mamba_chunk.cuh"

namespace {

struct MambaArgs {
  const void* xz;       // (B, G, 2D, L) stream dtype
  void* out;            // (B, G, D, L) stream dtype
  const float* conv_w;  // (G, D, W), rounded to the stream dtype
  const float* conv_b;  // (G, D)
  const float* x_proj;  // (G, R + 2N, D), rounded to the stream dtype
  const float* dt_w;    // (G, D, R), rounded to the stream dtype
  const float* dt_b;    // (G, D)
  const float* A;       // (G, D, N), negative
  const float* Dskip;   // (G, D)
  float* state;         // (B, G, nC, D, N): chunk end states, then entry states
                        // (kept for the backward kernel)
  float* dtsum;         // (B, G, nC, D)
  int B, G, D, L, N, R, W, T, nC;
  bool reverse;
};

// FINAL = false: pass 1 (zero entry state; emit end state and sum of dt).
// FINAL = true: pass 3 (entry state from the combine; emit the gated y).
template <typename TI, bool FINAL>
__global__ void mamba_chunk_kernel(MambaArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, N = a.N, R = a.R, W = a.W, L = a.L;
  const int E = R + 2 * N;
  float* u_s = smem;          // [D][T] conv + silu output
  float* dt_s = u_s + D * T;  // [D][T] dt; pass 3 overwrites it with y
  float* xd_s = dt_s + D * T; // [E][T] x_dbl: dt rows, then B, then C

  const int c = blockIdx.x;   // chunk, in token order
  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % a.G;
  const int t0 = c * T;
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L;
  const float* cw = a.conv_w + (size_t)g * D * W;
  const float* cb = a.conv_b + (size_t)g * D;
  const float* xp = a.x_proj + (size_t)g * E * D;
  const float* dtw = a.dt_w + (size_t)g * D * R;
  const float* dtb = a.dt_b + (size_t)g * D;
  const float* Ad = a.A + (size_t)g * D * N;
  const float* Dv = a.Dskip + (size_t)g * D;

  // 1.-3. conv + SiLU, x_dbl = x_proj @ u (dt rows rounded to the stream
  //        dtype), dt = softplus(dt_proj @ x_dbl[:R] + dt_b); 0 past L
  mmu::recompute_chunk<TI>(x, D, L, T, t0, R, N, W, a.reverse, cw, cb, xp, dtw, dtb, u_s, dt_s,
                           xd_s);

  // 4. the scan: one thread per (d, n); N-lane groups share a channel
  const float* Bs = xd_s + R * T;
  const float* Cs = Bs + N * T;
  const int lane = threadIdx.x & 31;
  const unsigned gmask = (N == 32) ? 0xffffffffu : (((1u << N) - 1u) << (lane & ~(N - 1)));
  const size_t sbase = (size_t)bg * a.nC + c;
  for (int p0 = 0; p0 < D * N; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    if (p >= D * N) continue;  // whole N-lane groups drop out together
    const int d = p / N, n = p - d * N;
    const float a_dn = Ad[d * N + n];
    float h = 0.f, sum_dt = 0.f;
    if (FINAL && a.nC > 1) h = a.state[sbase * D * N + p];
    // one chunk: no pass 1 and no combine; its entry state, which the
    // backward reads, is zero
    if (FINAL && a.nC == 1) a.state[sbase * D * N + p] = 0.f;
    for (int s = 0; s < T; ++s) {
      const int t = a.reverse ? T - 1 - s : s;
      const float dtv = dt_s[d * T + t];
      const float uv = u_s[d * T + t];
      h = expf(dtv * a_dn) * h + dtv * uv * Bs[n * T + t];
      if (FINAL) {
        float yp = h * Cs[n * T + t];
        for (int off = N / 2; off > 0; off >>= 1) yp += __shfl_xor_sync(gmask, yp, off);
        // every lane of the group has read dt[d][t] before the shuffle
        if (n == 0) dt_s[d * T + t] = yp + Dv[d] * uv;
      } else {
        sum_dt += dtv;
      }
    }
    if (!FINAL) {
      a.state[sbase * D * N + p] = h;
      if (n == 0) a.dtsum[sbase * D + d] = sum_dt;
    }
  }

  if (FINAL) {
    __syncthreads();
    // 5. gate with silu(z) and write in the stream dtype, coalesced along L
    const TI* z = x + (size_t)D * L;
    TI* out = static_cast<TI*>(a.out) + (size_t)bg * D * L;
    for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
      const int d = i / T, t = i - d * T, gt = t0 + t;
      if (gt < L) {
        const float zv = mmu::to_f32(z[(size_t)d * L + gt]);
        out[(size_t)d * L + gt] = mmu::from_f32<TI>(dt_s[i] * mmu::silu(zv));
      }
    }
  }
}

// Pass 2: for each (b, g, d, n), walk the chunks in scan order and replace
// each chunk's zero-entry end state by its true entry state.
__global__ void mamba_combine_kernel(MambaArgs a) {
  const int D = a.D, N = a.N, nC = a.nC;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.B * a.G * D * N) return;
  const int n = i % N, d = (i / N) % D;
  const int64_t bg = i / ((int64_t)D * N);
  const float a_dn = a.A[((size_t)(bg % a.G) * D + d) * N + n];
  float carry = 0.f;
  for (int s = 0; s < nC; ++s) {
    const int c = a.reverse ? nC - 1 - s : s;
    const size_t sc = (size_t)bg * nC + c;
    const float h_end = a.state[(sc * D + d) * N + n];
    const float decay = expf(a_dn * a.dtsum[sc * D + d]);
    a.state[(sc * D + d) * N + n] = carry;
    carry = decay * carry + h_end;
  }
}

template <typename TI>
int launch(const MambaArgs& a, int threads, size_t smem, cudaStream_t stream) {
  const dim3 grid(a.nC, a.B * a.G);
  cudaError_t err;
  if (a.nC > 1) {
    err = cudaFuncSetAttribute(mamba_chunk_kernel<TI, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    mamba_chunk_kernel<TI, false><<<grid, threads, smem, stream>>>(a);
    const int64_t chains = (int64_t)a.B * a.G * a.D * a.N;
    mamba_combine_kernel<<<(unsigned)((chains + 255) / 256), 256, 0, stream>>>(a);
  }
  err = cudaFuncSetAttribute(mamba_chunk_kernel<TI, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mamba_chunk_kernel<TI, true><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mamba_fused_fwd(const void* xz, void* out, const void* conv_w,
                               const void* conv_b, const void* x_proj, const void* dt_w,
                               const void* dt_b, const void* A, const void* Dskip,
                               void* state, void* dtsum, int B, int G, int D, int L, int N,
                               int R, int W, int T, int reverse, int is_bf16, void* stream) {
  MambaArgs a;
  a.xz = xz;
  a.out = out;
  a.conv_w = static_cast<const float*>(conv_w);
  a.conv_b = static_cast<const float*>(conv_b);
  a.x_proj = static_cast<const float*>(x_proj);
  a.dt_w = static_cast<const float*>(dt_w);
  a.dt_b = static_cast<const float*>(dt_b);
  a.A = static_cast<const float*>(A);
  a.Dskip = static_cast<const float*>(Dskip);
  a.state = static_cast<float*>(state);
  a.dtsum = static_cast<float*>(dtsum);
  a.B = B; a.G = G; a.D = D; a.L = L; a.N = N; a.R = R; a.W = W; a.T = T;
  a.nC = (L + T - 1) / T;
  a.reverse = reverse != 0;
  // one thread per (channel, state) pair, in whole warps, at most 512
  const int pairs = D * N;
  const int threads = pairs >= 512 ? 512 : ((pairs + 31) / 32) * 32;
  const size_t smem = (size_t)(2 * D + R + 2 * N) * T * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, threads, smem, st) : launch<float>(a, threads, smem, st);
}

extern "C" const char* mmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
