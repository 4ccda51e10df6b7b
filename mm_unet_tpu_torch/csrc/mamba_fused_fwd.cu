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
// The design cuts L into chunks of T tokens, one block per (batch, chunk),
// since MM_Net's MMConv scans have only D = 6 or 2 channels (D * N = 96 or
// 32 chains per image) over up to 65,536 tokens, far too few to fill 132 SMs
// if each walked the whole sequence:
//   1. each block scans its chunk from a zero state and keeps the end state
//      and the chunk's sum of dt (its decay is exp(A * sum dt));
//   2. a small kernel combines the chunks in scan order per (b, d, n),
//      turning end states into true entry states in place;
//   3. each block rescans its chunk from its entry state and writes y.
// Passes 1 and 3 both recompute conv, x_proj and dt from xz (cheap next to
// the scan) instead of writing them to device memory. One thread walks one
// (channel d, state n) chain; N-lane groups share a channel.
//
// What bounds it on the H100: not device memory (xz in, y out) but the
// shared-memory traffic of the scans, issued through the SM's one memory
// pipe, and the latency of their dependent exp and multiply-add chains. Per
// token a lane reads dt, u and B (pass 3 also C), and pass 3 sums h C over
// the N lanes of its channel. The design cuts that traffic three ways:
//   - rows of T + 1 floats: the N lanes of a channel reading B or C at one
//     token hit N distinct banks, as do neighbouring channels reading dt or
//     u (rows of T floats put them in one bank: N-way conflicts on every
//     token of both passes), and x_proj @ u is tiled over registers;
//   - the sum over the states by a scattering butterfly: pass 3 walks its
//     chunk in sub-chunks of kS tokens, each lane keeping h C at the
//     sub-chunk's tokens in registers; one butterfly sums them over the
//     group and leaves each lane the sums of its own tokens (kS - 1 shuffles
//     where a sum per token takes kS log2 N), and those lanes write
//     y_pre + D u for them. Pass 3 is templated on N;
//   - the combine issues the loads of kAhead chunks together, so a chain
//     waits on memory once per kAhead chunks (D = 6 at L = 65,536 walks 512).
// At MM_Net's widest scan (D = 128, R = 4, N = 16, T = 64) a block takes
// 512 threads and 76 KB of shared memory, and two fit on an SM.
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
// N, the state count, is a compile-time constant of pass 3's sums.
template <typename TI, bool FINAL, int N>
__global__ void __launch_bounds__(512, 2) mamba_chunk_kernel(MambaArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, R = a.R, W = a.W, L = a.L;
  const int ld = T + 1;         // rows of T + 1 floats
  float* u_s = smem;            // [D] rows: conv + silu output
  float* dt_s = u_s + D * ld;   // [D] dt; pass 3 overwrites it with y_pre + D u
  float* xd_s = dt_s + D * ld;  // [R + 2N] x_dbl: dt rows, then B, then C

  const int c = blockIdx.x;   // chunk, in token order
  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % a.G;
  const int t0 = c * T;
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L;
  const float* cw = a.conv_w + (size_t)g * D * W;
  const float* cb = a.conv_b + (size_t)g * D;
  const float* xp = a.x_proj + (size_t)g * (R + 2 * N) * D;
  const float* dtw = a.dt_w + (size_t)g * D * R;
  const float* dtb = a.dt_b + (size_t)g * D;
  const float* Ad = a.A + (size_t)g * D * N;
  const float* Dv = a.Dskip + (size_t)g * D;

  // 1.-3. conv + SiLU, x_dbl = x_proj @ u (dt rows rounded to the stream
  //        dtype), dt = softplus(dt_proj @ x_dbl[:R] + dt_b); 0 past L
  mmu::recompute_chunk<TI>(x, D, L, T, t0, R, N, W, a.reverse, cw, cb, xp, dtw, dtb, u_s, dt_s,
                           xd_s);

  // 4. the scan: one thread per (d, n); N-lane groups share a channel
  const float* Bs = xd_s + R * ld;
  const float* Cs = Bs + N * ld;
  constexpr int kS = mmu::kS;
  constexpr int kNe = N < kS ? N : kS;  // lanes of a group that end with distinct sums
  constexpr int kRep = N / kNe;         // lanes that hold each of them
  const int lane = threadIdx.x & 31, nsub = T / kS;
  const size_t sbase = (size_t)bg * a.nC + c;
  // every lane of a warp runs every walk (lanes past D * N with zero
  // inputs), so pass 3's shuffles always see the full warp
  for (int p0 = 0; p0 < D * N; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < D * N;
    const int pp = live ? p : 0;
    const int d = pp / N, n = pp - d * N;
    float* dt_d = dt_s + d * ld;
    const float* u_d = u_s + d * ld;
    const float a_dn = Ad[pp];
    if constexpr (!FINAL) {
      if (!live) continue;  // no shuffles in pass 1
      float h = 0.f, sum_dt = 0.f;
      for (int s = 0; s < T; ++s) {
        const int t = a.reverse ? T - 1 - s : s;
        const float dtv = dt_d[t];
        h = expf(dtv * a_dn) * h + dtv * u_d[t] * Bs[n * ld + t];
        sum_dt += dtv;
      }
      a.state[sbase * D * N + p] = h;
      if (n == 0) a.dtsum[sbase * D + d] = sum_dt;
    } else {
      float h = (live && a.nC > 1) ? a.state[sbase * D * N + p] : 0.f;
      // one chunk: no pass 1 and no combine; its entry state, which the
      // backward reads, is zero
      if (live && a.nC == 1) a.state[sbase * D * N + p] = 0.f;
      const float Dd = Dv[d];
      for (int k = 0; k < nsub; ++k) {
        float v[kS];  // this lane's h C at the sub-chunk's tokens
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const int s = k * kS + j, t = a.reverse ? T - 1 - s : s;
          const float dtv = live ? dt_d[t] : 0.f, uv = live ? u_d[t] : 0.f;
          h = expf(dtv * a_dn) * h + dtv * uv * Bs[n * ld + t];
          v[j] = h * Cs[n * ld + t];
        }
        // only the N lanes of channel d read dt[d], and each has read the
        // sub-chunk's tokens of it above: after the butterfly, the owner of
        // each token's sum overwrites that token's dt with y_pre + D u
        mmu::group_sum_scatter<N>(v, lane);
        if (live && n % kRep == 0) {
#pragma unroll
          for (int i = 0; i < kS / kNe; ++i) {
            const int s = k * kS + n / kRep * (kS / kNe) + i, t = a.reverse ? T - 1 - s : s;
            dt_d[t] = v[i] + Dd * u_d[t];
          }
        }
      }
    }
  }

  if constexpr (FINAL) {
    __syncthreads();
    // 5. gate with silu(z) and write in the stream dtype, coalesced along L
    const TI* z = x + (size_t)D * L;
    TI* out = static_cast<TI*>(a.out) + (size_t)bg * D * L;
    for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
      const int d = i / T, t = i - d * T, gt = t0 + t;
      if (gt < L) {
        const float zv = mmu::to_f32(z[(size_t)d * L + gt]);
        out[(size_t)d * L + gt] = mmu::from_f32<TI>(dt_s[d * ld + t] * mmu::silu(zv));
      }
    }
  }
}

// Pass 2: for each (b, g, d, n), walk the chunks in scan order and replace
// each chunk's zero-entry end state by its true entry state. The walk is one
// dependent chain with a load per chunk: the loads of kAhead chunks are
// issued together, so a chain waits on memory once per kAhead chunks.
__global__ void __launch_bounds__(128) mamba_combine_kernel(MambaArgs a) {
  constexpr int kAhead = mmu::kAhead;
  const int D = a.D, N = a.N, nC = a.nC;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.B * a.G * D * N) return;
  const int n = i % N, d = (i / N) % D;
  const int64_t bg = i / ((int64_t)D * N);
  const float a_dn = a.A[((size_t)(bg % a.G) * D + d) * N + n];
  float carry = 0.f;
  for (int s0 = 0; s0 < nC; s0 += kAhead) {
    float h_end[kAhead], dts[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j, c = a.reverse ? nC - 1 - s : s;
      const size_t sc = (size_t)bg * nC + c;
      h_end[j] = s < nC ? a.state[(sc * D + d) * N + n] : 0.f;
      dts[j] = s < nC ? a.dtsum[sc * D + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j, c = a.reverse ? nC - 1 - s : s;
      if (s < nC) {
        a.state[(((size_t)bg * nC + c) * D + d) * N + n] = carry;
        carry = expf(a_dn * dts[j]) * carry + h_end[j];
      }
    }
  }
}

// one thread per (channel, state) pair, in whole warps, at most 512; the
// f32 rows of the chunk in shared memory
int threads_for(int D, int N) {
  const int pairs = D * N;
  return pairs >= 512 ? 512 : ((pairs + 31) / 32) * 32;
}
size_t smem_for(int D, int R, int N, int T) {
  return (size_t)(2 * D + R + 2 * N) * (T + 1) * sizeof(float);
}

// passes 1-3 for the state count N; with `occupancy` set, the resident
// blocks per SM of pass 1 and pass 3 instead of a launch
template <typename TI, int N>
int run(const MambaArgs& a, cudaStream_t stream, int* occupancy) {
  const auto pass1 = mamba_chunk_kernel<TI, false, N>;
  const auto pass3 = mamba_chunk_kernel<TI, true, N>;
  const int threads = threads_for(a.D, N);
  const size_t smem = smem_for(a.D, a.R, N, a.T);
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(pass1, attr, (int)smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(pass3, attr, (int)smem);
  if (err != cudaSuccess) return err;
  if (occupancy) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], pass1, threads, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[1], pass3, threads, smem);
    return err;
  }
  const dim3 grid(a.nC, a.B * a.G);
  if (a.nC > 1) {
    mamba_chunk_kernel<TI, false, N><<<grid, threads, smem, stream>>>(a);
    const int64_t chains = (int64_t)a.B * a.G * a.D * N;
    mamba_combine_kernel<<<(unsigned)((chains + 127) / 128), 128, 0, stream>>>(a);
  }
  mamba_chunk_kernel<TI, true, N><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TI>
int dispatch(const MambaArgs& a, cudaStream_t stream, int* occupancy) {
  switch (a.N) {
    case 1: return run<TI, 1>(a, stream, occupancy);
    case 2: return run<TI, 2>(a, stream, occupancy);
    case 4: return run<TI, 4>(a, stream, occupancy);
    case 8: return run<TI, 8>(a, stream, occupancy);
    case 16: return run<TI, 16>(a, stream, occupancy);
    default: return run<TI, 32>(a, stream, occupancy);
  }
}

bool valid(int N, int T) { return T % mmu::kS == 0 && N >= 1 && N <= 32 && !(N & (N - 1)); }

}  // namespace

extern "C" int mamba_fused_fwd(const void* xz, void* out, const void* conv_w,
                               const void* conv_b, const void* x_proj, const void* dt_w,
                               const void* dt_b, const void* A, const void* Dskip,
                               void* state, void* dtsum, int B, int G, int D, int L, int N,
                               int R, int W, int T, int reverse, int is_bf16, void* stream) {
  if (!valid(N, T)) return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, st, nullptr) : dispatch<float>(a, st, nullptr);
}

// resident blocks per SM of pass 1 and pass 3 (out[0], out[1]) at the launch
// mamba_fused_fwd makes for these sizes
extern "C" int mamba_fused_fwd_blocks_per_sm(int D, int R, int N, int T, int is_bf16, int* out) {
  if (!valid(N, T)) return cudaErrorInvalidValue;
  MambaArgs a = {};
  a.D = D; a.R = R; a.N = N; a.T = T;
  return is_bf16 ? dispatch<__nv_bfloat16>(a, nullptr, out) : dispatch<float>(a, nullptr, out);
}

extern "C" const char* mmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
