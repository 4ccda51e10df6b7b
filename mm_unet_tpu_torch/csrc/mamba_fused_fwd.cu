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
// A block keeps its chunk's D channels whole in shared memory, (2 D + E)
// (T + 1) floats, where that fits the card's opt-in (up to D 1,669 at E 80
// and T 16: mamba-130m's D 1536). Past it (mamba-370m's D 2048 and wider)
// the chunk's channels split over nb blocks of Dc (ops/mamba_fused.py::
// _fwd_plan, `plan_of` here), one block per (batch, chunk, channel block),
// behind an x_dbl pass:
//   X. one block per (batch, chunk) computes x_dbl = x_proj u, the one sum
//      over channels the chains need before they start, into an f32 (B, G,
//      E, L) scratch, streaming the channels Dc at a time
//      (`mmu::xdbl_chunk`, kernel 2's pass X, in the same summation order:
//      the same bits as a whole-chunk block's x_dbl);
//   1., 3. each block reads the chunk's E x_dbl rows, recomputes the conv
//      and dt of its own channels and scans, gates and writes them; every
//      other term is per channel, so a split launch gives the bits of a
//      whole one. The state and dtsum layouts stay those of kernel 2's reads.
// The chunk passes are one template over their arguments: the whole-chunk
// instance takes the bare MambaArgs and is the code of the launch before
// the split, the split one SplitArgs.
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
// 512 threads and 76 KB of shared memory, and two fit on an SM; at mamba-
// 370m's D 2048 (E 96, T 16: 8 blocks of 256 channels) 41 KB.
#include <cstdint>
#include <type_traits>

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

// A split launch's arguments: pass X's scratch and the channel blocks. The
// whole-chunk kernels and the combine take the bare MambaArgs: with these
// fields in their arguments (144 bytes, not 128) all three passes of the
// whole-chunk launch ran up to 23% slower on the H100 at MM_Net's and
// dkDualNet's widths (`chip_ab.py fwd`), with the same code and bits.
struct SplitArgs : MambaArgs {
  float* xdbl;  // (B, G, R + 2N, L) x_dbl from pass X
  int Dc, nb;   // channels per block of passes 1 and 3, and blocks per chunk
};

// FINAL = false: pass 1 (zero entry state; emit end state and sum of dt).
// FINAL = true: pass 3 (entry state from the combine; emit the gated y).
// N, the state count, is a compile-time constant of pass 3's sums. With
// SplitArgs the chunk's channels span a.nb blocks of a.Dc behind pass X;
// with MambaArgs one block holds the whole chunk and recomputes x_dbl
// itself, the code of the launch before the split (its offsets fold to 0).
template <typename TI, bool FINAL, int N, typename Args>
__global__ void __launch_bounds__(512, 2) mamba_chunk_kernel(Args a) {
  constexpr bool SPLIT = std::is_same_v<Args, SplitArgs>;
  extern __shared__ float smem[];
  int Dc = a.D, k = 0, c = blockIdx.x;  // channels a block, channel block, chunk
  if constexpr (SPLIT) {
    Dc = a.Dc;
    k = blockIdx.x % a.nb;
    c = blockIdx.x / a.nb;
  }
  const int D = a.D, T = a.T, R = a.R, W = a.W, L = a.L;
  const int ld = T + 1;          // rows of T + 1 floats
  float* u_s = smem;             // [Dc] rows: conv + silu output
  float* dt_s = u_s + Dc * ld;   // [Dc] dt; pass 3 overwrites it with y_pre + D u
  float* xd_s = dt_s + Dc * ld;  // [R + 2N] x_dbl: dt rows, then B, then C

  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % a.G;
  const int t0 = c * T, d0 = k * Dc, nd = min(Dc, D - d0);
  const TI* x = static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L;
  const float* cw = a.conv_w + (size_t)g * D * W;
  const float* cb = a.conv_b + (size_t)g * D;
  const float* xp = a.x_proj + (size_t)g * (R + 2 * N) * D;
  const float* dtw = a.dt_w + (size_t)g * D * R;
  const float* dtb = a.dt_b + (size_t)g * D;
  const float* Ad = a.A + ((size_t)g * D + d0) * N;
  const float* Dv = a.Dskip + (size_t)g * D + d0;

  // 1.-3. conv + SiLU, x_dbl = x_proj @ u (dt rows rounded to the stream
  //        dtype), dt = softplus(dt_proj @ x_dbl[:R] + dt_b); 0 past L; the
  //        block's channels, x_dbl from pass X where the chunk is split
  if constexpr (SPLIT) {
    mmu::split_inputs<TI>(x, a.xdbl + (size_t)bg * (R + 2 * N) * L, d0, nd, L, T, t0, R, N, W,
                          a.reverse, cw, cb, dtw, dtb, u_s, dt_s, xd_s);
  } else {
    mmu::recompute_chunk<TI>(x, D, L, T, t0, R, N, W, a.reverse, cw, cb, xp, dtw, dtb, u_s, dt_s,
                             xd_s);
  }

  // 4. the scan: one thread per (d, n) of the block's channels; N-lane
  //    groups share a channel
  const float* Bs = xd_s + R * ld;
  const float* Cs = Bs + N * ld;
  constexpr int kS = mmu::kS;
  constexpr int kNe = N < kS ? N : kS;  // lanes of a group that end with distinct sums
  constexpr int kRep = N / kNe;         // lanes that hold each of them
  const int lane = threadIdx.x & 31, nsub = T / kS;
  const size_t sbase = (size_t)bg * a.nC + c;
  float* st = a.state + sbase * D * N + (size_t)d0 * N;  // the block's (d, n) chains
  // every lane of a warp runs every walk (lanes past nd * N with zero
  // inputs), so pass 3's shuffles always see the full warp
  for (int p0 = 0; p0 < nd * N; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < nd * N;
    const int pp = live ? p : 0;
    const int dl = pp / N, n = pp - dl * N;
    float* dt_d = dt_s + dl * ld;
    const float* u_d = u_s + dl * ld;
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
      st[p] = h;
      if (n == 0) a.dtsum[sbase * D + d0 + dl] = sum_dt;
    } else {
      float h = (live && a.nC > 1) ? st[p] : 0.f;
      // one chunk: no pass 1 and no combine; its entry state, which the
      // backward reads, is zero
      if (live && a.nC == 1) st[p] = 0.f;
      const float Dd = Dv[dl];
      for (int kk = 0; kk < nsub; ++kk) {
        float v[kS];  // this lane's h C at the sub-chunk's tokens
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const int s = kk * kS + j, t = a.reverse ? T - 1 - s : s;
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
            const int s = kk * kS + n / kRep * (kS / kNe) + i, t = a.reverse ? T - 1 - s : s;
            dt_d[t] = v[i] + Dd * u_d[t];
          }
        }
      }
    }
  }

  if constexpr (FINAL) {
    __syncthreads();
    // 5. gate with silu(z) and write in the stream dtype, coalesced along L
    const TI* z = x + (size_t)(D + d0) * L;
    TI* out = static_cast<TI*>(a.out) + ((size_t)bg * D + d0) * L;
    for (int i = threadIdx.x; i < nd * T; i += blockDim.x) {
      const int dl = i / T, t = i - dl * T, gt = t0 + t;
      if (gt < L) {
        const float zv = mmu::to_f32(z[(size_t)dl * L + gt]);
        out[(size_t)dl * L + gt] = mmu::from_f32<TI>(dt_s[dl * ld + t] * mmu::silu(zv));
      }
    }
  }
}

// Pass X (nb > 1, `mmu::xdbl_chunk`): x_dbl of one chunk over all D channels,
// Dc at a time, into the scratch that passes 1 and 3 read.
template <typename TI>
__global__ void __launch_bounds__(mmu::kXdblThreads) mamba_fwd_xdbl_kernel(SplitArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, T = a.T, L = a.L, E = a.R + 2 * a.N, Dc = a.Dc;
  const int c = blockIdx.x, bg = blockIdx.y, g = bg % a.G;
  float* u_s = smem;                 // [Dc] rows: the slice's conv output
  float* xd_s = u_s + Dc * (T + 1);  // [E] x_dbl sums
  mmu::xdbl_chunk<TI>(static_cast<const TI*>(a.xz) + (size_t)bg * 2 * D * L, D, L, T, c * T,
                      a.R, E, a.W, Dc, a.reverse, a.conv_w + (size_t)g * D * a.W,
                      a.conv_b + (size_t)g * D, a.x_proj + (size_t)g * E * D, u_s, xd_s,
                      a.xdbl + (size_t)bg * E * L);
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

// the launch of the chunk passes at these sizes, as ops/mamba_fused.py::
// _fwd_plan computes it: nb blocks of Dc channels a chunk, one thread per
// (channel, state) pair of a block, in whole warps, at most 512; the f32
// rows of a block's chunk in shared memory, and pass X's (nb > 1): a slice
// of Dc conv outputs and the E x_dbl rows
struct Plan {
  int nb, threads;
  size_t smem, smem_x;
};

Plan plan_of(int D, int R, int N, int T, int Dc) {
  Plan p;
  p.nb = (D + Dc - 1) / Dc;
  const int pairs = Dc * N;
  p.threads = pairs >= 512 ? 512 : ((pairs + 31) / 32) * 32;
  const size_t E = R + 2 * N, ld = T + 1, f = sizeof(float);
  p.smem = (2 * (size_t)Dc + E) * ld * f;
  p.smem_x = ((size_t)Dc + E) * ld * f;
  return p;
}

// passes 1 and 2 (more than one chunk) and 3 for the state count N, with
// the bare MambaArgs (one block a chunk) or SplitArgs; with `occupancy`
// set, the resident blocks per SM of pass 1 and pass 3 instead of a launch
template <typename TI, int N, typename Args>
cudaError_t chunk_passes(const Args& a, const Plan& p, cudaStream_t stream, int* occupancy) {
  const auto pass1 = mamba_chunk_kernel<TI, false, N, Args>;
  const auto pass3 = mamba_chunk_kernel<TI, true, N, Args>;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(pass1, attr, (int)p.smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(pass3, attr, (int)p.smem);
  if (err != cudaSuccess) return err;
  if (occupancy) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], pass1, p.threads, p.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[1], pass3, p.threads, p.smem);
    return err;
  }
  const dim3 grid(p.nb * a.nC, a.B * a.G);
  if (a.nC > 1) {
    pass1<<<grid, p.threads, p.smem, stream>>>(a);
    const int64_t chains = (int64_t)a.B * a.G * a.D * N;
    mamba_combine_kernel<<<(unsigned)((chains + 127) / 128), 128, 0, stream>>>(
        static_cast<const MambaArgs&>(a));
  }
  pass3<<<grid, p.threads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

// pass X (nb > 1), then the chunk passes; with `occupancy` set, the
// resident blocks per SM of pass 1, pass 3 and pass X (0 for nb = 1)
template <typename TI, int N>
int run(const SplitArgs& a, cudaStream_t stream, int* occupancy) {
  const Plan p = plan_of(a.D, a.R, N, a.T, a.Dc);
  if (a.nb == 1) {
    if (occupancy) occupancy[2] = 0;
    return chunk_passes<TI, N>(static_cast<const MambaArgs&>(a), p, stream, occupancy);
  }
  const auto passx = mamba_fwd_xdbl_kernel<TI>;
  cudaError_t err = cudaFuncSetAttribute(passx, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem_x);
  if (err != cudaSuccess) return err;
  if (occupancy) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[2], passx, mmu::kXdblThreads,
                                                        p.smem_x);
    return err == cudaSuccess ? chunk_passes<TI, N>(a, p, stream, occupancy) : err;
  }
  passx<<<dim3(a.nC, a.B * a.G), mmu::kXdblThreads, p.smem_x, stream>>>(a);
  return chunk_passes<TI, N>(a, p, stream, occupancy);
}

template <typename TI>
int dispatch(const SplitArgs& a, cudaStream_t stream, int* occupancy) {
  switch (a.N) {
    case 1: return run<TI, 1>(a, stream, occupancy);
    case 2: return run<TI, 2>(a, stream, occupancy);
    case 4: return run<TI, 4>(a, stream, occupancy);
    case 8: return run<TI, 8>(a, stream, occupancy);
    case 16: return run<TI, 16>(a, stream, occupancy);
    default: return run<TI, 32>(a, stream, occupancy);
  }
}

bool valid(int N, int T, int Dc) {
  return T % mmu::kS == 0 && N >= 1 && N <= 32 && !(N & (N - 1)) && Dc >= 1;
}

}  // namespace

extern "C" int mamba_fused_fwd(const void* xz, void* out, const void* conv_w,
                               const void* conv_b, const void* x_proj, const void* dt_w,
                               const void* dt_b, const void* A, const void* Dskip,
                               void* state, void* dtsum, void* xdbl, int B, int G, int D, int L,
                               int N, int R, int W, int T, int Dc, int reverse, int is_bf16,
                               void* stream) {
  if (!valid(N, T, Dc) || (Dc < D && xdbl == nullptr)) return cudaErrorInvalidValue;
  SplitArgs a;
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
  a.xdbl = static_cast<float*>(xdbl);
  a.B = B; a.G = G; a.D = D; a.L = L; a.N = N; a.R = R; a.W = W; a.T = T;
  a.nC = (L + T - 1) / T;
  a.Dc = Dc < D ? Dc : D;
  a.nb = (D + a.Dc - 1) / a.Dc;
  a.reverse = reverse != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, st, nullptr) : dispatch<float>(a, st, nullptr);
}

// resident blocks per SM of pass 1, pass 3 and pass X (out[0..2]; 0 for one
// block a chunk) at the launch mamba_fused_fwd makes for these sizes
extern "C" int mamba_fused_fwd_blocks_per_sm(int D, int R, int N, int T, int Dc, int is_bf16,
                                             int* out) {
  if (!valid(N, T, Dc)) return cudaErrorInvalidValue;
  SplitArgs a = {};
  a.D = D; a.R = R; a.N = N; a.T = T;
  a.Dc = Dc < D ? Dc : D;
  a.nb = (D + a.Dc - 1) / a.Dc;
  return is_bf16 ? dispatch<__nv_bfloat16>(a, nullptr, out) : dispatch<float>(a, nullptr, out);
}

extern "C" const char* mmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
