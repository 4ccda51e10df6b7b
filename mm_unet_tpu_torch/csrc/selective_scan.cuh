// Shared by selective_scan_fwd.cu and selective_scan_bwd.cu: the arguments
// of the chunked selective scan, each block's place in the problem, and the
// staging of one chunk of the streams into shared memory.
//
// Layout. u, delta and z are (B, Dm, L) in one stream dtype (f32 or bf16);
// B and C are read through four strides over (batch, group, state, token),
// so (B, N, L), (B, G, N, L) and a constant (Dm, N) (group = channel, stride
// 0 over batch and tokens) all reach the kernels without a copy. Channel d
// belongs to B group d / b_gdiv and C group d / c_gdiv.
//
// Blocking. A block owns `chans` consecutive channels of one batch row and
// one chunk of T tokens; one thread per (channel, state), the NP >= N lanes of
// a channel (N rounded up to a power of two) in one warp. Channels are tiled
// in spans of `span` channels that share every B/C group, so a block stages
// its group's varying B/C chunk in shared memory once for all its channels.
// Ragged edges (channels past a span, tokens past L, lanes past N) are
// masked as identity steps of the scan (dt = u = B = 0), with no padding.
//
// Shared-memory rows. Every per-chunk row (a channel's u, dt, dout, z, or a
// state's B, C) takes ld floats, ld = T + 1 or T + 4 with T a multiple of
// 16, so that the N state lanes of a channel that read their B or C rows at
// one token, and neighbouring channels reading their own rows, fall in
// distinct banks (rows of T floats put them all in one bank). A kernel that
// reads four tokens of a row at once (`quad`) takes T + 4: 16-byte aligned,
// two wavefronts for four tokens of the 16 state rows.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mmu {

// four consecutive tokens of a row (t % 4 == 0: 16-byte aligned)
struct Quad {
  float v[4];
};
__device__ __forceinline__ Quad quad(const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  return {{f.x, f.y, f.z, f.w}};
}

struct ScanArgs {
  const void* u;       // (B, Dm, L) stream dtype
  const void* delta;   // (B, Dm, L) stream dtype: dt, or its raw value before bias/softplus
  const void* z;       // (B, Dm, L) stream dtype, or null (no gate)
  const void* Bm;      // B and C in their own dtype, read through bs / cs
  const void* Cm;
  const float* A;      // (Dm, N)
  const float* bias;   // (Dm) or null
  const float* Dskip;  // (Dm) or null
  float* state;        // (B, nC, Dm, N): chunk end states, then chunk-entry states
  float* dtsum;        // (B, nC, Dm): sum of dt over each chunk
  int64_t bs[4], cs[4];  // strides of B and C over (batch, group, state, token)
  int b_gdiv, c_gdiv;  // channels per B / C group
  bool b_var, c_var;   // B / C vary along the tokens (else constant (Dm, N))
  bool softplus;
  int Bsz, Dm, L, N, NP, T, nC;
  int span, chans, nDB;  // channels per span, per block, blocks per span
};

struct Blk {
  int b, s, j;  // batch row, span, block within the span
  int d0, live;  // first channel, channels of the block inside the span
};

// grid: x over (batch, span, block), y over chunks
__device__ __forceinline__ Blk block_of(const ScanArgs& a) {
  const int spans = a.Dm / a.span;
  Blk k;
  k.j = blockIdx.x % a.nDB;
  k.s = (blockIdx.x / a.nDB) % spans;
  k.b = blockIdx.x / (a.nDB * spans);
  k.d0 = k.s * a.span + k.j * a.chans;
  k.live = min(a.chans, a.span - k.j * a.chans);
  return k;
}

// one (B, Dm, L) stream's rows of the block into s [chans][ld] (f32), 0
// past L and for channels past the span
template <typename TI>
__device__ void stage_rows(const ScanArgs& a, const Blk& k, const void* p, int t0, int ld,
                           float* s) {
  const TI* x = static_cast<const TI*>(p);
  for (int i = threadIdx.x; i < a.chans * a.T; i += blockDim.x) {
    const int c = i / a.T, t = i - c * a.T, gt = t0 + t;
    s[c * ld + t] =
        (c < k.live && gt < a.L) ? to_f32(x[((size_t)k.b * a.Dm + k.d0 + c) * a.L + gt]) : 0.f;
  }
}

// dt_s [chans][ld] = softplus?(delta + bias), 0 past L (an identity step)
template <typename TI>
__device__ void stage_dt(const ScanArgs& a, const Blk& k, int t0, int ld, float* dt_s) {
  const TI* x = static_cast<const TI*>(a.delta);
  for (int i = threadIdx.x; i < a.chans * a.T; i += blockDim.x) {
    const int c = i / a.T, t = i - c * a.T, gt = t0 + t;
    float v = 0.f;
    if (c < k.live && gt < a.L) {
      v = to_f32(x[((size_t)k.b * a.Dm + k.d0 + c) * a.L + gt]);
      if (a.bias) v += a.bias[k.d0 + c];
      if (a.softplus) v = softplus(v);
    }
    dt_s[c * ld + t] = v;
  }
}

// s [rows][ld] = the block's group of a varying B or C, 0 past L, in the
// rows past N, and everywhere for p == nullptr
template <typename TB>
__device__ void stage_bc(const ScanArgs& a, const Blk& k, const void* p, const int64_t* st,
                         int gdiv, int t0, int ld, int rows, float* s) {
  const TB* x = p ? static_cast<const TB*>(p) + st[0] * k.b + st[1] * (k.d0 / gdiv) : nullptr;
  for (int i = threadIdx.x; i < rows * a.T; i += blockDim.x) {
    const int n = i / a.T, t = i - n * a.T, gt = t0 + t;
    s[n * ld + t] = (p && n < a.N && gt < a.L) ? to_f32(x[st[2] * n + st[3] * gt]) : 0.f;
  }
}

// element (d, n) of a constant (Dm, N) B or C
template <typename TB>
__device__ __forceinline__ float bc_const(const void* p, const int64_t* st, int d, int n) {
  return to_f32(static_cast<const TB*>(p)[st[1] * d + st[2] * n]);
}

// Fills the arguments both entry points share; false if the blocking is one
// the kernels do not take.
inline bool fill_scan_args(ScanArgs& a, const void* u, const void* delta, const void* z,
                           const void* Bm, const void* Cm, const void* A, const void* bias,
                           const void* Dskip, void* state, void* dtsum, const int64_t* bc_strides,
                           int b_gdiv, int c_gdiv, int b_var, int c_var, int Bsz, int Dm, int L, int N,
                           int T, int span, int chans, int softplus) {
  a.u = u; a.delta = delta; a.z = z; a.Bm = Bm; a.Cm = Cm;
  a.A = static_cast<const float*>(A);
  a.bias = static_cast<const float*>(bias);
  a.Dskip = static_cast<const float*>(Dskip);
  a.state = static_cast<float*>(state);
  a.dtsum = static_cast<float*>(dtsum);
  for (int i = 0; i < 4; ++i) {
    a.bs[i] = bc_strides[i];
    a.cs[i] = bc_strides[4 + i];
  }
  a.b_gdiv = b_gdiv; a.c_gdiv = c_gdiv;
  a.b_var = b_var != 0; a.c_var = c_var != 0;
  a.softplus = softplus != 0;
  a.Bsz = Bsz; a.Dm = Dm; a.L = L; a.N = N; a.T = T;
  a.NP = 1;
  while (a.NP < N) a.NP <<= 1;
  a.nC = (L + T - 1) / T;
  a.span = span; a.chans = chans;
  a.nDB = (span + chans - 1) / chans;
  const int threads = chans * a.NP;
  return N >= 1 && N <= 32 && T >= 1 && T <= 128 && span >= 1 && Dm % span == 0 &&
         threads % 32 == 0 && threads <= 512 && a.nC <= 65535 && b_gdiv >= 1 && c_gdiv >= 1;
}

}  // namespace mmu
