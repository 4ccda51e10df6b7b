// Morph-0 tap-conv forward for Hopper: MMConv's deformable row sample fused
// with its (k, 1) stride-k convolution.
//
// Replaces the TPU kernel mm_unet_tpu/ops/tap_conv.py::_tap_fwd_kernel
// (launched by _tap_core._fwd_call). For every output pixel (b, h, w):
//   out[b,h,w,:] = bias + sum_j K_j^T . lerp(feat[b,lo,w',:], feat[b,lo+1,w',:], frac)
//   w' = clamp(w + dx_j, 0, W-1), yc = clip(y[b,h,w,j], 0, H-1),
//   lo = clip(floor(yc), 0, H-2), frac = yc - lo.
// The sampled taps are rounded to the stream dtype before the projection (as
// the TPU kernel feeds its MXU), the products accumulate in f32, and the
// output is written in the stream dtype. The (B, H*K, W, C) deformed tensor
// never exists in device memory.
//
// What bounds it on the H100: MM_Net's shapes span two regimes. The k=1
// reducers and the narrow decoder / side-out convs (K*C = 128..192, F = 16..64)
// do few operations per gathered byte and are bound by the gather; stage 5
// (K*C = 1536, F = 512) is a real matrix product and bound by arithmetic.
// The design is a tiled matrix product whose A operand is gathered: a block
// owns BM output pixels x BN output features, precomputes each pixel's two
// source-row offsets and lerp weight per tap once, then walks the K*C
// reduction in BK-wide slices, gathering and interpolating the A slice into
// shared memory (consecutive threads read consecutive channels of one NHWC
// pixel) next to the matching weight slice, and accumulates a TM x TN
// register tile per thread in f32. Narrow outputs (F <= 16) take a tile
// shape with BN = 16 so no lanes idle on padding features.
#include <cstdint>

#include "common.cuh"
#include "tap_geometry.cuh"

namespace {

using mmu::kMaxTaps;
constexpr int BK = 16;

struct TapArgs {
  const void* feat;    // (B, H, W, C) stream dtype
  const float* y;      // (B, H, W, K) f32 row coordinates
  const float* kern;   // (K*C, F) f32, rounded to the stream dtype
  const float* bias;   // (F,)
  void* out;           // (B, H, W, F) stream dtype
  int shifts[kMaxTaps];
  int B, H, W, C, F, K;
};

template <typename TI, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tap_conv_kernel(TapArgs a) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 4];  // gathered taps, k-major
  __shared__ float Bs[BK][BN];
  __shared__ int lo_off[BM * kMaxTaps];
  __shared__ int hi_off[BM * kMaxTaps];
  __shared__ float frac[BM * kMaxTaps];

  const int H = a.H, W = a.W, C = a.C, F = a.F, K = a.K;
  const int M = a.B * H * W, KC = K * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const TI* feat = static_cast<const TI*>(a.feat);

  // per (pixel, tap): element offsets of the two source rows and the weight
  for (int i = threadIdx.x; i < BM * K; i += NT) {
    const int r = i / K, j = i - r * K, m = m0 + r;
    int lo_o = -1, hi_o = -1;
    float fr = 0.f;
    if (m < M) {
      const mmu::TapSource src = mmu::tap_source(a.y, m, j, K, H, W, C, a.shifts[j]);
      lo_o = src.lo;
      hi_o = src.hi;
      fr = src.frac;
    }
    lo_off[i] = lo_o;
    hi_off[i] = hi_o;
    frac[i] = fr;
  }
  __syncthreads();

  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  for (int k0 = 0; k0 < KC; k0 += BK) {
    // gather + lerp the A slice: consecutive threads, consecutive channels
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i - r * BK, kc = k0 + kk;
      float v = 0.f;
      if (kc < KC) {
        const int j = kc / C, c = kc - j * C, s = r * K + j;
        if (lo_off[s] >= 0) {
          const float lo = mmu::to_f32(feat[lo_off[s] + c]);
          const float hi = mmu::to_f32(feat[hi_off[s] + c]);
          v = mmu::round_to<TI>(lo * (1.f - frac[s]) + hi * frac[s]);
        }
      }
      As[kk][r] = v;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i - kk * BN, kc = k0 + kk, f = n0 + nn;
      Bs[kk][nn] = (kc < KC && f < F) ? a.kern[(size_t)kc * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = As[kk][ty * TM + r];
#pragma unroll
      for (int q = 0; q < TN; ++q) bv[q] = Bs[kk][tx * TN + q];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

  TI* out = static_cast<TI*>(a.out);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty * TM + r;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int f = n0 + tx * TN + q;
      if (f < F) out[(size_t)m * F + f] = mmu::from_f32<TI>(acc[r][q] + a.bias[f]);
    }
  }
}

template <typename TI, int BM, int BN, int TM, int TN>
int launch(const TapArgs& a, cudaStream_t stream) {
  const int M = a.B * a.H * a.W;
  const dim3 grid((M + BM - 1) / BM, (a.F + BN - 1) / BN);
  tap_conv_kernel<TI, BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TI>
int dispatch(const TapArgs& a, cudaStream_t stream) {
  if (a.F <= 16) return launch<TI, 128, 16, 8, 1>(a, stream);
  return launch<TI, 64, 64, 4, 4>(a, stream);
}

}  // namespace

extern "C" int tap_conv_fwd(const void* feat, const void* y, const void* kern,
                            const void* bias, const void* shifts, void* out, int B, int H,
                            int W, int C, int F, int K, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  TapArgs a;
  a.feat = feat;
  a.y = static_cast<const float*>(y);
  a.kern = static_cast<const float*>(kern);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  for (int j = 0; j < K; ++j) a.shifts[j] = static_cast<const int*>(shifts)[j];
  a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
