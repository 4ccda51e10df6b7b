// Morph-0 tap geometry shared by the tap-conv forward and backward kernels:
// where tap j of output pixel m samples (mm_unet_tpu/ops/tap_conv.py,
// `_TapConv`'s clamped column shifts and clipped 2-hot row interpolation).
#pragma once

#include "common.cuh"

namespace mmu {

constexpr int kMaxTaps = 9;

struct TapRows {
  int lo, hi;   // source rows lo and lo + 1 (clipped to H - 1)
  float frac;   // lerp weight of row hi
  bool inside;  // y within [0, H-1]: the clip passes its gradient only there
};

// yc = clip(y, 0, H-1), lo = clip(floor(yc), 0, H-2), frac = yc - lo
__device__ __forceinline__ TapRows tap_rows(float yv, int H) {
  const float yc = fminf(fmaxf(yv, 0.f), (float)(H - 1));
  const float lo = fminf(fmaxf(floorf(yc), 0.f), (float)max(H - 2, 0));
  const int lo_i = (int)lo;
  return {lo_i, min(lo_i + 1, H - 1), yc - lo, yv >= 0.f && yv <= (float)(H - 1)};
}

// shifts[j] for a j known only at run time, without indexing the kernel's
// argument array at run time (which copies the arguments to local memory)
__device__ __forceinline__ int tap_shift(const int (&shifts)[kMaxTaps], int j) {
  int s = 0;
#pragma unroll
  for (int q = 0; q < kMaxTaps; ++q) s = q == j ? shifts[q] : s;
  return s;
}

struct TapSource {
  int lo, hi;   // element offsets of rows lo and lo + 1 at column clamp(w + shift)
  float frac;   // lerp weight of row lo + 1
  bool inside;  // y within [0, H-1]
};

// pixel m = (b * H + h) * W + w of an NHWC map with C channels; y (M, K) f32
__device__ __forceinline__ TapSource tap_source(const float* y, int m, int j, int K, int H,
                                                int W, int C, int shift) {
  const int w = m % W, b = m / W / H;
  const TapRows r = tap_rows(y[(size_t)m * K + j], H);
  const int wc = min(max(w + shift, 0), W - 1);
  return {((b * H + r.lo) * W + wc) * C, ((b * H + r.hi) * W + wc) * C, r.frac, r.inside};
}

}  // namespace mmu
