// Morph-0 tap-conv backward for Hopper: the adjoint of tap_conv_fwd.cu.
//
// Replaces the TPU kernel mm_unet_tpu/ops/tap_conv.py::_tap_bwd_kernel
// (launched by _tap_core._bwd_call) and the host halo fold of its core_bwd.
// For output pixel m and tap j, with dtap_j = K_j . dout[m] (C values):
//   dfeat[lo, w'] += (1 - frac) dtap_j,  dfeat[lo + 1, w'] += frac dtap_j
//   dy[m, j] = sum_c dtap_j (feat[lo + 1, w'] - feat[lo, w']), 0 where y was
//              clipped to [0, H-1] (and 0 for H = 1, where lo + 1 = lo)
//   dkernel[j] = sum_m tap_j[m]^T dout[m]   (K*C x F, reduced over B*H*W)
// dbias = sum of dout is a plain reduction left to the wrapper, as JAX does
// it on the host. Under bf16 dout is read in bf16, dtap is rounded to bf16
// before the scatter and the taps of dkernel are the forward's rounded taps,
// as the TPU kernel feeds its MXU; every sum is f32.
//
// What bounds it on the H100: two products of the forward's two regimes.
// dtap is an (M x F) . (F x K*C) product whose epilogue scatters: the TPU
// needs a 2-hot hat matmul and a host fold for that scatter, here each
// product element goes to its two source rows with f32 atomics into an f32
// dfeat (the wrapper casts it to the stream dtype); at the narrow 256² shapes
// (K*C = 192, M = 524,288) the atomics bound it. dkernel is a (K*C x M) .
// (M x F) product with the forward's gathered A operand, split over M into
// per-block partials that the wrapper sums; at stage 5 (K*C = 1536,
// F = 512) the FMAs bound it. Both are tiled f32-FMA products as in the
// forward, with per-pixel tap geometry computed once per tile into shared
// memory.
#include <cstdint>

#include "common.cuh"
#include "tap_geometry.cuh"

namespace {

using mmu::kMaxTaps;
constexpr int BK = 16;

struct TapBwdArgs {
  const void* feat;   // (B, H, W, C) stream dtype
  const float* y;     // (B, H, W, K) f32 row coordinates
  const float* kern;  // (K*C, F) f32, rounded to the stream dtype
  const void* dout;   // (B, H, W, F) stream dtype
  float* dfeat;       // (B, H, W, C) f32, zeroed by the caller
  float* dy;          // (B, H, W, K) f32, zeroed by the caller
  float* p_dk;        // (n_split, K*C, F) partial sums over pixel slices
  int shifts[kMaxTaps];
  int B, H, W, C, F, K, ms;  // ms: pixels per dkernel slice
};

// dtap tile: BM pixels x BN of the K*C columns, reduced over F; the epilogue
// scatters into dfeat and sums dy per (pixel, tap)
template <typename TI, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) tap_dfeat_kernel(TapBwdArgs a) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 4];  // dout slice, f-major
  __shared__ float Bs[BK][BN + 1];  // kernel^T slice
  __shared__ int lo_off[BM * kMaxTaps];
  __shared__ int hi_off[BM * kMaxTaps];
  __shared__ float frac[BM * kMaxTaps];
  __shared__ float dy_s[BM * kMaxTaps];

  const int H = a.H, W = a.W, C = a.C, F = a.F, K = a.K;
  const int M = a.B * H * W, KC = K * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const TI* feat = static_cast<const TI*>(a.feat);
  const TI* dout = static_cast<const TI*>(a.dout);

  for (int i = threadIdx.x; i < BM * K; i += NT) {
    const int r = i / K, j = i - r * K, m = m0 + r;
    int lo_o = -1, hi_o = -1;
    float fr = 0.f;
    if (m < M) {
      const mmu::TapSource src = mmu::tap_source(a.y, m, j, K, H, W, C, a.shifts[j]);
      lo_o = src.lo;
      hi_o = src.hi;
      fr = src.inside ? src.frac : -1.f - src.frac;  // sign marks a clipped coordinate
    }
    lo_off[i] = lo_o;
    hi_off[i] = hi_o;
    frac[i] = fr;
    dy_s[i] = 0.f;
  }

  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BK) {
    // consecutive threads read consecutive features of one pixel / one row
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, ff = i - r * BK, m = m0 + r, f = f0 + ff;
      As[ff][r] = (m < M && f < F) ? mmu::to_f32(dout[(size_t)m * F + f]) : 0.f;
    }
    for (int i = threadIdx.x; i < BN * BK; i += NT) {
      const int q = i / BK, ff = i - q * BK, kc = n0 + q, f = f0 + ff;
      Bs[ff][q] = (kc < KC && f < F) ? a.kern[(size_t)kc * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ff = 0; ff < BK; ++ff) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = As[ff][ty * TM + r];
#pragma unroll
      for (int q = 0; q < TN; ++q) bv[q] = Bs[ff][tx * TN + q];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int rl = ty * TM + r, m = m0 + rl;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int kc = n0 + tx * TN + q;
      if (kc >= KC) continue;
      const int j = kc / C, c = kc - j * C, s = rl * K + j;
      const float v = acc[r][q];
      const float fr = frac[s];
      const float w1 = fr >= 0.f ? fr : -1.f - fr;
      const float vr = mmu::round_to<TI>(v);
      atomicAdd(&a.dfeat[lo_off[s] + c], (1.f - w1) * vr);
      atomicAdd(&a.dfeat[hi_off[s] + c], w1 * vr);
      if (fr >= 0.f) {
        const float diff = mmu::to_f32(feat[hi_off[s] + c]) - mmu::to_f32(feat[lo_off[s] + c]);
        atomicAdd(&dy_s[s], v * diff);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * K; i += NT) {
    const int m = m0 + i / K;
    if (m < M && frac[i] >= 0.f) atomicAdd(&a.dy[(size_t)m0 * K + i], dy_s[i]);
  }
}

// dkernel tile: BM of the K*C rows x BN features, reduced over one slice of
// ms pixels; the A operand is the forward's gathered, rounded taps
template <typename TI, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) tap_dkernel_kernel(TapBwdArgs a) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 4];  // taps, pixel-major
  __shared__ float Bs[BK][BN];      // dout
  __shared__ int lo_off[BK * kMaxTaps];
  __shared__ int hi_off[BK * kMaxTaps];
  __shared__ float frac[BK * kMaxTaps];

  const int H = a.H, W = a.W, C = a.C, F = a.F, K = a.K;
  const int M = a.B * H * W, KC = K * C;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * a.ms, m_end = min(M, m_begin + a.ms);
  const TI* feat = static_cast<const TI*>(a.feat);
  const TI* dout = static_cast<const TI*>(a.dout);

  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  for (int mb = m_begin; mb < m_end; mb += BK) {
    for (int i = threadIdx.x; i < BK * K; i += NT) {
      const int mm = i / K, j = i - mm * K, m = mb + mm;
      int lo_o = -1, hi_o = -1;
      float fr = 0.f;
      if (m < m_end) {
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
    // consecutive threads gather consecutive channels of one source pixel
    for (int i = threadIdx.x; i < BK * BM; i += NT) {
      const int mm = i / BM, r = i - mm * BM, kc = k0 + r;
      float v = 0.f;
      if (kc < KC) {
        const int j = kc / C, c = kc - j * C, s = mm * K + j;
        if (lo_off[s] >= 0) {
          const float lo = mmu::to_f32(feat[lo_off[s] + c]);
          const float hi = mmu::to_f32(feat[hi_off[s] + c]);
          v = mmu::round_to<TI>(lo * (1.f - frac[s]) + hi * frac[s]);
        }
      }
      As[mm][r] = v;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int mm = i / BN, q = i - mm * BN, m = mb + mm, f = n0 + q;
      Bs[mm][q] = (m < m_end && f < F) ? mmu::to_f32(dout[(size_t)m * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < BK; ++mm) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = As[mm][ty * TM + r];
#pragma unroll
      for (int q = 0; q < TN; ++q) bv[q] = Bs[mm][tx * TN + q];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

  float* out = a.p_dk + (size_t)blockIdx.z * KC * F;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int kc = k0 + ty * TM + r;
    if (kc >= KC) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int f = n0 + tx * TN + q;
      if (f < F) out[(size_t)kc * F + f] = acc[r][q];
    }
  }
}

template <typename TI>
int dispatch(const TapBwdArgs& a, cudaStream_t stream) {
  const int M = a.B * a.H * a.W, KC = a.K * a.C;
  tap_dfeat_kernel<TI, 64, 64, 4, 4><<<dim3((M + 63) / 64, (KC + 63) / 64), 256, 0, stream>>>(a);
  const unsigned splits = (M + a.ms - 1) / a.ms;
  if (a.F <= 16) {  // narrow outputs: no lanes idle on padding features
    tap_dkernel_kernel<TI, 128, 16, 8, 1>
        <<<dim3((KC + 127) / 128, (a.F + 15) / 16, splits), 256, 0, stream>>>(a);
  } else {
    tap_dkernel_kernel<TI, 64, 64, 4, 4>
        <<<dim3((KC + 63) / 64, (a.F + 63) / 64, splits), 256, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tap_conv_bwd(const void* feat, const void* y, const void* kern, const void* shifts,
                            const void* dout, void* dfeat, void* dy, void* p_dk, int B, int H,
                            int W, int C, int F, int K, int ms, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxTaps || ms < 1 || ms % BK) return cudaErrorInvalidValue;
  TapBwdArgs a;
  a.feat = feat;
  a.y = static_cast<const float*>(y);
  a.kern = static_cast<const float*>(kern);
  a.dout = dout;
  a.dfeat = static_cast<float*>(dfeat);
  a.dy = static_cast<float*>(dy);
  a.p_dk = static_cast<float*>(p_dk);
  for (int j = 0; j < K; ++j) a.shifts[j] = static_cast<const int*>(shifts)[j];
  a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.K = K; a.ms = ms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
