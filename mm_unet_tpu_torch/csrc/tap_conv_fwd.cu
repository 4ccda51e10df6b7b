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
// What bounds it on the H100: a bf16 stream's products run on the tensor
// cores (bf16 x bf16 -> f32, 989 TFLOP/s), where every MMConv shape of
// MM_Net is bound by its bytes (feat and y in, out out) or within 1.5x of
// them; the largest (stage 5, K*C = 1536, F = 512) is 3.2 GFLOP. So the
// design feeds the tensor cores from a gather: a block owns BM output
// pixels x BN features, computes each pixel's two source-row offsets and
// lerp weight per tap once, then walks the K*C reduction in 32-wide slices.
// Each slice's A operand (pixels x 32 taps) is gathered with 16-byte loads
// (8 bf16 channels of one source pixel a thread), lerped in f32, rounded and
// stored in a swizzled tile that ldmatrix reads without bank conflicts; the
// kernel's slice (32 x BN, already in the stream dtype) comes by cp.async.
// Both are double-buffered: the next slice's copy and loads are in flight
// while the warps run this slice's mma.sync m16n8k16 steps. An f32 stream
// runs the same tiles on the FMA units (TF32 would break its limits), and a
// ragged C or F (not a multiple of a 16-byte load) gathers element by
// element.
#include <cstdint>

#include "common.cuh"
#include "tap_geometry.cuh"
#include "tap_tile.cuh"

namespace {

using mmu::kMaxTaps;
using mmu::tile_elems;
using mmu::tile_idx;
constexpr int BK = 32;  // K*C columns per reduction slice

struct TapArgs {
  const void* feat;    // (B, H, W, C) stream dtype
  const float* y;      // (B, H, W, K) f32 row coordinates
  const void* kern;    // (K*C, F) stream dtype
  const float* bias;   // (F,)
  void* out;           // (B, H, W, F) stream dtype
  int shifts[kMaxTaps];
  int B, H, W, C, F, K;
};

template <typename TI, int BM, int BN>
__host__ __device__ constexpr size_t fwd_smem(int k) {
  return (2 * (size_t)tile_elems<TI>(BM, BK) + 2 * (size_t)tile_elems<TI>(BK, BN)) * sizeof(TI) +
         (size_t)BM * k * 8;
}

template <typename TI, int WM, int WN, int MT, int NT, bool VEC>
__global__ void __launch_bounds__(WM * WN * 32) tap_conv_kernel(TapArgs a) {
  constexpr int NTH = WM * WN * 32, BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int V = mmu::Vec16<TI>::V, CPT = BM * BK / V / NTH;  // A chunks per thread
  static_assert(CPT * V * NTH == BM * BK, "whole chunks per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  TI* As = reinterpret_cast<TI*>(smem);        // [2][BM][BK] gathered taps
  TI* Bs = As + 2 * tile_elems<TI>(BM, BK);    // [2][BK][BN] kernel
  int* lo_off = reinterpret_cast<int*>(Bs + 2 * tile_elems<TI>(BK, BN));  // -1: no pixel
  float* frac = reinterpret_cast<float*>(lo_off + BM * a.K);

  const int H = a.H, W = a.W, C = a.C, F = a.F, K = a.K;
  const int M = a.B * H * W, KC = K * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const TI* feat = static_cast<const TI*>(a.feat);
  const TI* kern = static_cast<const TI*>(a.kern);
  const int row = H > 1 ? W * C : 0;  // row hi is one image row past row lo
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;

  // per (pixel, tap): element offset of source row lo and the lerp weight
  for (int i = threadIdx.x; i < BM * K; i += NTH) {
    const int r = i / K, j = i - r * K, m = m0 + r;
    int lo_o = -1;
    float fr = 0.f;
    if (m < M) {
      const mmu::TapSource src = mmu::tap_source(a.y, m, j, K, H, W, C, mmu::tap_shift(a.shifts, j));
      lo_o = src.lo;
      fr = src.frac;
    }
    lo_off[i] = lo_o;
    frac[i] = fr;
  }
  __syncthreads();

  auto load_b = [&](int buf, int k0) {
    TI* bs = Bs + buf * tile_elems<TI>(BK, BN);
    if constexpr (VEC) {
      for (int q = threadIdx.x; q < BK * (BN / V); q += NTH) {
        const int kk = q / (BN / V), nn = (q % (BN / V)) * V, kc = k0 + kk, f = n0 + nn;
        const bool ok = kc < KC && f < F;
        mmu::cp_async16(bs + tile_idx<TI>(kk, nn, BN), ok ? kern + (size_t)kc * F + f : kern, ok);
      }
      mmu::cp_async_commit();
    } else {
      for (int q = threadIdx.x; q < BK * BN; q += NTH) {
        const int kk = q / BN, nn = q % BN, kc = k0 + kk, f = n0 + nn;
        bs[tile_idx<TI>(kk, nn, BN)] =
            kc < KC && f < F ? kern[(size_t)kc * F + f] : mmu::from_f32<TI>(0.f);
      }
    }
  };
  // A slice k0..k0 + BK: 16-byte chunks (pixel r, V taps), loads then stores
  uint4 lo[CPT], hi[CPT];
  float fr[CPT];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int q = threadIdx.x + i * NTH, r = q / (BK / V), kc = k0 + (q % (BK / V)) * V;
      fr[i] = -1.f;  // marks a zero chunk
      if (kc < KC) {
        const int j = kc / C, c = kc - j * C, s = r * K + j;
        if (lo_off[s] >= 0) {
          lo[i] = *reinterpret_cast<const uint4*>(feat + lo_off[s] + c);
          hi[i] = *reinterpret_cast<const uint4*>(feat + lo_off[s] + row + c);
          fr[i] = frac[s];
        }
      }
    }
  };
  auto store_a = [&](int buf) {
    TI* as = As + buf * tile_elems<TI>(BM, BK);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int q = threadIdx.x + i * NTH, r = q / (BK / V), kk = (q % (BK / V)) * V;
      *reinterpret_cast<uint4*>(as + tile_idx<TI>(r, kk, BK)) =
          fr[i] >= 0.f ? mmu::lerp16<TI>(lo[i], hi[i], fr[i]) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // ragged C: element by element
  auto gather_a = [&](int buf, int k0) {
    TI* as = As + buf * tile_elems<TI>(BM, BK);
    for (int q = threadIdx.x; q < BM * BK; q += NTH) {
      const int r = q / BK, kk = q % BK, kc = k0 + kk;
      float v = 0.f;
      if (kc < KC) {
        const int j = kc / C, c = kc - j * C, s = r * K + j;
        if (lo_off[s] >= 0)
          v = mmu::to_f32(feat[lo_off[s] + c]) * (1.f - frac[s]) +
              mmu::to_f32(feat[lo_off[s] + row + c]) * frac[s];
      }
      as[tile_idx<TI>(r, kk, BK)] = mmu::from_f32<TI>(v);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load_b(0, 0);
  if constexpr (VEC) {
    load_a(0);
    store_a(0);
  } else {
    gather_a(0, 0);
  }
  const int nk = (KC + BK - 1) / BK;
  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    const bool next = it + 1 < nk;
    mmu::cp_async_wait_all();
    __syncthreads();  // slice `buf` in place; every warp done with `buf ^ 1`
    if (next) {
      load_b(buf ^ 1, (it + 1) * BK);
      if constexpr (VEC) load_a((it + 1) * BK);
      else gather_a(buf ^ 1, (it + 1) * BK);
    }
    const TI* as = As + buf * tile_elems<TI>(BM, BK);
    const TI* bs = Bs + buf * tile_elems<TI>(BK, BN);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mmu::warp_mma_step<TI, MT, NT, false, true>(acc, as, BK, bs, BN, wm * MT * 16,
                                                      wn * NT * 8, kk);
    if constexpr (VEC) {
      if (next) store_a(buf ^ 1);
    }
  }

  TI* out = static_cast<TI*>(a.out);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * MT * 16 + mt * 16 + g + (e >> 1) * 8;
        const int f = n0 + wn * NT * 8 + nt * 8 + 2 * t + (e & 1);
        if (m < M && f < F) out[(size_t)m * F + f] = mmu::from_f32<TI>(acc[mt][nt][e] + a.bias[f]);
      }
}

template <typename TI, int WM, int WN, int MT, int NT, bool VEC>
int launch(const TapArgs& a, cudaStream_t stream) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  const auto kernel = tap_conv_kernel<TI, WM, WN, MT, NT, VEC>;
  const size_t smem = fwd_smem<TI, BM, BN>(a.K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int M = a.B * a.H * a.W;
  kernel<<<dim3((M + BM - 1) / BM, (a.F + BN - 1) / BN), WM * WN * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TI, bool VEC>
int dispatch(const TapArgs& a, cudaStream_t stream) {
  // narrow outputs: no lanes idle on padding features
  if (a.F <= 16) return launch<TI, 4, 1, 2, 2, VEC>(a, stream);
  if (a.F <= 32) return launch<TI, 4, 1, 2, 4, VEC>(a, stream);
  return launch<TI, 2, 2, 2, 4, VEC>(a, stream);
}

}  // namespace

extern "C" int tap_conv_fwd(const void* feat, const void* y, const void* kern,
                            const void* bias, const void* shifts, void* out, int B, int H,
                            int W, int C, int F, int K, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  TapArgs a;
  a.feat = feat;
  a.y = static_cast<const float*>(y);
  a.kern = kern;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  for (int j = 0; j < K; ++j) a.shifts[j] = static_cast<const int*>(shifts)[j];
  a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads: V channels and features at a time, aligned
  const int V = is_bf16 ? 8 : 4;
  const bool vec = C % V == 0 && F % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(kern)) & 15) == 0;
  if (is_bf16)
    return vec ? dispatch<__nv_bfloat16, true>(a, st) : dispatch<__nv_bfloat16, false>(a, st);
  return vec ? dispatch<float, true>(a, st) : dispatch<float, false>(a, st);
}
