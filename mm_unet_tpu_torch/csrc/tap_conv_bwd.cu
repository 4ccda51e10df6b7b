// Morph-0 tap-conv backward for Hopper: the adjoint of tap_conv_fwd.cu.
//
// Replaces the TPU kernel mm_unet_tpu/ops/tap_conv.py::_tap_bwd_kernel
// (launched by _tap_core._bwd_call) and the host halo fold of its core_bwd.
// For output pixel m and tap j, with dtap_j = K_j . dout[m] (C values):
//   dfeat[lo, w'] += (1 - frac) dtap_j,  dfeat[lo + 1, w'] += frac dtap_j
//   dy[m, j] = sum_c dtap_j (feat[lo + 1, w'] - feat[lo, w']), 0 where y was
//              clipped to [0, H-1] (and 0 for H = 1, where lo + 1 = lo)
//   dkernel[j] = sum_m tap_j[m]^T dout[m]   (K*C x F, reduced over B*H*W)
//   dbias = sum_m dout[m]
// Under bf16 dout and the kernel are read in bf16, dtap is rounded to bf16
// before the scatter and the taps of dkernel are the forward's rounded taps,
// as the TPU kernel feeds its MXU; every sum is f32. dfeat is written in the
// stream dtype, dy, dkernel and dbias in f32.
//
// What bounds it on the H100: at tensor-core rates every MMConv shape of
// MM_Net is bound by its bytes (feat, dout in; dfeat out), or within 1.5x of
// them. What stood in the way was the dfeat scatter: two f32 global atomics
// per (pixel, tap, channel), 201 M per call at the 256² side-output shape
// (B = 8, C = 64, F = 16, K = 3) and ~1.23 G per train step. The TPU kernel
// avoids it by keeping dfeat for its tile of columns over all source rows
// in VMEM. Here the same idea is sized for shared memory:
//
// - tap_dfeat_kernel: a block owns a strip of TW output columns of dfeat
//   and a slice of 16 channels, over every row of one image, in shared
//   memory (H x TW x 20 floats; TW from H so that two blocks fit an SM). It
//   walks every pixel whose taps can land in its strip (its columns and
//   max|shift| columns either side, all rows), 128 at a time, computes dtap
//   for its 16 channels ((pixels x F) . (F x K*16), 16-deep warp steps, on
//   the tensor cores for bf16) and adds each value's two lerp shares into
//   the strip, whatever the row: the sum is exact for any coordinates. The
//   adds are 128-bit compare-and-swaps on shared memory, four channels each
//   (lanes t and t ^ 1 trade channel pairs first): sm_90 has no native
//   float add on shared memory, and per float the loop cost four times as
//   much. The strip then goes to dfeat once, in the stream dtype, with
//   plain 16-byte stores: every element of dfeat belongs to one block, so
//   it needs no zero fill, no global atomics and no cast pass. The halo
//   pixels' products are computed by both neighbours ((TW + 2 S) / TW of
//   the product). dy is summed over the slice's channels in registers (its
//   source rows loaded before the product) and added once per (pixel, tap,
//   slice) to a dy zeroed by cudaMemsetAsync. At the 256² side output (TW =
//   4, 4 slices) a call makes 6.3 M scalar global atomics, all for dy, and
//   none for dfeat, against 201 M + 4.7 M before; the strip takes 50 M
//   shared 128-bit compare-and-swaps. A layout with one pixel column per
//   warp and plain shared adds (taps in turn, lanes meeting in one cell
//   taking turns) measured slower on the H100: its tiles leave warps idle
//   and serialise the taps.
// - tap_dkernel_kernel: dkernel's (K*C x M) . (M x F) product over one
//   slice of pixels per block (A the gathered, rounded taps, by 16-byte
//   loads; dout by cp.async, both double-buffered), written as per-slice
//   partials; the blocks of the first K*C tile also sum dout for dbias.
//   tap_dkernel_reduce_kernel sums the partials: both launched here, so the
//   wrapper does no reduction of its own.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <type_traits>

#include "common.cuh"
#include "tap_geometry.cuh"
#include "tap_tile.cuh"

namespace {

using mmu::kMaxTaps;
using mmu::tile_elems;
using mmu::tile_idx;
constexpr int kCB = 16;             // channels of a dfeat block's slice
constexpr int kStripPad = kCB + 4;  // floats per (row, column) cell: 16-byte aligned
constexpr int kPT = 128;            // pixels per dtap tile: 8 warps x 16
constexpr int kFK = 32;             // features per dtap reduction step
constexpr int kDfeatThreads = 256;
constexpr int kBK = 32;             // pixels per dkernel reduction step

struct TapBwdArgs {
  const void* feat;   // (B, H, W, C) stream dtype
  const float* y;     // (B, H, W, K) f32 row coordinates
  const void* kern;   // (K*C, F) stream dtype
  const void* dout;   // (B, H, W, F) stream dtype
  void* dfeat;        // (B, H, W, C) stream dtype
  float* dy;          // (B, H, W, K) f32
  float* p_dk;        // (splits, K*C, F) partial sums over pixel slices
  float* p_db;        // (splits, F)
  float* dk;          // (K*C, F)
  float* db;          // (F,)
  int shifts[kMaxTaps];
  int B, H, W, C, F, K, ms, splits;  // ms: pixels per dkernel slice
  int tw, halo;  // dfeat strip width and max |shift|
};

// the two floats packed in v (low word first), plus a and b
__device__ __forceinline__ unsigned long long add_packed(unsigned long long v, float a, float b) {
  const float lo = __uint_as_float(static_cast<unsigned>(v)) + a;
  const float hi = __uint_as_float(static_cast<unsigned>(v >> 32)) + b;
  return static_cast<unsigned long long>(__float_as_uint(lo)) |
         (static_cast<unsigned long long>(__float_as_uint(hi)) << 32);
}

// p[0..3] += d on four floats of shared memory (16-byte aligned) by one
// 128-bit compare-and-swap loop, where a float atomicAdd on shared memory
// is a compare-and-swap loop per float
__device__ __forceinline__ void add4_cas(float* p, float4 d) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned long long lo = *reinterpret_cast<const unsigned long long*>(p);
  unsigned long long hi = *reinterpret_cast<const unsigned long long*>(p + 2);
  while (true) {
    const unsigned long long nlo = add_packed(lo, d.x, d.y), nhi = add_packed(hi, d.z, d.w);
    unsigned long long olo, ohi;
    asm volatile(
        "{\n\t.reg .b128 cmp, val, res;\n\t"
        "mov.b128 cmp, {%2, %3};\n\t"
        "mov.b128 val, {%4, %5};\n\t"
        "atom.shared.cas.b128 res, [%6], cmp, val;\n\t"
        "mov.b128 {%0, %1}, res;\n\t}"
        : "=l"(olo), "=l"(ohi)
        : "l"(lo), "l"(hi), "l"(nlo), "l"(nhi), "r"(s)
        : "memory");
    if (olo == lo && ohi == hi) return;
    lo = olo;
    hi = ohi;
  }
}

// two consecutive stream-dtype values as f32; p aligned to two of them
template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename TI>
__host__ __device__ constexpr size_t dfeat_fixed_smem(int kt) {
  return (2 * (size_t)tile_elems<TI>(kPT, kFK) + 2 * (size_t)tile_elems<TI>(kt * kCB, kFK)) *
             sizeof(TI) +
         (size_t)kPT * kt * 5 * 4 + (size_t)kPT * 4;
}

// dfeat strip of one (image, TW columns, 16 channels); see the note above
template <typename TI, int KT, bool VEC>
__global__ void __launch_bounds__(kDfeatThreads, 2) tap_dfeat_kernel(TapBwdArgs a) {
  constexpr int V = mmu::Vec16<TI>::V;
  // dy's source rows prefetched into registers (bf16 pairs, up to 3 taps)
  constexpr bool PF = VEC && KT <= 3 && std::is_same<TI, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  TI* Ds = reinterpret_cast<TI*>(smem);           // [2][kPT][kFK] dout
  TI* Ks = Ds + 2 * tile_elems<TI>(kPT, kFK);     // [2][KT*kCB][kFK] kernel rows j*C + c0 + cc
  int* g_clo = reinterpret_cast<int*>(Ks + 2 * tile_elems<TI>(KT * kCB, kFK));
  int* g_chi = g_clo + kPT * KT;  // strip cells of rows lo / hi (-1: not in the strip)
  int* g_slo = g_chi + kPT * KT;  // feat offsets of rows lo / hi for dy (-1: no dy here)
  int* g_shi = g_slo + kPT * KT;
  float* g_fr = reinterpret_cast<float*>(g_shi + kPT * KT);
  int* g_m = reinterpret_cast<int*>(g_fr + kPT * KT);  // owned pixel index (-1: halo)
  float* strip = reinterpret_cast<float*>(g_m + kPT);   // [H][TW][kStripPad]

  const int H = a.H, W = a.W, C = a.C, F = a.F, K = a.K, TW = a.tw;
  const int b = blockIdx.z, w0 = blockIdx.x * TW, c0 = blockIdx.y * kCB;
  const int wb = max(w0 - a.halo, 0), we = min(w0 + TW + a.halo, W), PW = we - wb;
  const int npx = H * PW;
  const TI* feat = static_cast<const TI*>(a.feat);
  const TI* dout = static_cast<const TI*>(a.dout);
  const TI* kern = static_cast<const TI*>(a.kern);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  for (int i = threadIdx.x; i < H * TW * kStripPad; i += kDfeatThreads) strip[i] = 0.f;

  // one reduction step's tiles: dout of the tile's pixels, the slice's kernel rows
  auto load = [&](int buf, int p0, int f0) {
    TI* ds = Ds + buf * tile_elems<TI>(kPT, kFK);
    TI* ks = Ks + buf * tile_elems<TI>(KT * kCB, kFK);
    if constexpr (VEC) {
      for (int q = threadIdx.x; q < kPT * (kFK / V); q += kDfeatThreads) {
        const int r = q / (kFK / V), cc = (q % (kFK / V)) * V, p = p0 + r, h = p / PW;
        const bool ok = p < npx && f0 + cc < F;
        const TI* src = dout + ((size_t)(b * H + h) * W + wb + p - h * PW) * F + f0 + cc;
        mmu::cp_async16(ds + tile_idx<TI>(r, cc, kFK), ok ? src : dout, ok);
      }
      for (int q = threadIdx.x; q < KT * kCB * (kFK / V); q += kDfeatThreads) {
        const int n = q / (kFK / V), cc = (q % (kFK / V)) * V, j = n / kCB, c = c0 + n % kCB;
        const bool ok = j < K && c < C && f0 + cc < F;
        const TI* src = kern + (size_t)(j * C + c) * F + f0 + cc;
        mmu::cp_async16(ks + tile_idx<TI>(n, cc, kFK), ok ? src : kern, ok);
      }
    } else {
      for (int q = threadIdx.x; q < kPT * kFK; q += kDfeatThreads) {
        const int r = q / kFK, cc = q % kFK, p = p0 + r, h = p / PW;
        ds[tile_idx<TI>(r, cc, kFK)] =
            p < npx && f0 + cc < F
                ? dout[((size_t)(b * H + h) * W + wb + p - h * PW) * F + f0 + cc]
                : mmu::from_f32<TI>(0.f);
      }
      for (int q = threadIdx.x; q < KT * kCB * kFK; q += kDfeatThreads) {
        const int n = q / kFK, cc = q % kFK, j = n / kCB, c = c0 + n % kCB;
        ks[tile_idx<TI>(n, cc, kFK)] = j < K && c < C && f0 + cc < F
                                           ? kern[(size_t)(j * C + c) * F + f0 + cc]
                                           : mmu::from_f32<TI>(0.f);
      }
    }
    mmu::cp_async_commit();
  };

  for (int p0 = 0; p0 < npx; p0 += kPT) {
    __syncthreads();  // the strip is zeroed; the last tile's epilogue is done with the geometry
    for (int i = threadIdx.x; i < kPT * K; i += kDfeatThreads) {
      const int r = i / K, j = i - r * K, p = p0 + r;
      int clo = -1, chi = -1, slo = -1, shi = -1;
      float fr = 0.f;
      if (p < npx) {
        const int h = p / PW, w = wb + p - h * PW, m = (b * H + h) * W + w;
        const mmu::TapRows rw = mmu::tap_rows(a.y[(size_t)m * K + j], H);
        const int wc = min(max(w + mmu::tap_shift(a.shifts, j), 0), W - 1), dc = wc - w0;
        fr = rw.frac;
        if (dc >= 0 && dc < TW) {
          clo = (rw.lo * TW + dc) * kStripPad;
          chi = (rw.hi * TW + dc) * kStripPad;
        }
        if (w >= w0 && w < w0 + TW && rw.inside) {
          slo = ((b * H + rw.lo) * W + wc) * C;
          shi = ((b * H + rw.hi) * W + wc) * C;
        }
        if (j == 0) g_m[r] = (w >= w0 && w < w0 + TW) ? m : -1;
      } else if (j == 0) {
        g_m[r] = -1;
      }
      g_clo[i] = clo;
      g_chi[i] = chi;
      g_slo[i] = slo;
      g_shi[i] = shi;
      g_fr[i] = fr;
    }

    float acc[KT][1][2][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][0][nt][e] = 0.f;

    // dy's source rows for this lane's pixels and channels (bf16 pairs),
    // loaded before the product so that their latency overlaps it
    unsigned rlo[PF ? KT : 1][2][2], rhi[PF ? KT : 1][2][2];
    auto prefetch = [&]() {
#pragma unroll
      for (int j = 0; j < (PF ? KT : 0); ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = (warp * 16 + g + half * 8) * K + j;
          const int slo = j < K ? g_slo[s] : -1, shi = j < K ? g_shi[s] : -1;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int c = c0 + nt * 8 + 2 * t;
            const bool ok = slo >= 0 && c < C;
            rlo[j][half][nt] = ok ? *reinterpret_cast<const unsigned*>(feat + slo + c) : 0u;
            rhi[j][half][nt] = ok ? *reinterpret_cast<const unsigned*>(feat + shi + c) : 0u;
          }
        }
    };

    load(0, p0, 0);
    for (int f0 = 0, it = 0; f0 < F; f0 += kFK, ++it) {
      const int buf = it & 1;
      mmu::cp_async_wait_all();
      __syncthreads();  // tiles `buf` in place; every warp done with `buf ^ 1`
      if (PF && it == 0) prefetch();  // the geometry is visible from here
      if (f0 + kFK < F) load(buf ^ 1, p0, f0 + kFK);
      const TI* ds = Ds + buf * tile_elems<TI>(kPT, kFK);
      const TI* ks = Ks + buf * tile_elems<TI>(KT * kCB, kFK);
#pragma unroll
      for (int k0 = 0; k0 < kFK; k0 += 16)
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (j < K)
            mmu::warp_mma_step<TI, 1, 2, false, false>(acc[j], ds, kFK, ks, kFK, warp * 16,
                                                       j * kCB, k0);
    }

    // epilogue: each dtap value's two lerp shares into the strip, dy per (pixel, tap)
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= K) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + half * 8, s = r * K + j;
        const int clo = g_clo[s], chi = g_chi[s], slo = g_slo[s], shi = g_shi[s];
        const float w1 = g_fr[s];
        // the lerp shares: lanes t and t ^ 1 (one pixel) trade channel pairs
        // so that each holds four consecutive channels, one 128-bit
        // compare-and-swap per row
        {
          const float r00 = mmu::round_to<TI>(acc[j][0][0][half * 2]);
          const float r01 = mmu::round_to<TI>(acc[j][0][0][half * 2 + 1]);
          const float r10 = mmu::round_to<TI>(acc[j][0][1][half * 2]);
          const float r11 = mmu::round_to<TI>(acc[j][0][1][half * 2 + 1]);
          const bool odd = t & 1;
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? r00 : r10, 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? r01 : r11, 1);
          const float4 q = odd ? make_float4(s0, s1, r10, r11) : make_float4(r00, r01, s0, s1);
          const int cq = odd ? 2 * t + 6 : 2 * t;  // first of the four channels
          if (clo >= 0) {
            add4_cas(&strip[clo + cq], make_float4((1.f - w1) * q.x, (1.f - w1) * q.y,
                                                   (1.f - w1) * q.z, (1.f - w1) * q.w));
            add4_cas(&strip[chi + cq], make_float4(w1 * q.x, w1 * q.y, w1 * q.z, w1 * q.w));
          }
        }
        float d = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int cc = nt * 8 + 2 * t, c = c0 + cc;  // this lane's channels cc, cc + 1
          const float v0 = acc[j][0][nt][half * 2], v1 = acc[j][0][nt][half * 2 + 1];
          if (slo >= 0) {
            if constexpr (PF) {
              const float2 lo =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rlo[j][half][nt]));
              const float2 hi =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rhi[j][half][nt]));
              d += v0 * (hi.x - lo.x) + v1 * (hi.y - lo.y);
            } else if constexpr (VEC) {  // C a multiple of 4: c, c + 1 both in range or out
              if (c < C) {
                const float2 lo = load2(feat + slo + c), hi = load2(feat + shi + c);
                d += v0 * (hi.x - lo.x) + v1 * (hi.y - lo.y);
              }
            } else {
              if (c < C) d += v0 * (mmu::to_f32(feat[shi + c]) - mmu::to_f32(feat[slo + c]));
              if (c + 1 < C)
                d += v1 * (mmu::to_f32(feat[shi + c + 1]) - mmu::to_f32(feat[slo + c + 1]));
            }
          }
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (t == 0 && slo >= 0) atomicAdd(&a.dy[(size_t)g_m[r] * K + j], d);
      }
    }
  }
  __syncthreads();

  // flush: the strip's own columns and channels, once, in the stream dtype
  TI* dfeat = static_cast<TI*>(a.dfeat);
  constexpr int NV = VEC ? V : 1;
  for (int i = threadIdx.x; i < H * TW * (kCB / NV); i += kDfeatThreads) {
    const int cell = i / (kCB / NV), q = (i % (kCB / NV)) * NV;
    const int row = cell / TW, w = w0 + cell % TW, c = c0 + q;
    if (w >= W || c >= C) continue;
    const float* src = strip + cell * kStripPad + q;
    TI* dst = dfeat + ((size_t)(b * H + row) * W + w) * C + c;
    if constexpr (VEC) {
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = src[e];
      *reinterpret_cast<uint4*>(dst) = mmu::Vec16<TI>::pack(v);
    } else {
      *dst = mmu::from_f32<TI>(*src);
    }
  }
}

// dkernel tile: BM of the K*C rows x BN features, reduced over one slice of
// ms pixels in kBK-pixel steps; A is the forward's gathered, rounded taps,
// stored pixel-major, B is dout. Tiles double-buffered: the next step's
// dout by cp.async and its gather are issued before this step's product.
template <typename TI, int WM, int WN, int MT, int NT, bool VEC>
__global__ void __launch_bounds__(WM * WN * 32) tap_dkernel_kernel(TapBwdArgs a) {
  constexpr int NTH = WM * WN * 32, BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int V = mmu::Vec16<TI>::V;
  __shared__ __align__(16) TI As[2][tile_elems<TI>(kBK, BM)];
  __shared__ __align__(16) TI Bs[2][tile_elems<TI>(kBK, BN)];
  __shared__ int lo_off[2][kBK * kMaxTaps];  // row hi is one image row further, for H > 1
  __shared__ float frac[2][kBK * kMaxTaps];

  const int H = a.H, W = a.W, C = a.C, F = a.F, K = a.K;
  const int M = a.B * H * W, KC = K * C;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * a.ms, m_end = min(M, m_begin + a.ms);
  const TI* feat = static_cast<const TI*>(a.feat);
  const TI* dout = static_cast<const TI*>(a.dout);
  const int row = H > 1 ? W * C : 0;  // hi_off - lo_off
  const bool sum_db = blockIdx.x == 0;
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;

  auto geometry = [&](int gb, int mb) {
    for (int i = threadIdx.x; i < kBK * K; i += NTH) {
      const int mm = i / K, j = i - mm * K, m = mb + mm;
      int lo_o = -1;
      float fr = 0.f;
      if (m < m_end) {
        const mmu::TapSource src = mmu::tap_source(a.y, m, j, K, H, W, C, mmu::tap_shift(a.shifts, j));
        lo_o = src.lo;
        fr = src.frac;
      }
      lo_off[gb][i] = lo_o;
      frac[gb][i] = fr;
    }
  };
  // the taps of pixels mb.. (rows) at K*C columns k0.., and dout at features n0..
  auto load = [&](int buf, int gb, int mb) {
    if constexpr (VEC) {
      for (int q = threadIdx.x; q < kBK * (BN / V); q += NTH) {
        const int mm = q / (BN / V), cc = (q % (BN / V)) * V, m = mb + mm, f = n0 + cc;
        const bool ok = m < m_end && f < F;
        mmu::cp_async16(&Bs[buf][tile_idx<TI>(mm, cc, BN)], ok ? dout + (size_t)m * F + f : dout,
                        ok);
      }
      mmu::cp_async_commit();
      for (int q = threadIdx.x; q < kBK * (BM / V); q += NTH) {
        const int mm = q / (BM / V), rr = (q % (BM / V)) * V, kc = k0 + rr;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kc < KC) {
          const int j = kc / C, c = kc - j * C, s = mm * K + j;
          if (lo_off[gb][s] >= 0)
            v = mmu::lerp16<TI>(*reinterpret_cast<const uint4*>(feat + lo_off[gb][s] + c),
                                *reinterpret_cast<const uint4*>(feat + lo_off[gb][s] + row + c),
                                frac[gb][s]);
        }
        *reinterpret_cast<uint4*>(&As[buf][tile_idx<TI>(mm, rr, BM)]) = v;
      }
    } else {
      for (int q = threadIdx.x; q < kBK * BN; q += NTH) {
        const int mm = q / BN, cc = q % BN, m = mb + mm, f = n0 + cc;
        Bs[buf][tile_idx<TI>(mm, cc, BN)] =
            m < m_end && f < F ? dout[(size_t)m * F + f] : mmu::from_f32<TI>(0.f);
      }
      for (int q = threadIdx.x; q < kBK * BM; q += NTH) {
        const int mm = q / BM, rr = q % BM, kc = k0 + rr;
        float v = 0.f;
        if (kc < KC) {
          const int j = kc / C, c = kc - j * C, s = mm * K + j;
          if (lo_off[gb][s] >= 0) {
            const float fr = frac[gb][s];
            v = mmu::to_f32(feat[lo_off[gb][s] + c]) * (1.f - fr) +
                mmu::to_f32(feat[lo_off[gb][s] + row + c]) * fr;
          }
        }
        As[buf][tile_idx<TI>(mm, rr, BM)] = mmu::from_f32<TI>(v);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float db_acc = 0.f;  // thread f < BN: its feature's dout sum over the slice

  geometry(0, m_begin);
  __syncthreads();
  load(0, 0, m_begin);
  for (int mb = m_begin, it = 0; mb < m_end; mb += kBK, ++it) {
    const int buf = it & 1;
    const bool next = mb + kBK < m_end;
    if (next) geometry(buf ^ 1, mb + kBK);
    mmu::cp_async_wait_all();
    __syncthreads();  // tiles and geometry `buf` / `buf ^ 1` in place; `buf ^ 1` tiles free
    if (next) load(buf ^ 1, buf ^ 1, mb + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
      mmu::warp_mma_step<TI, MT, NT, true, true>(acc, As[buf], BM, Bs[buf], BN, wm * MT * 16,
                                                 wn * NT * 8, kk);
    if (sum_db && threadIdx.x < BN)
      for (int mm = 0; mm < kBK; ++mm)
        db_acc += mmu::to_f32(Bs[buf][tile_idx<TI>(mm, threadIdx.x, BN)]);
  }

  float* out = a.p_dk + (size_t)blockIdx.z * KC * F;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + wm * MT * 16 + mt * 16 + g + (e >> 1) * 8;
        const int f = n0 + wn * NT * 8 + nt * 8 + 2 * t + (e & 1);
        if (kc < KC && f < F) out[(size_t)kc * F + f] = acc[mt][nt][e];
      }
  if (sum_db && threadIdx.x < BN && n0 + (int)threadIdx.x < F)
    a.p_db[(size_t)blockIdx.z * F + n0 + threadIdx.x] = db_acc;
}

// dkernel and dbias: the sums of the per-slice partials
__global__ void tap_dkernel_reduce_kernel(TapBwdArgs a) {
  const int KF = a.K * a.C * a.F;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < KF + a.F; i += gridDim.x * blockDim.x) {
    const bool is_dk = i < KF;
    const float* p = is_dk ? a.p_dk + i : a.p_db + (i - KF);
    const size_t stride = is_dk ? (size_t)KF : (size_t)a.F;
    float s = 0.f;
    for (int z = 0; z < a.splits; ++z) s += p[z * stride];
    if (is_dk) a.dk[i] = s;
    else a.db[i - KF] = s;
  }
}

template <typename TI, int KT, bool VEC>
int launch_dfeat(TapBwdArgs a, cudaStream_t stream) {
  // strip width: two blocks per SM where the rows allow, else one; at
  // least two blocks per SM in the grid while strips stay 4 wide
  const size_t fixed = dfeat_fixed_smem<TI>(KT);
  const size_t col_bytes = (size_t)a.H * kStripPad * 4;
  const size_t two = 113 * 1024, one = 227 * 1024;
  long tw = two > fixed ? (long)((two - fixed) / col_bytes) : 0;
  if (tw < 1) tw = one > fixed ? (long)((one - fixed) / col_bytes) : 0;
  if (tw < 1) return cudaErrorInvalidValue;  // more rows than a strip column can hold
  tw = std::min<long>(std::min<long>(tw, 32), a.W);
  const long slices = (a.C + kCB - 1) / kCB;
  while (tw > 4 && (long)a.B * ((a.W + tw - 1) / tw) * slices < 264) tw = (tw + 1) / 2;
  a.tw = (int)tw;
  const auto kernel = tap_dfeat_kernel<TI, KT, VEC>;
  const size_t smem = fixed + (size_t)a.tw * col_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((a.W + a.tw - 1) / a.tw, (unsigned)slices, a.B), kDfeatThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TI, bool VEC>
int dispatch(TapBwdArgs a, cudaStream_t stream) {
  const int M = a.B * a.H * a.W, KC = a.K * a.C;
  cudaError_t e = cudaMemsetAsync(a.dy, 0, (size_t)M * a.K * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  int err = a.K == 1   ? launch_dfeat<TI, 1, VEC>(a, stream)
            : a.K <= 3 ? launch_dfeat<TI, 3, VEC>(a, stream)
                       : launch_dfeat<TI, kMaxTaps, VEC>(a, stream);
  if (err) return err;
  const unsigned splits = a.splits;
  if (a.F <= 16) {  // narrow outputs: no lanes idle on padding features
    tap_dkernel_kernel<TI, 4, 1, 2, 2, VEC>
        <<<dim3((KC + 127) / 128, (a.F + 15) / 16, splits), 128, 0, stream>>>(a);
  } else if (a.F <= 32) {
    tap_dkernel_kernel<TI, 4, 1, 2, 4, VEC>
        <<<dim3((KC + 127) / 128, (a.F + 31) / 32, splits), 128, 0, stream>>>(a);
  } else {
    tap_dkernel_kernel<TI, 2, 2, 2, 4, VEC>
        <<<dim3((KC + 63) / 64, (a.F + 63) / 64, splits), 128, 0, stream>>>(a);
  }
  if ((err = cudaGetLastError())) return err;
  const int n = KC * a.F + a.F;
  tap_dkernel_reduce_kernel<<<std::min((n + 255) / 256, 1024), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dfeat in the stream dtype; dy, dk (K*C, F) and db (F) f32; p_dk and p_db
// scratch for `splits` = ceil(M / ms) pixel slices of the dkernel product
extern "C" int tap_conv_bwd(const void* feat, const void* y, const void* kern, const void* shifts,
                            const void* dout, void* dfeat, void* dy, void* dk, void* db,
                            void* p_dk, void* p_db, int B, int H, int W, int C, int F, int K,
                            int ms, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxTaps || ms < 1 || ms % kBK) return cudaErrorInvalidValue;
  TapBwdArgs a;
  a.feat = feat;
  a.y = static_cast<const float*>(y);
  a.kern = kern;
  a.dout = dout;
  a.dfeat = dfeat;
  a.dy = static_cast<float*>(dy);
  a.dk = static_cast<float*>(dk);
  a.db = static_cast<float*>(db);
  a.p_dk = static_cast<float*>(p_dk);
  a.p_db = static_cast<float*>(p_db);
  a.halo = 0;
  for (int j = 0; j < K; ++j) {
    a.shifts[j] = static_cast<const int*>(shifts)[j];
    a.halo = std::max(a.halo, std::abs(a.shifts[j]));
  }
  a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.K = K; a.ms = ms;
  a.splits = (B * H * W + ms - 1) / ms;
  a.tw = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads and stores: V channels and features at a time, aligned
  const int V = is_bf16 ? 8 : 4;
  const bool vec = C % V == 0 && F % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(kern) |
                     reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dfeat)) &
                    15) == 0;
  if (is_bf16)
    return vec ? dispatch<__nv_bfloat16, true>(a, st) : dispatch<__nv_bfloat16, false>(a, st);
  return vec ? dispatch<float, true>(a, st) : dispatch<float, false>(a, st);
}
