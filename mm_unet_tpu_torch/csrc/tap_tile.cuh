// Shared-memory tiles and warp products of the tap-conv kernels.
//
// A warp computes an (MT*16) x (NT*8) tile of a product in 16-deep steps,
// its sums in the mma.sync m16n8 accumulator layout: lane = 4 g + t holds
// rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 block. A bf16
// stream's steps run on the tensor cores (ldmatrix + mma.sync m16n8k16,
// bf16 x bf16 -> f32); an f32 stream's on the FMA units, the same layout
// read with scalar loads (TF32 would break its limits).
//
// Tiles are row-major with 16, 32 or 64 columns. A bf16 tile XOR-swizzles
// its 16-byte chunks so that ldmatrix's eight row reads of a phase, and the
// 16-byte stores of a row, fall in distinct banks; an f32 tile pads each row
// by 4 floats instead.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace mmu {

template <typename T> __host__ __device__ constexpr int tile_stride(int cols) {
  return std::is_same<T, float>::value ? cols + 4 : cols;
}

template <typename T> __host__ __device__ constexpr int tile_elems(int rows, int cols) {
  return rows * tile_stride<T>(cols);
}

template <typename T> __device__ __forceinline__ int tile_idx(int row, int col, int cols) {
  if constexpr (std::is_same<T, float>::value) {
    return row * (cols + 4) + col;
  } else {
    const int cpr = cols >> 3;  // 16-byte chunks per row: 2, 4 or 8
    const int sw = cpr >= 8 ? (row & 7) : ((row / (8 / cpr)) & (cpr - 1));
    return row * cols + ((((col >> 3) ^ sw)) << 3) + (col & 7);
  }
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p, bool trans) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep step (k0 .. k0 + 15) of a warp's tile at rows m0.., columns
// n0..: A(m, k) is As[m][k], or As[k][m] when A_KM; B(k, n) is Bs[k][n]
// when B_KN, else Bs[n][k]. NT is even. bf16 tiles take the tensor cores,
// f32 tiles the FMA units.
template <typename T, int MT, int NT, bool A_KM, bool B_KN>
__device__ __forceinline__ void warp_mma_step(float (&acc)[MT][NT][4], const T* As, int a_cols,
                                              const T* Bs, int b_cols, int m0, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int kk = 0; kk < 16; ++kk) {
      const int k = k0 + kk;
      float av[MT][2], bv[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + mt * 16 + g;
        av[mt][0] = A_KM ? As[tile_idx<T>(k, m, a_cols)] : As[tile_idx<T>(m, k, a_cols)];
        av[mt][1] = A_KM ? As[tile_idx<T>(k, m + 8, a_cols)] : As[tile_idx<T>(m + 8, k, a_cols)];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + nt * 8 + 2 * t;
        bv[nt][0] = B_KN ? Bs[tile_idx<T>(k, n, b_cols)] : Bs[tile_idx<T>(n, k, b_cols)];
        bv[nt][1] = B_KN ? Bs[tile_idx<T>(k, n + 1, b_cols)] : Bs[tile_idx<T>(n + 1, k, b_cols)];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[mt][nt][0] = fmaf(av[mt][0], bv[nt][0], acc[mt][nt][0]);
          acc[mt][nt][1] = fmaf(av[mt][0], bv[nt][1], acc[mt][nt][1]);
          acc[mt][nt][2] = fmaf(av[mt][1], bv[nt][0], acc[mt][nt][2]);
          acc[mt][nt][3] = fmaf(av[mt][1], bv[nt][1], acc[mt][nt][3]);
        }
    }
  } else {
    // ldmatrix: lane l gives the row address of row l & 7 of 8x8 matrix l >> 3
    const int q = lane >> 3, r8 = lane & 7;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (A_KM)  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        ldsm_x4(a[mt], As + tile_idx<T>(k0 + r8 + (q >> 1) * 8, m0 + mt * 16 + (q & 1) * 8, a_cols),
                true);
      else
        ldsm_x4(a[mt], As + tile_idx<T>(m0 + mt * 16 + (lane & 15), k0 + (lane >> 4) * 8, a_cols),
                false);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];  // b0, b1 of column block 2 np, then of 2 np + 1
      if (B_KN)
        ldsm_x4(b, Bs + tile_idx<T>(k0 + r8 + (q & 1) * 8, n0 + np * 16 + (q >> 1) * 8, b_cols),
                true);
      else
        ldsm_x4(b, Bs + tile_idx<T>(n0 + np * 16 + r8 + (q >> 1) * 8, k0 + (q & 1) * 8, b_cols),
                false);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// V = 16 / sizeof(T) stream-dtype values <-> f32
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16 lo = __float2bfloat16(f[2 * i]), hi = __float2bfloat16(f[2 * i + 1]);
      w[i] = (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// the lerp of V channels of two source rows, rounded to the stream dtype
template <typename T>
__device__ __forceinline__ uint4 lerp16(const uint4& lo, const uint4& hi, float frac) {
  constexpr int V = Vec16<T>::V;
  float l[V], h[V];
  Vec16<T>::unpack(lo, l);
  Vec16<T>::unpack(hi, h);
#pragma unroll
  for (int e = 0; e < V; ++e) l[e] = l[e] * (1.f - frac) + h[e] * frac;
  return Vec16<T>::pack(l);
}

}  // namespace mmu
