// rwkv6.cuh — building blocks shared by the RWKV6 scan's forward
// (rwkv6_scan.cu) and backward (rwkv6_scan_bwd.cu): the 64-row chunk tile,
// its loads, the column cumulative sum of the decays and the 3 × TF32
// tensor-core products (mma.sync m16n8k8 with f32 accumulation), with
// operands read from shared memory by strides or formed by a functor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kN = 64;            // tokens of a (padded) chunk, and padded hd
constexpr int kRow = 68;          // row stride of arrays read along rows
constexpr int kCol = 72;          // row stride of arrays read down columns
constexpr int kC = 65;            // row stride of the cumulative decays read across rows
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

// ------------------------------------------------------- 3 × TF32 products

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A·B in about f32 precision: the small products first. B_EXACT
// (A_EXACT): b (a) is exact in TF32 (a bf16 input), so its lo half is 0 and
// the product with it is skipped.
template <bool B_EXACT = false, bool A_EXACT = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  if (!A_EXACT) mma_tf32(c, al, bh);
  if (!B_EXACT) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4): A (16 × 8, rows m):
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B (8 × 8, k × n): (q, g),
// (q + 4, g); C (16 × 8): (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).

// ---------------------------------------------------------- chunk loading

// Rows [t0, t0 + n) of an (S, hd) slice (sequence stride ss) as a 64 × 64
// f32 tile, zero past n rows and hd columns, in two steps: fetch() issues
// every global load of the tile into registers, put() converts and stores
// into shared memory. VEC (hd = 64, 16-byte aligned rows): 16-byte loads,
// and a block fetches all its tiles before it puts the first, so their
// loads are in flight together; otherwise one element a load, tile by tile.
template <typename T, bool VEC>
struct Tile {
  static constexpr int PER = VEC ? 16 / sizeof(T) : 1;   // elements a load
  static constexpr int ITERS = kN * kN / PER / kThreads;
  using Reg = typename std::conditional<VEC, uint4, float>::type;
  Reg buf[ITERS];

  __device__ __forceinline__ void fetch(const T* __restrict__ src, long long ss, int t0, int n,
                                        int hd) {
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int i = threadIdx.x + j * kThreads, t = i / (kN / PER), c = (i % (kN / PER)) * PER;
      if constexpr (VEC)
        buf[j] = t < n ? *reinterpret_cast<const uint4*>(src + (long long)(t0 + t) * ss + c)
                       : make_uint4(0u, 0u, 0u, 0u);
      else
        buf[j] = (t < n && c < hd) ? to_f32(src[(long long)(t0 + t) * ss + c]) : 0.f;
    }
  }

  // into shared memory in the input's own type (row stride ld, 16-byte
  // aligned rows where VEC)
  __device__ __forceinline__ void put_raw(T* dst, int ld) const {
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int i = threadIdx.x + j * kThreads, t = i / (kN / PER), c = (i % (kN / PER)) * PER;
      if constexpr (VEC) *reinterpret_cast<uint4*>(dst + t * ld + c) = buf[j];
      else dst[t * ld + c] = from_f32<T>(buf[j]);
    }
  }

  __device__ __forceinline__ void put(float* dst, int ld, float mul = 1.f) const {
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int i = threadIdx.x + j * kThreads, t = i / (kN / PER), c = (i % (kN / PER)) * PER;
      if constexpr (VEC) {
        const T* e = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
        for (int x = 0; x < PER; ++x) dst[t * ld + c + x] = mul * to_f32(e[x]);
      } else {
        dst[t * ld + c] = mul * buf[j];
      }
    }
  }
};

// in-place inclusive sum down each column of the 64 × 64 tile sC (row
// stride ld), one thread a column; every thread of the block calls it
template <int LD>
__device__ __forceinline__ void column_cumsum(float* sC) {
  if (threadIdx.x < kN) {
    float c = 0.f;
    for (int t0 = 0; t0 < kN; t0 += 16) {  // 16 loads in flight, then the sums
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = sC[(t0 + i) * LD + threadIdx.x];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        c += x[i];
        sC[(t0 + i) * LD + threadIdx.x] = c;
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------ a warp's 16 × 32 product

// acc[j] += Σ_{k < 64} A(m, k)·B(k, n) over the warp's tile: rows m0 + g and
// m0 + g + 8, columns n0 + 8j + 2q and n0 + 8j + 2q + 1 (acc[j][2r + c] is
// row m0 + g + 8r, column n0 + 8j + 2q + c), with A(m, k) = A[m·am + k·ak]
// and B(k, n) = B[k·bk + n·bn] in shared memory: any transpose is a choice
// of strides.
template <bool B_EXACT = false>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const float* A, int am, int ak,
                                         const float* B, int bk, int bn, int m0, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kN; k0 += 8) {
    const float a[4] = {A[(m0 + g) * am + (k0 + q) * ak], A[(m0 + g + 8) * am + (k0 + q) * ak],
                        A[(m0 + g) * am + (k0 + q + 4) * ak],
                        A[(m0 + g + 8) * am + (k0 + q + 4) * ak]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 8 * j + g;
      const float b[2] = {B[(k0 + q) * bk + n * bn], B[(k0 + q + 4) * bk + n * bn]};
      mma_3xtf32<B_EXACT>(acc[j], a, b);
    }
  }
}

// acc[j] += Σ_{k0 <= k < k1} A(m, k)·B(k, n) over the warp's 16 × 8·NT
// tile, in the layout of warp_mma (rows m0 + g, m0 + g + 8; columns n0 + 8j
// + 2q, + 1), with the operands given by functors a(m, k) and b(k, n): any
// layout, type or scale is the functor's (k1 − k0 a multiple of 8). The A
// fragment of a k-step is formed once for the NT column tiles. Unrolled by
// two only, unlike warp_mma: formed operands take registers that a block
// of RWKV6's backward, two to an SM, does not have.
template <int NT, bool A_EXACT, bool B_EXACT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma_fn(float (&acc)[NT][4], const FA& a, const FB& b, int m0,
                                            int n0, int k0, int k1) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 8) {
    const float af[4] = {a(m0 + g, kk + q), a(m0 + g + 8, kk + q), a(m0 + g, kk + q + 4),
                         a(m0 + g + 8, kk + q + 4)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      const float bf[2] = {b(kk + q, n), b(kk + q + 4, n)};
      mma_3xtf32<B_EXACT, A_EXACT>(acc[j], af, bf);
    }
  }
}

}  // namespace
