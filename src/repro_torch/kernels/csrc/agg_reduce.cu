// agg_reduce.cu — the ONU aggregation function on Hopper (sm_90a).
//
//     out[s, n] = Σ_{c : seg[c] == s}  wm[c] · x[c, n]        wm = weight · mask
//
// Replaces the Pallas TPU kernel src/repro/kernels/agg_reduce.py::agg_reduce
// (one segment). The segmented form computes every ONU's θ of the paper's
// step 1 in one launch; the classical FedAvg baseline is n_seg = 1.
//
// Bound: bytes. Each x element is read once and used for one FMA, so the
// kernel moves C·N·sizeof(x) + n_seg·N·4 bytes for 2·C·N flops — far below
// the card's flop-per-byte balance. At the full-width round (fc1_w leaf,
// C = 128 clients, N = 6,422,528, n_seg = 16 ONUs, f32) that is about
// 3.7 GB, 1.1 ms at 3.35 TB/s; classical (C = 16, one segment) 0.44 GB,
// 0.13 ms.
//
// Design: one thread owns four neighbouring columns (one float4, or four
// bf16 in 8 bytes) and walks the segments in order, summing each
// segment's rows in stable row order in f32 registers. So every load is
// coalesced, x is read once, θ is written once, and the sum order is fixed:
// no atomics, deterministic results. Within a segment a thread issues the
// loads of kBatch = 4 rows before their FMAs (the batch unrolled and
// predicated), then the next 4; the FMAs run in row order, so the sums
// are the same as one row at a time. One block of 256 threads per 1024
// columns, each staging its weights (and, segmented, its CSR) in shared
// memory first; at most 40 registers a thread, so 6 blocks share an SM
// and their warps hide the memory's latency. On the H100, at the fc1_w
// shapes, batches of 8 or 16 rows (up to 64 or 124 registers) and a
// persistent grid (the SMs × the blocks each holds) were no faster or
// slower: fewer warps an SM hide less of that latency.
// One segment needs no CSR: a null table means the identity rows and
// offsets [0, C], so the wrapper builds and copies no table. Segmented
// calls take a CSR (a stable row permutation plus segment offsets) that
// the host wrapper builds and copies to the device. A scalar variant
// handles an N that is not a multiple of four, or a misaligned base
// pointer.
//
// Fused form (pass A of the Pallas agg_reduce_quant, src/repro/kernels/
// agg_reduce.py:85): the same kernel, instantiated with kAmax, also
// records max|θ| of every (segment, block) while θ is still in registers,
// so quantizing θ needs no extra pass over it to find each row's scale.
// The sums are the same code, so θ equals segment_agg_reduce's bit for
// bit. Each warp reduces its maximum with __reduce_max_sync on the bits of
// |θ| (non-negative floats order as unsigned ints), one lane folds it into
// the block's shared-memory maximum with atomicMax, and the block writes
// its n_seg maxima at the end: amax[s * n_blocks + block]. Pass B is the
// per-row quantize kernel of quantize.cu at max(amax) / qmax. The grid is
// the caller's n_blocks (grid-stride), so amax's size is known up front.
// Extra bytes: n_seg · n_blocks · 4, under 0.5 MB at the fc1_w shape.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on
// the given stream, does not synchronise and allocates nothing; it returns
// a cudaError_t (cudaGetLastError() after the launch) so the wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;    // row loads a thread has in flight before its FMAs
constexpr int64_t kMaxBlocks = 1 << 20;   // grid-stride beyond this

// V neighbouring elements of x as one load (Raw), and as floats
template <typename T, int V>
struct Pack;

template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <>
struct Pack<__nv_bfloat16, 4> {
  using Raw = uint2;   // 4 × bf16
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = __bfloat162float(r);
  }
};

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }

// acc = Σ_{r in [beg, end)} w_s[r] · x[row(r), n .. n + V), in row order:
// each batch issues all its loads, then its FMAs. row(r) = rows_s[r] with
// kRows, else r.
template <typename T, int V, bool kRows>
__device__ __forceinline__ void segment_sum(const T* __restrict__ xn, int64_t N,
                                            const float* w_s, const int* rows_s, int beg,
                                            int end, float (&acc)[V]) {
  using P = Pack<T, V>;
  for (int r0 = beg; r0 < end; r0 += kBatch) {
    typename P::Raw raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r0 + u < end) {
        const int row = kRows ? rows_s[r0 + u] : r0 + u;
        raw[u] = P::load(xn + static_cast<int64_t>(row) * N);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r0 + u < end) {
        float v[V];
        P::unpack(raw[u], v);
        const float w = w_s[r0 + u];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(w, v[k], acc[k]);
      }
    }
  }
}

// Fold one thread's max|θ| of segment s into the block's maximum. Every
// lane of the warp calls it (the column loops are block-uniform).
__device__ __forceinline__ void fold_amax(unsigned* amax_s, int s, float m) {
  const unsigned w = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  if ((threadIdx.x & 31) == 0) atomicMax(amax_s + s, w);
}

// csr: the device table (kRows), or null for the identity rows of one
// segment. Shared memory: w_s[C] (wm in row order), offs_s[n_seg + 1],
// with kRows rows_s[C], with kAmax the block's running max|θ| of each
// segment as bits.
// The column loop steps the whole block together (i0 is block-uniform), so
// every lane reaches fold_amax; a thread past the end sums nothing.
template <typename T, int V, bool kRows, bool kAmax>
__global__ void __launch_bounds__(kThreads) segment_agg(
    const T* __restrict__ x, const float* __restrict__ wm, const int* __restrict__ csr,
    int C, int n_seg, int64_t N, float* __restrict__ out, float* __restrict__ amax) {
  extern __shared__ float w_s[];
  int* offs_s = reinterpret_cast<int*>(w_s + C);
  int* rows_s = offs_s + n_seg + 1;
  unsigned* amax_s = reinterpret_cast<unsigned*>(rows_s + (kRows ? C : 0));
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const int c = kRows ? csr[i] : i;
    w_s[i] = wm[c];
    if (kRows) rows_s[i] = c;
  }
  for (int i = threadIdx.x; i <= n_seg; i += kThreads) {
    offs_s[i] = kRows ? csr[C + i] : (i == 0 ? 0 : C);
  }
  if (kAmax) {
    for (int i = threadIdx.x; i < n_seg; i += kThreads) amax_s[i] = 0u;   // +0.0f
  }
  __syncthreads();
  const int64_t items = N / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads; i0 < items; i0 += stride) {
    const int64_t n = (i0 + threadIdx.x) * V;
    const bool live = i0 + threadIdx.x < items;
    for (int s = 0; s < n_seg; ++s) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      if (live) {
        segment_sum<T, V, kRows>(x + n, N, w_s, rows_s, offs_s[s], offs_s[s + 1], acc);
        store(out + static_cast<int64_t>(s) * N + n, acc);
      }
      if (kAmax) {
        float m = 0.f;
#pragma unroll
        for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(acc[k]));
        fold_amax(amax_s, s, m);
      }
    }
  }
  if (kAmax) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_seg; i += kThreads) {
      amax[static_cast<int64_t>(i) * gridDim.x + blockIdx.x] = __uint_as_float(amax_s[i]);
    }
  }
}

template <typename T, bool kAmax>
using Kernel = decltype(&segment_agg<T, 4, true, kAmax>);

// csr == nullptr (one segment) takes the identity rows; n_blocks > 0 fixes
// the grid (the fused form sizes amax by it), 0 sizes it to the columns,
// capped at kMaxBlocks.
template <typename T, bool kAmax>
int launch(const void* x, const void* wm, const void* csr, int C, int n_seg, int64_t N,
           void* out, void* amax, int n_blocks, void* stream) {
  const bool by_rows = csr != nullptr;
  if (!by_rows && n_seg != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(C) * sizeof(float) * (by_rows ? 2 : 1) +
                      static_cast<size_t>(n_seg + 1) * sizeof(int) +
                      (kAmax ? static_cast<size_t>(n_seg) * sizeof(unsigned) : 0);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool vec = aligned && (N % 4 == 0);
  // the four variants share one signature: <T, 4 | 1, rows | identity, kAmax>
  Kernel<T, kAmax> kernel = vec ? (by_rows ? segment_agg<T, 4, true, kAmax>
                                           : segment_agg<T, 4, false, kAmax>)
                                : (by_rows ? segment_agg<T, 1, true, kAmax>
                                           : segment_agg<T, 1, false, kAmax>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t blocks = n_blocks;
  if (blocks <= 0) {
    const int64_t items = vec ? N / 4 : N;
    blocks = (items + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(wm), static_cast<const int*>(csr),
      C, n_seg, N, static_cast<float*>(out), static_cast<float*>(amax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (C, N) row-major; wm: (C,) f32; csr: (C + n_seg + 1,) int32 on the
// device, the stable permutation of the rows grouped by segment then the
// segments' offsets into it, or null for one segment (n_seg = 1, every row
// in order); out: (n_seg, N) f32. Returns a cudaError_t (0 = launched).
extern "C" int segment_agg_reduce_f32(const void* x, const void* wm, const void* csr, int C,
                                      int n_seg, long long N, void* out, void* stream) {
  return launch<float, false>(x, wm, csr, C, n_seg, N, out, nullptr, 0, stream);
}

extern "C" int segment_agg_reduce_bf16(const void* x, const void* wm, const void* csr, int C,
                                       int n_seg, long long N, void* out, void* stream) {
  return launch<__nv_bfloat16, false>(x, wm, csr, C, n_seg, N, out, nullptr, 0, stream);
}

// Pass A of the fused aggregate + quantize: as above, plus amax: (n_seg,
// n_blocks) f32, the max|θ| of each segment over each block's columns;
// the grid is exactly n_blocks (>= 1) blocks.
extern "C" int segment_agg_reduce_absmax_f32(const void* x, const void* wm, const void* csr,
                                             int C, int n_seg, long long N, void* out,
                                             void* amax, int n_blocks, void* stream) {
  return launch<float, true>(x, wm, csr, C, n_seg, N, out, amax, n_blocks, stream);
}

extern "C" int segment_agg_reduce_absmax_bf16(const void* x, const void* wm, const void* csr,
                                              int C, int n_seg, long long N, void* out,
                                              void* amax, int n_blocks, void* stream) {
  return launch<__nv_bfloat16, true>(x, wm, csr, C, n_seg, N, out, amax, n_blocks, stream);
}
