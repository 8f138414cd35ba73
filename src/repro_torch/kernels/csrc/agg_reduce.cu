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
// 3.7 GB, 1.1 ms at 3.35 TB/s.
//
// Design: one thread owns four neighbouring columns (one float4, or four
// bf16 in 8 bytes) and walks the segments in order, summing each
// segment's rows in stable row order in f32 registers. So every load is
// coalesced, x is read once, θ is written once, and the sum order is fixed:
// no atomics, deterministic results. The rows of a segment come as a CSR
// (a stable row permutation plus segment offsets) built by the host
// wrapper; each block stages the permuted weights, row ids and offsets in
// shared memory first. A scalar variant handles an N that is not a
// multiple of four, or a misaligned base pointer.
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
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;   // grid-stride beyond this

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);   // 4 × bf16
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Shared-memory CSR: w_s[r] = wm[rows[r]], rows_s[r] = rows[r], offs_s[s];
// with kAmax also the block's running max|θ| of each segment, as bits.
struct SegmentTable {
  float* w;
  int* rows;
  int* offs;
  unsigned* amax;
};

template <bool kAmax>
__device__ __forceinline__ SegmentTable stage_table(
    const float* __restrict__ wm, const int* __restrict__ rows,
    const int* __restrict__ offsets, int C, int n_seg) {
  extern __shared__ unsigned char smem_raw[];
  SegmentTable t;
  t.w = reinterpret_cast<float*>(smem_raw);
  t.rows = reinterpret_cast<int*>(t.w + C);
  t.offs = t.rows + C;
  t.amax = reinterpret_cast<unsigned*>(t.offs + n_seg + 1);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const int c = rows[i];
    t.rows[i] = c;
    t.w[i] = wm[c];
  }
  for (int i = threadIdx.x; i <= n_seg; i += blockDim.x) t.offs[i] = offsets[i];
  if (kAmax) {
    for (int i = threadIdx.x; i < n_seg; i += blockDim.x) t.amax[i] = 0u;   // +0.0f
  }
  __syncthreads();
  return t;
}

// Fold one thread's max|θ| of segment s into the block's maximum. Every
// lane of the warp calls it (the column loops are block-uniform).
__device__ __forceinline__ void fold_amax(unsigned* amax, int s, float m) {
  const unsigned w = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  if ((threadIdx.x & 31) == 0) atomicMax(amax + s, w);
}

__device__ __forceinline__ void write_amax(const SegmentTable& t, int n_seg,
                                           float* __restrict__ amax) {
  __syncthreads();
  for (int i = threadIdx.x; i < n_seg; i += blockDim.x) {
    amax[static_cast<int64_t>(i) * gridDim.x + blockIdx.x] = __uint_as_float(t.amax[i]);
  }
}

// The column loops step the whole block together (v0 is block-uniform), so
// every lane reaches fold_amax; a thread past the end sums nothing.
template <typename T, bool kAmax>
__global__ void __launch_bounds__(kThreads) segment_agg_vec4(
    const T* __restrict__ x, const float* __restrict__ wm,
    const int* __restrict__ rows, const int* __restrict__ offsets,
    int C, int n_seg, int64_t N, float* __restrict__ out, float* __restrict__ amax) {
  const SegmentTable t = stage_table<kAmax>(wm, rows, offsets, C, n_seg);
  const int64_t n_vec = N / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v0 = static_cast<int64_t>(blockIdx.x) * blockDim.x; v0 < n_vec;
       v0 += stride) {
    const int64_t v = v0 + threadIdx.x;
    const bool live = v < n_vec;
    const int64_t n = v * 4;
    for (int s = 0; s < n_seg; ++s) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        const int r_end = t.offs[s + 1];
#pragma unroll 4
        for (int r = t.offs[s]; r < r_end; ++r) {
          const float w = t.w[r];
          const float4 xv = load4(x + static_cast<int64_t>(t.rows[r]) * N + n);
          acc.x = fmaf(w, xv.x, acc.x);
          acc.y = fmaf(w, xv.y, acc.y);
          acc.z = fmaf(w, xv.z, acc.z);
          acc.w = fmaf(w, xv.w, acc.w);
        }
        *reinterpret_cast<float4*>(out + static_cast<int64_t>(s) * N + n) = acc;
      }
      if (kAmax) {
        fold_amax(t.amax, s, fmaxf(fmaxf(fabsf(acc.x), fabsf(acc.y)),
                                   fmaxf(fabsf(acc.z), fabsf(acc.w))));
      }
    }
  }
  if (kAmax) write_amax(t, n_seg, amax);
}

template <typename T, bool kAmax>
__global__ void __launch_bounds__(kThreads) segment_agg_scalar(
    const T* __restrict__ x, const float* __restrict__ wm,
    const int* __restrict__ rows, const int* __restrict__ offsets,
    int C, int n_seg, int64_t N, float* __restrict__ out, float* __restrict__ amax) {
  const SegmentTable t = stage_table<kAmax>(wm, rows, offsets, C, n_seg);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n0 = static_cast<int64_t>(blockIdx.x) * blockDim.x; n0 < N; n0 += stride) {
    const int64_t n = n0 + threadIdx.x;
    const bool live = n < N;
    for (int s = 0; s < n_seg; ++s) {
      float acc = 0.f;
      if (live) {
        const int r_end = t.offs[s + 1];
#pragma unroll 4
        for (int r = t.offs[s]; r < r_end; ++r) {
          acc = fmaf(t.w[r], load1(x + static_cast<int64_t>(t.rows[r]) * N + n), acc);
        }
        out[static_cast<int64_t>(s) * N + n] = acc;
      }
      if (kAmax) fold_amax(t.amax, s, fabsf(acc));
    }
  }
  if (kAmax) write_amax(t, n_seg, amax);
}

// n_blocks > 0 fixes the grid (the fused form sizes amax by it); 0 sizes
// it to the columns, capped at kMaxBlocks.
template <typename T, bool kAmax>
int launch(const void* x, const void* wm, const void* rows, const void* offsets,
           int C, int n_seg, int64_t N, void* out, void* amax, int n_blocks,
           void* stream) {
  const size_t smem = static_cast<size_t>(C) * (sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(n_seg + 1) * sizeof(int) +
                      (kAmax ? static_cast<size_t>(n_seg) * sizeof(unsigned) : 0);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool vec = aligned && (N % 4 == 0);
  const int64_t items = vec ? N / 4 : N;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (n_blocks > 0) blocks = n_blocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(wm);
  const int* rp = static_cast<const int*>(rows);
  const int* op = static_cast<const int*>(offsets);
  float* outp = static_cast<float*>(out);
  float* ap = static_cast<float*>(amax);
  auto kernel = vec ? segment_agg_vec4<T, kAmax> : segment_agg_scalar<T, kAmax>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      xp, wp, rp, op, C, n_seg, N, outp, ap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (C, N) row-major; wm: (C,) f32; rows: (C,) int32 stable permutation of
// the rows grouped by segment; offsets: (n_seg + 1,) int32 CSR offsets into
// rows; out: (n_seg, N) f32. Returns a cudaError_t (0 = launched).
extern "C" int segment_agg_reduce_f32(const void* x, const void* wm, const void* rows,
                                      const void* offsets, int C, int n_seg,
                                      long long N, void* out, void* stream) {
  return launch<float, false>(x, wm, rows, offsets, C, n_seg, N, out, nullptr, 0, stream);
}

extern "C" int segment_agg_reduce_bf16(const void* x, const void* wm, const void* rows,
                                       const void* offsets, int C, int n_seg,
                                       long long N, void* out, void* stream) {
  return launch<__nv_bfloat16, false>(x, wm, rows, offsets, C, n_seg, N, out, nullptr, 0,
                                      stream);
}

// Pass A of the fused aggregate + quantize: as above, plus amax: (n_seg,
// n_blocks) f32, the max|θ| of each segment over each block's columns;
// the grid is exactly n_blocks (>= 1) blocks.
extern "C" int segment_agg_reduce_absmax_f32(const void* x, const void* wm,
                                             const void* rows, const void* offsets,
                                             int C, int n_seg, long long N, void* out,
                                             void* amax, int n_blocks, void* stream) {
  return launch<float, true>(x, wm, rows, offsets, C, n_seg, N, out, amax, n_blocks, stream);
}

extern "C" int segment_agg_reduce_absmax_bf16(const void* x, const void* wm,
                                              const void* rows, const void* offsets,
                                              int C, int n_seg, long long N, void* out,
                                              void* amax, int n_blocks, void* stream) {
  return launch<__nv_bfloat16, true>(x, wm, rows, offsets, C, n_seg, N, out, amax,
                                     n_blocks, stream);
}
