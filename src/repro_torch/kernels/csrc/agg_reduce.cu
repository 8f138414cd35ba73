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

// Shared-memory CSR: w_s[r] = wm[rows[r]], rows_s[r] = rows[r], offs_s[s].
struct SegmentTable {
  float* w;
  int* rows;
  int* offs;
};

__device__ __forceinline__ SegmentTable stage_table(
    const float* __restrict__ wm, const int* __restrict__ rows,
    const int* __restrict__ offsets, int C, int n_seg) {
  extern __shared__ unsigned char smem_raw[];
  SegmentTable t;
  t.w = reinterpret_cast<float*>(smem_raw);
  t.rows = reinterpret_cast<int*>(t.w + C);
  t.offs = t.rows + C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const int c = rows[i];
    t.rows[i] = c;
    t.w[i] = wm[c];
  }
  for (int i = threadIdx.x; i <= n_seg; i += blockDim.x) t.offs[i] = offsets[i];
  __syncthreads();
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) segment_agg_vec4(
    const T* __restrict__ x, const float* __restrict__ wm,
    const int* __restrict__ rows, const int* __restrict__ offsets,
    int C, int n_seg, int64_t N, float* __restrict__ out) {
  const SegmentTable t = stage_table(wm, rows, offsets, C, n_seg);
  const int64_t n_vec = N / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const int64_t n = v * 4;
    for (int s = 0; s < n_seg; ++s) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
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
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) segment_agg_scalar(
    const T* __restrict__ x, const float* __restrict__ wm,
    const int* __restrict__ rows, const int* __restrict__ offsets,
    int C, int n_seg, int64_t N, float* __restrict__ out) {
  const SegmentTable t = stage_table(wm, rows, offsets, C, n_seg);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    for (int s = 0; s < n_seg; ++s) {
      float acc = 0.f;
      const int r_end = t.offs[s + 1];
#pragma unroll 4
      for (int r = t.offs[s]; r < r_end; ++r) {
        acc = fmaf(t.w[r], load1(x + static_cast<int64_t>(t.rows[r]) * N + n), acc);
      }
      out[static_cast<int64_t>(s) * N + n] = acc;
    }
  }
}

template <typename T>
int launch(const void* x, const void* wm, const void* rows, const void* offsets,
           int C, int n_seg, int64_t N, void* out, void* stream) {
  const size_t smem = static_cast<size_t>(C) * (sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(n_seg + 1) * sizeof(int);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool vec = aligned && (N % 4 == 0);
  const int64_t items = vec ? N / 4 : N;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(wm);
  const int* rp = static_cast<const int*>(rows);
  const int* op = static_cast<const int*>(offsets);
  float* outp = static_cast<float*>(out);
  if (vec) {
    segment_agg_vec4<T><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        xp, wp, rp, op, C, n_seg, N, outp);
  } else {
    segment_agg_scalar<T><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        xp, wp, rp, op, C, n_seg, N, outp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (C, N) row-major; wm: (C,) f32; rows: (C,) int32 stable permutation of
// the rows grouped by segment; offsets: (n_seg + 1,) int32 CSR offsets into
// rows; out: (n_seg, N) f32. Returns a cudaError_t (0 = launched).
extern "C" int segment_agg_reduce_f32(const void* x, const void* wm, const void* rows,
                                      const void* offsets, int C, int n_seg,
                                      long long N, void* out, void* stream) {
  return launch<float>(x, wm, rows, offsets, C, n_seg, N, out, stream);
}

extern "C" int segment_agg_reduce_bf16(const void* x, const void* wm, const void* rows,
                                       const void* offsets, int C, int n_seg,
                                       long long N, void* out, void* stream) {
  return launch<__nv_bfloat16>(x, wm, rows, offsets, C, n_seg, N, out, stream);
}
