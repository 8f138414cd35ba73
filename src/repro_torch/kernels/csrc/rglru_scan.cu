// rglru_scan.cu — the RG-LRU linear recurrence on Hopper (sm_90a).
//
//     h_t = a_t · h_{t-1} + b_t        (elementwise over channels), h_{-1} = h0
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan:
// the same function, returning every h_t and the last one. The model's
// prefill scan and its one-token decode update (the scan at S = 1 from the
// carried state) both run through it.
//
// Bound: bytes. Each step reads a_t and b_t and writes h_t, two flops per
// 12 bytes. At recurrentgemma-9b's prefill (B = 4, S = 4096, C = 4096, f32)
// that is 805 MB per call, 0.24 ms at 3.35 TB/s.
//
// Design: one thread owns four neighbouring channels of one batch row
// (16-byte loads and stores) and walks time in order with the state in
// registers — the TPU's sequential grid axis becomes the loop, the
// channel-parallel vector ops become threads. The recurrence is a chain of
// dependent multiply-adds (unfused, two roundings each, as the plain
// version computes them, so the two agree bit for bit), but the loads of
// later steps are not: each thread loads kUnroll steps of a and b ahead
// before it runs them, so many loads are in flight per thread. Blocks are one warp each, so B·C/128 blocks spread
// over the SMs (128 blocks at the prefill shape). A scalar variant takes a
// C that is not a multiple of four or a misaligned pointer.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 8;

// a·h + b with two roundings and no FMA contraction, as the plain version
// computes it, so the two agree bit for bit
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ float4 step4(float4 a, float4 h, float4 b) {
  return make_float4(step(a.x, h.x, b.x), step(a.y, h.y, b.y), step(a.z, h.z, b.z),
                     step(a.w, h.w, b.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(kThreads)
rglru_vec4(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ h0, float* __restrict__ out, float* __restrict__ hlast,
           int B, int S, int C) {
  const int C4 = C / 4;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)B * C4) return;
  const int bi = static_cast<int>(g / C4), c = static_cast<int>(g % C4) * 4;
  float4 h = h0 ? ld4(h0 + (long long)bi * C + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  const long long base = (long long)bi * S * C + c;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float4 av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ld4(a + base + (long long)(t + u) * C);
      bv[u] = ld4(b + base + (long long)(t + u) * C);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = step4(av[u], h, bv[u]);
      *reinterpret_cast<float4*>(out + base + (long long)(t + u) * C) = h;
    }
  }
  for (; t < S; ++t) {
    h = step4(ld4(a + base + (long long)t * C), h, ld4(b + base + (long long)t * C));
    *reinterpret_cast<float4*>(out + base + (long long)t * C) = h;
  }
  *reinterpret_cast<float4*>(hlast + (long long)bi * C + c) = h;
}

__global__ void __launch_bounds__(kThreads)
rglru_scalar(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, float* __restrict__ hlast,
             int B, int S, int C) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)B * C) return;
  const int bi = static_cast<int>(g / C), c = static_cast<int>(g % C);
  float h = h0 ? h0[(long long)bi * C + c] : 0.f;
  const long long base = (long long)bi * S * C + c;
  for (int t = 0; t < S; ++t) {
    const long long i = base + (long long)t * C;
    h = step(a[i], h, b[i]);
    out[i] = h;
  }
  hlast[(long long)bi * C + c] = h;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// a, b, out: (B, S, C) f32 contiguous; h0 (nullable), hlast: (B, C) f32.
extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0, float* out,
                              float* hlast, int B, int S, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  const bool vec = C % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(out) &&
                   aligned16(hlast) && (h0 == nullptr || aligned16(h0));
  const long long threads = (long long)B * (vec ? C / 4 : C);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (vec)
    rglru_vec4<<<blocks, kThreads, 0, st>>>(a, b, h0, out, hlast, B, S, C);
  else
    rglru_scalar<<<blocks, kThreads, 0, st>>>(a, b, h0, out, hlast, B, S, C);
  return static_cast<int>(cudaGetLastError());
}
