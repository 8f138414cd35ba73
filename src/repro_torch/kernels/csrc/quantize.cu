// quantize.cu — the compressed uplink's per-row kernels on Hopper (sm_90a):
// stochastic-rounding quantize, dequantize and the top-k threshold mask,
// each with one scale (or threshold) per row of a stacked (R, N) leaf —
// one row per ONU θ or per client δ.
//
//   quantize_rows    q[r, n] = clip(rint(x[r, n] / s[r] + (u[r, n] − ½)), ±qmax)
//   dequantize_rows  x̂[r, n] = (float(q[r, n]) · s[r]) · m[r]
//   topk_mask_rows   y[r, n] = (|x[r, n]| ≥ t[r] ? x[r, n] : 0) · m[r]
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py::
// quantize_intb (quantize_int8 / quantize_int4), ::dequantize_int8 (also
// dequantize_int4) and ::topk_mask, which take one scale or threshold per
// vector; the row form is what src/repro/core/compression.py's
// quantize_rows / dequantize_rows / topk_rows compute. The scales
// (max(max|x|, 1e-12) / qmax) and thresholds (the k-th largest |x|) are
// computed outside, as the TPU wrappers compute them in jnp outside the
// kernel; the row mask m (0 = the row transmits nothing) is optional.
//
// Bit-exact with the reference given the same noise u:
//   - x / s is an IEEE round-to-nearest division (__fdiv_rn), never a
//     multiply by 1/s; the library is built without --use_fast_math, so
//     -prec-div=true and -ftz=false hold as well;
//   - rintf rounds half to even, as jnp.round does (roundf would not);
//   - every product and sum is an explicit _rn intrinsic, so no FMA
//     contraction changes a rounding.
//
// Bound: bytes. Each element is read once and written once with a few
// flops: quantize moves R·N·(sizeof(x) + 4 + 1) bytes, dequantize R·N·5,
// the top-k mask R·N·(sizeof(x) + 4). At the SFL θ of the full-width CNN's
// fc1_w leaf (R = 16 ONUs, N = 6,422,528, f32) that is 925, 514 and 822 MB:
// 0.276, 0.153 and 0.245 ms at 3.35 TB/s.
//
// Design: a 2-D grid, blockIdx.y = row, so a row's scale, threshold and
// mask are one uniform load per thread; each thread owns four neighbouring
// columns: 16-byte loads of x and u, a 4-byte store of q (or a 16-byte
// store of x̂). A scalar variant takes an N that is not a multiple of four
// or a misaligned base pointer.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise and allocates nothing; it returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 1 << 16;   // grid-stride beyond this

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

__device__ __forceinline__ signed char quant1(float x, float u, float s, float qmax) {
  const float y = __fadd_rn(__fdiv_rn(x, s), __fsub_rn(u, 0.5f));
  return static_cast<signed char>(fminf(fmaxf(rintf(y), -qmax), qmax));
}

__device__ __forceinline__ float dequant1(signed char q, float s, float m) {
  return __fmul_rn(__fmul_rn(static_cast<float>(q), s), m);
}

__device__ __forceinline__ float keep1(float x, float t, float m) {
  return __fmul_rn(fabsf(x) >= t ? x : 0.0f, m);
}

__device__ __forceinline__ float row_mask(const float* mask, int64_t r) {
  return mask == nullptr ? 1.0f : mask[r];
}

// ---- quantize -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_vec4(
    const T* __restrict__ x, const float* __restrict__ noise,
    const float* __restrict__ scales, float qmax, int64_t N,
    signed char* __restrict__ q) {
  const int64_t r = blockIdx.y;
  const float s = scales[r];
  const int64_t base = r * N;
  const int64_t n_vec = N / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const int64_t i = base + v * 4;
    const float4 xv = load4(x + i);
    const float4 uv = *reinterpret_cast<const float4*>(noise + i);
    char4 out;
    out.x = quant1(xv.x, uv.x, s, qmax);
    out.y = quant1(xv.y, uv.y, s, qmax);
    out.z = quant1(xv.z, uv.z, s, qmax);
    out.w = quant1(xv.w, uv.w, s, qmax);
    *reinterpret_cast<char4*>(q + i) = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_scalar(
    const T* __restrict__ x, const float* __restrict__ noise,
    const float* __restrict__ scales, float qmax, int64_t N,
    signed char* __restrict__ q) {
  const int64_t r = blockIdx.y;
  const float s = scales[r];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int64_t i = r * N + n;
    q[i] = quant1(load1(x + i), noise[i], s, qmax);
  }
}

// ---- dequantize -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads) dequantize_vec4(
    const signed char* __restrict__ q, const float* __restrict__ scales,
    const float* __restrict__ mask, int64_t N, float* __restrict__ out) {
  const int64_t r = blockIdx.y;
  const float s = scales[r];
  const float m = row_mask(mask, r);
  const int64_t n_vec = N / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const int64_t i = r * N + v * 4;
    const char4 qv = *reinterpret_cast<const char4*>(q + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(dequant1(qv.x, s, m), dequant1(qv.y, s, m),
                    dequant1(qv.z, s, m), dequant1(qv.w, s, m));
  }
}

__global__ void __launch_bounds__(kThreads) dequantize_scalar(
    const signed char* __restrict__ q, const float* __restrict__ scales,
    const float* __restrict__ mask, int64_t N, float* __restrict__ out) {
  const int64_t r = blockIdx.y;
  const float s = scales[r];
  const float m = row_mask(mask, r);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int64_t i = r * N + n;
    out[i] = dequant1(q[i], s, m);
  }
}

// ---- top-k threshold mask -------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) topk_mask_vec4(
    const T* __restrict__ x, const float* __restrict__ thresh,
    const float* __restrict__ mask, int64_t N, float* __restrict__ out) {
  const int64_t r = blockIdx.y;
  const float t = thresh[r];
  const float m = row_mask(mask, r);
  const int64_t n_vec = N / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const int64_t i = r * N + v * 4;
    const float4 xv = load4(x + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(keep1(xv.x, t, m), keep1(xv.y, t, m),
                    keep1(xv.z, t, m), keep1(xv.w, t, m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) topk_mask_scalar(
    const T* __restrict__ x, const float* __restrict__ thresh,
    const float* __restrict__ mask, int64_t N, float* __restrict__ out) {
  const int64_t r = blockIdx.y;
  const float t = thresh[r];
  const float m = row_mask(mask, r);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int64_t i = r * N + n;
    out[i] = keep1(load1(x + i), t, m);
  }
}

// ---- launch helpers -------------------------------------------------------

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

dim3 grid_for(int R, int64_t items) {
  int64_t bx = (items + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(R));
}

template <typename T>
int launch_quantize(const void* x, const void* noise, const void* scales, float qmax,
                    int R, int64_t N, void* q, void* stream) {
  const bool vec = N % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(noise, 16) &&
                   aligned(q, 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* up = static_cast<const float*>(noise);
  const float* sp = static_cast<const float*>(scales);
  signed char* qp = static_cast<signed char*>(q);
  if (vec) {
    quantize_vec4<T><<<grid_for(R, N / 4), kThreads, 0, s>>>(xp, up, sp, qmax, N, qp);
  } else {
    quantize_scalar<T><<<grid_for(R, N), kThreads, 0, s>>>(xp, up, sp, qmax, N, qp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_topk(const void* x, const void* thresh, const void* mask, int R, int64_t N,
                void* out, void* stream) {
  const bool vec = N % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(out, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* tp = static_cast<const float*>(thresh);
  const float* mp = static_cast<const float*>(mask);
  float* op = static_cast<float*>(out);
  if (vec) {
    topk_mask_vec4<T><<<grid_for(R, N / 4), kThreads, 0, s>>>(xp, tp, mp, N, op);
  } else {
    topk_mask_scalar<T><<<grid_for(R, N), kThreads, 0, s>>>(xp, tp, mp, N, op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (R, N) row-major f32 or bf16; noise: (R, N) f32 in [0, 1); scales:
// (R,) f32; q: (R, N) int8. R <= 65535 (grid y). Returns a cudaError_t.
extern "C" int quantize_rows_f32(const void* x, const void* noise, const void* scales,
                                 float qmax, int R, long long N, void* q, void* stream) {
  return launch_quantize<float>(x, noise, scales, qmax, R, N, q, stream);
}

extern "C" int quantize_rows_bf16(const void* x, const void* noise, const void* scales,
                                  float qmax, int R, long long N, void* q, void* stream) {
  return launch_quantize<__nv_bfloat16>(x, noise, scales, qmax, R, N, q, stream);
}

// q: (R, N) int8; scales: (R,) f32; mask: (R,) f32 or NULL; out: (R, N) f32.
extern "C" int dequantize_rows_i8(const void* q, const void* scales, const void* mask,
                                  int R, long long N, void* out, void* stream) {
  const bool vec = N % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const signed char* qp = static_cast<const signed char*>(q);
  const float* sp = static_cast<const float*>(scales);
  const float* mp = static_cast<const float*>(mask);
  float* op = static_cast<float*>(out);
  if (vec) {
    dequantize_vec4<<<grid_for(R, N / 4), kThreads, 0, s>>>(qp, sp, mp, N, op);
  } else {
    dequantize_scalar<<<grid_for(R, N), kThreads, 0, s>>>(qp, sp, mp, N, op);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (R, N) f32 or bf16; thresh: (R,) f32; mask: (R,) f32 or NULL;
// out: (R, N) f32.
extern "C" int topk_mask_rows_f32(const void* x, const void* thresh, const void* mask,
                                  int R, long long N, void* out, void* stream) {
  return launch_topk<float>(x, thresh, mask, R, N, out, stream);
}

extern "C" int topk_mask_rows_bf16(const void* x, const void* thresh, const void* mask,
                                   int R, long long N, void* out, void* stream) {
  return launch_topk<__nv_bfloat16>(x, thresh, mask, R, N, out, stream);
}
