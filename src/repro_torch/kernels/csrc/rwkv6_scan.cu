// rwkv6_scan.cu — the chunked RWKV6 wkv recurrence on Hopper (sm_90a).
//
// Per (batch, head), state S ∈ R^{hd×hd}, decay w_t = exp(logw_t) ≤ 1:
//     o_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t)
//     S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t                S_{-1} = S0 (or 0)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// and with it the chunk loop of the model's rwkv_time_mix (src/repro/models/
// rwkv6.py:90-121, :156-183): the same chunkwise form, chunk by chunk, with
// c = Σ logw (inclusive, within the chunk) and c_excl = c − logw:
//     o_t  = (r_t ⊙ e^{c_excl,t}) · S_in
//          + Σ_{j<t} [Σ_d r_td k_jd e^{min(c_excl,td − c_jd, 0)}] v_j
//          + (r_t · (u ⊙ k_t)) v_t
//     S_out = S_in ⊙ e^{c_W} + Σ_j (k_j ⊙ e^{c_W − c_j}) ⊗ v_j
// Unlike the TPU kernel it takes an initial state (decode carries one) and
// any S: a ragged last chunk is zero-padded (logw = 0, k = 0), which leaves
// c_W and the state as the W' real tokens give them.
//
// Bound: operations, mostly the exponentials of the intra-chunk pair
// matrix (W²·hd/2 per chunk) and three W·hd·hd products per chunk; bytes
// are 4·S·hd inputs and S·hd outputs per (batch, head), far fewer.
//
// Design: one thread block owns a (batch, head) and keeps its hd × hd f32
// state in shared memory across a loop over the chunks — the loop is the
// TPU's sequential chunk axis. Per chunk, the block stages r, k, v and
// logw (converted to f32) in shared memory, one thread per channel forms
// the cumulative sums, and then every thread computes whole output
// elements (o rows, pair-matrix entries, state entries) with the inner
// sums over shared memory; the u-bonus is the diagonal of the pair
// matrix, so o's intra-chunk part is one triangular product. Rows are
// padded to 65 floats so neighbouring threads read different banks. All
// arrays take 133 KB of dynamic shared memory at hd = W = 64, one block per
// SM; the serve shape has B·H = 4·48 = 192 blocks. The cumulative sums are
// kept in base 2 (times log2 e), so every exponential is one exp2f (2 ulp,
// no fast math) in place of expf's range reduction. CUDA-core f32: tensor
// cores are later work.
//
// Layout: r, k, v, logw and o are (B, H, S, hd) with hd contiguous and any
// (batch, head, sequence) strides in elements, so the model's (B, S, H, hd)
// activations go in and out without a copy; u is (H, hd), S0 and S_final
// (B, H, hd, hd), contiguous f32.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMax = 64;          // largest chunk and head_dim
constexpr int kLD = kMax + 1;     // padded row stride
constexpr int kThreads = 256;
constexpr size_t kSmem = sizeof(float) * 8 * kMax * kLD;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Strides {
  long long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ logw, const float* __restrict__ u,
          const float* __restrict__ s0, float* __restrict__ o, float* __restrict__ s_out,
          Strides sr_, Strides sk_, Strides sv_, Strides sw_, Strides so_, int H, int S,
          int hd, int W) {
  extern __shared__ float smem[];
  float* sR = smem;                 // r            W × hd
  float* sK = sR + kMax * kLD;      // k, later k ⊙ e^{c_W − c}
  float* sV = sK + kMax * kLD;      // v
  float* sC = sV + kMax * kLD;      // c · log2 e (c: inclusive Σ log decay)
  float* sE = sC + kMax * kLD;      // logw, then c_excl · log2 e
  float* sD = sE + kMax * kLD;      // r ⊙ e^{c_excl}
  float* sA = sD + kMax * kLD;      // pair matrix W × W, u-bonus on the diagonal
  float* sS = sA + kMax * kLD;      // state hd × hd

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* rb = r + b * sr_.b + h * sr_.h;
  const T* kb = k + b * sk_.b + h * sk_.h;
  const T* vb = v + b * sv_.b + h * sv_.h;
  const float* wb = logw + b * sw_.b + h * sw_.h;
  float* ob = o + b * so_.b + h * so_.h;
  const float* ub = u + (long long)h * hd;
  const long long state = ((long long)b * H + h) * hd * hd;

  for (int i = tid; i < hd * hd; i += kThreads)
    sS[(i / hd) * kLD + i % hd] = s0 ? s0[state + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += W) {
    const int n = min(W, S - t0);   // real tokens in this chunk
    __syncthreads();                // the previous chunk's state update is done
    for (int i = tid; i < W * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const bool real = t < n;
      const long long ts = t0 + t;
      sR[t * kLD + d] = real ? to_f32(rb[ts * sr_.s + d]) : 0.f;
      sK[t * kLD + d] = real ? to_f32(kb[ts * sk_.s + d]) : 0.f;
      sV[t * kLD + d] = real ? to_f32(vb[ts * sv_.s + d]) : 0.f;
      sE[t * kLD + d] = real ? wb[ts * sw_.s + d] : 0.f;
    }
    __syncthreads();
    for (int d = tid; d < hd; d += kThreads) {
      float c = 0.f;
      for (int t = 0; t < W; ++t) {
        const float lw = sE[t * kLD + d];
        c += lw;
        sC[t * kLD + d] = c * kLog2e;
        sE[t * kLD + d] = (c - lw) * kLog2e;
      }
    }
    __syncthreads();
    for (int i = tid; i < W * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      sD[t * kLD + d] = sR[t * kLD + d] * exp2f(sE[t * kLD + d]);
    }
    for (int i = tid; i < W * W; i += kThreads) {
      const int t = i / W, j = i % W;
      float a = 0.f;
      if (j < t) {
        for (int d = 0; d < hd; ++d)
          a += sR[t * kLD + d] * sK[j * kLD + d] *
               exp2f(fminf(sE[t * kLD + d] - sC[j * kLD + d], 0.f));
      } else if (j == t) {
        for (int d = 0; d < hd; ++d) a += sR[t * kLD + d] * (ub[d] * sK[t * kLD + d]);
      }
      sA[t * kLD + j] = a;
    }
    __syncthreads();
    for (int i = tid; i < n * hd; i += kThreads) {
      const int t = i / hd, e = i % hd;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += sD[t * kLD + d] * sS[d * kLD + e];
      for (int j = 0; j <= t; ++j) acc += sA[t * kLD + j] * sV[j * kLD + e];
      ob[(long long)(t0 + t) * so_.s + e] = acc;
    }
    __syncthreads();                // S_in and k are read for the last time
    for (int i = tid; i < W * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      sK[t * kLD + d] *= exp2f(sC[(W - 1) * kLD + d] - sC[t * kLD + d]);
    }
    __syncthreads();
    for (int i = tid; i < hd * hd; i += kThreads) {
      const int d = i / hd, e = i % hd;
      float acc = sS[d * kLD + e] * exp2f(sC[(W - 1) * kLD + d]);
      for (int t = 0; t < W; ++t) acc += sK[t * kLD + d] * sV[t * kLD + e];
      sS[d * kLD + e] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * hd; i += kThreads) s_out[state + i] = sS[(i / hd) * kLD + i % hd];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           const float* s0, float* o, float* s_out, Strides sr, Strides sk, Strides sv,
           Strides sw, Strides so, int B, int H, int S, int hd, int W, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(rwkv6_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_fwd<T><<<dim3(H, B), kThreads, kSmem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u,
      s0, o, s_out, sr, sk, sv, sw, so, H, S, hd, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16; logw, u, s0 (nullable), o
// and s_out are float32. Strides in elements: (batch, head, sequence) of
// r, k, v, logw and o in that order. hd ≤ 64, 1 ≤ W ≤ 64.
extern "C" int rwkv6_scan_fwd(int dtype, const void* r, const void* k, const void* v,
                              const float* logw, const float* u, const float* s0, float* o,
                              float* s_out, long long rb, long long rh, long long rs,
                              long long kb, long long kh, long long ks, long long vb,
                              long long vh, long long vs, long long wb, long long wh,
                              long long ws, long long ob, long long oh, long long os, int B,
                              int H, int S, int hd, int W, void* stream) {
  if (B == 0 || H == 0 || hd == 0) return 0;
  if (hd > kMax || W < 1 || W > kMax) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sr{rb, rh, rs}, sk{kb, kh, ks}, sv{vb, vh, vs}, sw{wb, wh, ws}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, s0, o, s_out, sr, sk, sv, sw, so, B, H, S, hd, W, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, sr, sk, sv, sw, so, B, H, S,
                                 hd, W, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
