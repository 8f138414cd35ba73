// flash_attention.cu — causal GQA flash attention (forward) on Hopper (sm_90a),
// the f32 route: CUDA-core FMAs. bf16 inputs go to the tensor-core kernel in
// flash_attention_wgmma.cu.
//
//     o[b, h, t] = Σ_s softmax_s(scale · q[b, h, t] · k[b, h // g, s]) · v[b, h // g, s]
//                  over the keys s ≤ t (causal) with s > t − window (window > 0)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention: the same function — scores, running max and running sum
// in f32, masked scores at −1e30, the output in f32 — with the
// same skip of key tiles that lie wholly outside every row's causal window.
// Unlike the TPU kernel any S is allowed: the ragged last tile of queries
// and keys is masked here (rows past S are neither read nor written).
//
// Bound: operations. A (query tile, key tile) pair costs 4·64·64·hd flops
// and reads 2·64·hd elements, far above the card's flop-per-byte balance.
// At recurrentgemma-9b's serve shape (B = 4, H = 16, KV = 1, S = 4096,
// hd = 256, window 2048) a head needs 1,584 of the 4,096 tile pairs.
//
// Design: one thread block owns a (batch, head, 64-row query tile). Its Q
// tile stays in shared memory; it walks the key tiles its rows can see in
// order, staging each K and V tile in shared memory. 256 threads as a 16 × 16 grid: thread (ty, tx) computes the
// scores of rows 4ty..4ty+3 against keys tx + 16j (j < 4) — a 4 × 4
// register tile fed by float4 reads along hd, so a thread makes 8
// shared-memory reads per 64 FMAs — then the online-softmax update of its
// four rows (row max and sum reduced over the 16 lanes of a row with
// shuffles), and accumulates its four rows' output in registers: four
// neighbouring columns per float4 read of V (columns 4tx + 64m) at
// hd >= 64, columns tx + 16c below. P goes through shared memory,
// transposed, so a thread reads its four rows' weights of one key as one
// float4. Q and K rows are padded by four floats, so the eight lanes of a
// quarter-warp read eight different 16-byte bank groups. The loops are
// bound by shared-memory bandwidth and the FMA rate alike. At hd = 256 the
// tiles take 211 KB of dynamic shared memory (set with
// cudaFuncSetAttribute), so one block runs per SM. f32 products are not
// exact on the tensor cores, so this route keeps the CUDA cores: it serves
// the models run in f32 and the card-against-CPU parity checks.
//
// GQA: query head h reads KV head h / g, where g = H / KV, as the TPU
// kernel's index map does. The caller runs it on the real heads only (the
// model's padded query heads would otherwise map to the wrong KV head).
//
// Layout: every tensor is (B, heads, S, hd) with hd contiguous and any
// strides for the batch, head and sequence axes, passed in elements, so
// the model's (B, S, heads, hd) activations go in without a copy.
//
// Training: with a non-null lse the kernel also writes each query row's
// log-sum-exp, lse = m + log(l) in f32, (B, H, S) contiguous: what the
// backward (flash_attention_bwd.cu) needs to recompute P. Serving passes null.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 × 16
constexpr int kPLD = kBQ + 4;  // row stride of the transposed P tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(2) * kBQ * (HD + 4) + size_t(kBK) * HD + size_t(kBK) * kPLD);
}

template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          long long s_stride, int row0, int S) {
  for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * ld + d] = (row0 + r < S) ? src[(long long)(row0 + r) * s_stride + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
          Strides so, int group, int S, int causal, int window, float scale, float softcap) {
  constexpr int LD = HD + 4;    // padded row stride of the Q and K tiles
  constexpr int CPT = HD / 16;  // output columns per thread
  constexpr bool kVecV = HD >= 64;  // float4 reads of V: columns 4tx + 64m
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ × LD
  float* sK = sQ + kBQ * LD;    // kBK × LD
  float* sV = sK + kBK * LD;    // kBK × HD
  float* sP = sV + kBK * HD;    // kBK × kPLD: sP[key * kPLD + row]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  load_tile<HD>(sQ, LD, qb, sq.s, q0, S);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // the key tiles some row of this query tile can see
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kt_hi = causal ? last_row / kBK : (S - 1) / kBK;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<HD>(sK, LD, kb, sk.s, k0, S);
    load_tile<HD>(sV, HD, vb, sv.s, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(tx + 16 * j) * kPLD + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&sP[j * kPLD + ty * 4]);
      float vv[CPT];
      if constexpr (kVecV) {
#pragma unroll
        for (int m4 = 0; m4 < HD / 64; ++m4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&sV[j * HD + 4 * tx + 64 * m4]);
          vv[4 * m4] = v4.x;
          vv[4 * m4 + 1] = v4.y;
          vv[4 * m4 + 2] = v4.z;
          vv[4 * m4 + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = sV[j * HD + tx + 16 * c];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        acc[0][c] = fmaf(p.x, vv[c], acc[0][c]);
        acc[1][c] = fmaf(p.y, vv[c], acc[1][c]);
        acc[2][c] = fmaf(p.z, vv[c], acc[2][c]);
        acc[3][c] = fmaf(p.w, vv[c], acc[3][c]);
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = kVecV ? 4 * tx + 64 * (c / 4) + c % 4 : tx + 16 * c;
      ob[row * so.s + col] = acc[i][c] * inv;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int KV, int S, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<HD><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, sq, sk, sv, so, H / KV, S,
                                                  causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and o float32; lse (B, H, S) float32 or null. Strides are in
// elements: (batch, head, sequence) of q, k, v and o in that order.
extern "C" int flash_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                   float* lse, long long qb, long long qh, long long qs,
                                   long long kb, long long kh, long long ks, long long vb, long long vh,
                                   long long vs, long long ob, long long oh, long long os, int B,
                                   int H, int KV, int S, int hd, int causal, int window,
                                   float scale, float softcap, void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, sq, sk, sv, so, B, H, KV, S, causal, window, scale, softcap, st);
    case 32: return launch<32>(q, k, v, o, lse, sq, sk, sv, so, B, H, KV, S, causal, window, scale, softcap, st);
    case 64: return launch<64>(q, k, v, o, lse, sq, sk, sv, so, B, H, KV, S, causal, window, scale, softcap, st);
    case 128: return launch<128>(q, k, v, o, lse, sq, sk, sv, so, B, H, KV, S, causal, window, scale, softcap, st);
    case 256: return launch<256>(q, k, v, o, lse, sq, sk, sv, so, B, H, KV, S, causal, window, scale, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
