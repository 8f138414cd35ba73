// flash_attention_bwd.cu — the gradient of causal GQA flash attention on
// Hopper (sm_90a): dQ, dK and dV of
//
//     o[b, h, t] = Σ_s P[t, s] · v[b, h // g, s],
//     P[t, s] = softmax_s(x[t, s]),  x = c · tanh(z / c) (z without a soft-cap c),
//     z[t, s] = scale · q[b, h, t] · k[b, h // g, s], over the keys s ≤ t
//               (causal) with s > t − window (window > 0)
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention has no
// backward: the reference trains through the jnp attention of its models. The
// port's models run attention through the flash kernel on the card, so its
// gradient is written here, in the FlashAttention-2 scheme, from the forward's
// per-row log-sum-exp (flash_attention.cu and flash_attention_wgmma.cu write
// it when asked):
//
//     P   = exp(x − lse)                      (recomputed, never stored)
//     D   = rowsum(dO ∘ O)                    flash_bwd_prep
//     dS  = P ∘ (dO·Vᵀ − D) ∘ (1 − (x/c)²)    (the last factor only with a cap)
//     dV  = Σ_h Pᵀ·dO,  dK = scale · Σ_h dSᵀ·Q flash_bwd_dkdv
//     dQ  = scale · dS·K                       flash_bwd_dq
//
// Bound: operations. The function needs 10·hd flops a visible (query, key)
// pair (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K); both passes here recompute QKᵀ and
// dO·Vᵀ, 14·hd. Two routes, chosen by the wrapper:
// - bf16 at hd <= 128: the products on the tensor cores (mma.sync, below);
// - f32, and bf16 at hd = 256 (whose 64 × 256 f32 accumulators of dK and dV
//   would not fit a warp's registers): CUDA-core f32 FMAs.
// Both are simple first designs: wgmma, TMA and a pipelined ring are a
// later redesign's.
//
// CUDA-core design: 256 threads as a 16 × 16 grid, tiles of BT rows (64,
// or 32 at hd = 256 to fit shared memory), staged in shared memory as f32
// rows padded by four floats. A score tile is a BT × BT block, R × R values
// a thread (queries ty·R + i against keys tx + 16j) fed by float4 reads
// along hd. Both routes take the same two passes:
// - flash_bwd_dkdv: one block per (batch, KV head, key tile). Its K and V
//   tiles stay in shared memory; it walks every query head of the GQA group
//   and, for each, the query tiles whose rows see one of its keys, and keeps
//   dK and dV in registers (keys ty·R + i, R × hd/16 values each). The sum
//   over the group's heads is inside the block: no atomics, and the result
//   repeats bit for bit.
// - flash_bwd_dq: one block per (batch, head, query tile), longest first; it
//   walks the key tiles its rows see, as the forward does, and keeps dQ in
//   registers.
// Scores past S, and those the causal window hides, give P = dS = 0.
//
// Layout: q, k, v, o, dO and the outputs are (B, heads, S, hd) with hd
// contiguous and any (batch, head, sequence) strides, in elements; lse and D
// are (B, H, S) f32, contiguous. Inputs and outputs are f32 or bf16 (one
// type for all of them); the arithmetic is f32.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 × 16

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD>
struct Cfg {
  static constexpr int BT = HD >= 256 ? 32 : 64;  // rows of a query tile and of a key tile
  static constexpr int R = BT / 16;               // rows (and keys) a thread owns
  static constexpr int LD = HD + 4;               // padded row stride of the operand tiles
  static constexpr int PLD = BT + 4;              // row stride of the P and dS tiles
  static constexpr int CPT = HD / 16;             // output columns a thread owns
  static constexpr bool kVec = HD >= 64;          // columns 4tx + 64m + e, else tx + 16c
  // four operand tiles, the P and dS tiles, lse and D of a query tile
  static constexpr size_t SMEM = sizeof(float) * (size_t(4) * BT * LD + 2 * BT * PLD + 2 * BT);
};

template <int HD>
__device__ __forceinline__ int column(int tx, int c) {
  return Cfg<HD>::kVec ? 4 * tx + 64 * (c / 4) + c % 4 : tx + 16 * c;
}

// rows row0 .. row0 + BT − 1 of one (batch, head) as f32, zeros past S
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long s_stride, int row0, int S) {
  constexpr int BT = Cfg<HD>::BT, LD = Cfg<HD>::LD;
  for (int i = threadIdx.x; i < BT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * LD + d] =
        (row0 + r < S) ? to_f32(src[(long long)(row0 + r) * s_stride + d]) : 0.f;
  }
}

// s[i][j] = A[ty·R + i] · Bm[tx + 16j] over hd
template <int HD>
__device__ __forceinline__ void dots(float (&s)[Cfg<HD>::R][Cfg<HD>::R], const float* A,
                                     const float* Bm, int ty, int tx) {
  constexpr int R = Cfg<HD>::R, LD = Cfg<HD>::LD;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty * R + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// R consecutive floats from shared memory (R = 4 or 2, aligned)
template <int R>
__device__ __forceinline__ void load_r(float (&dst)[R], const float* src) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
  }
}

// P and dS of one score tile: queries q0 + ty·R + i, keys k0 + tx + 16j. s
// holds q·k, dp holds dO·v; lse and D are the tile's rows' (shared memory).
template <int HD>
__device__ __forceinline__ void probs(float (&s)[Cfg<HD>::R][Cfg<HD>::R],
                                      float (&dp)[Cfg<HD>::R][Cfg<HD>::R], const float* sL,
                                      const float* sD, int q0, int k0, int ty, int tx, int S,
                                      int causal, int window, float scale, float softcap) {
  constexpr int R = Cfg<HD>::R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = k0 + tx + 16 * j;
      float x = s[i][j] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        dcap = 1.f - t * t;
      }
      bool ok = row < S && col < S;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
      const float p = ok ? expf(x - sL[ty * R + i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - sD[ty * R + i]) * dcap;
    }
  }
}

template <typename T>
__global__ void flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dO,
                               float* __restrict__ D, Strides so, Strides sdo, int H, int S,
                               int hd, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32, s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dO + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dO, const float* __restrict__ lse,
               const float* __restrict__ Dg, T* __restrict__ dk, T* __restrict__ dv, Strides sq,
               Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int group,
               int S, int causal, int window, float scale, float softcap) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, R = C::R, LD = C::LD, PLD = C::PLD, CPT = C::CPT;
  extern __shared__ float smem[];
  float* sK = smem;             // BT × LD
  float* sV = sK + BT * LD;     // BT × LD
  float* sQ = sV + BT * LD;     // BT × LD
  float* sdO = sQ + BT * LD;    // BT × LD
  float* sP = sdO + BT * LD;    // BT × PLD: sP[query * PLD + key]
  float* sdS = sP + BT * PLD;   // BT × PLD, the same layout
  float* sL = sdS + BT * PLD;   // BT: lse of the query tile's rows
  float* sD = sL + BT;          // BT: D of the query tile's rows

  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<HD>(sK, k + b * sk.b + kvh * sk.h, sk.s, k0, S);
  load_tile<HD>(sV, v + b * sv.b + kvh * sv.h, sv.s, k0, S);

  // the query tiles some row of which sees one of keys k0 .. k_last
  const int k_last = min(k0 + BT, S) - 1;
  const int qt_lo = causal ? k0 / BT : 0;
  const int qt_hi = (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / BT;

  float acc_k[R][CPT], acc_v[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* db = dO + b * sdo.b + h * sdo.h;
    const float* lb = lse + ((long long)b * H + h) * S;
    const float* Db = Dg + ((long long)b * H + h) * S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<HD>(sQ, qb, sq.s, q0, S);
      load_tile<HD>(sdO, db, sdo.s, q0, S);
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sL[i] = q0 + i < S ? lb[q0 + i] : 0.f;
        sD[i] = q0 + i < S ? Db[q0 + i] : 0.f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      dots<HD>(s, sQ, sK, ty, tx);
      dots<HD>(dp, sdO, sV, ty, tx);
      probs<HD>(s, dp, sL, sD, q0, k0, ty, tx, S, causal, window, scale, softcap);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sP[(ty * R + i) * PLD + tx + 16 * j] = s[i][j];
          sdS[(ty * R + i) * PLD + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV[key] += Σ_t P[t, key] dO[t];  dK[key] += Σ_t dS[t, key] Q[t]
      // for this thread's keys ty·R + i
#pragma unroll 2
      for (int t = 0; t < BT; ++t) {
        float p[R], ds[R];
        load_r<R>(p, &sP[t * PLD + ty * R]);
        load_r<R>(ds, &sdS[t * PLD + ty * R]);
        float o[CPT], qv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          o[c] = sdO[t * LD + column<HD>(tx, c)];
          qv[c] = sQ[t * LD + column<HD>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc_v[i][c] = fmaf(p[i], o[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(ds[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

  T* dkb = dk + b * sdk.b + kvh * sdk.h;
  T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(&dkb[key * sdk.s + column<HD>(tx, c)], acc_k[i][c] * scale);
      store(&dvb[key * sdv.s + column<HD>(tx, c)], acc_v[i][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dO, const float* __restrict__ lse,
             const float* __restrict__ Dg, T* __restrict__ dq, Strides sq, Strides sk,
             Strides sv, Strides sdo, Strides sdq, int H, int group, int S, int causal,
             int window, float scale, float softcap) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, R = C::R, LD = C::LD, PLD = C::PLD, CPT = C::CPT;
  extern __shared__ float smem[];
  float* sQ = smem;             // BT × LD
  float* sdO = sQ + BT * LD;    // BT × LD
  float* sK = sdO + BT * LD;    // BT × LD
  float* sV = sK + BT * LD;     // BT × LD
  float* sdS = sV + BT * LD;    // BT × PLD, transposed: sdS[key * PLD + query]
  float* sL = sdS + 2 * BT * PLD;
  float* sD = sL + BT;

  // longest query tiles (most key tiles) first
  const int nq = (S + BT - 1) / BT;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BT;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<HD>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<HD>(sdO, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  const float* lb = lse + ((long long)b * H + h) * S;
  const float* Db = Dg + ((long long)b * H + h) * S;
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    sL[i] = q0 + i < S ? lb[q0 + i] : 0.f;
    sD[i] = q0 + i < S ? Db[q0 + i] : 0.f;
  }
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  // the key tiles some row of this query tile sees
  const int last_row = min(q0 + BT, S) - 1;
  const int kt_hi = causal ? last_row / BT : (S - 1) / BT;
  const int kt_lo = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BT : 0;

  float acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_tile<HD>(sK, kb, sk.s, k0, S);
    load_tile<HD>(sV, vb, sv.s, k0, S);
    __syncthreads();

    float s[R][R], dp[R][R];
    dots<HD>(s, sQ, sK, ty, tx);
    dots<HD>(dp, sdO, sV, ty, tx);
    probs<HD>(s, dp, sL, sD, q0, k0, ty, tx, S, causal, window, scale, softcap);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sdS[(tx + 16 * j) * PLD + ty * R + i] = dp[i][j];
    __syncthreads();

    // dQ[t] += Σ_key dS[t, key] K[key] for this thread's rows ty·R + i
#pragma unroll 2
    for (int kk = 0; kk < BT; ++kk) {
      float ds[R];
      load_r<R>(ds, &sdS[kk * PLD + ty * R]);
      float kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[kk * LD + column<HD>(tx, c)];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(&dqb[row * sdq.s + column<HD>(tx, c)], acc[i][c] * scale);
  }
}

// ------------------------------------------------------------ tensor-core route
// bf16 at hd <= 128: the same two passes, with every product on mma.sync
// m16n8k16 (bf16 in, f32 accumulate). Tiles of 64 rows stay bf16 in shared
// memory, row-major and, where a product reduces over rows, transposed too.
// Four warps own 16 rows each (keys in dK/dV, queries in dQ). Q, K, V and
// dO are bf16 inputs, so their products are exact in f32; P and dS, f32 in
// registers, enter the products that consume them as two bf16 halves, hi =
// bf16(x) and lo = bf16(x − hi) (about 16 significant bits, as the forward
// carries P), so the result keeps the CUDA-core route's accuracy.

constexpr int kTcThreads = 128;  // four warps
constexpr int kTcRows = 64;      // rows of a query tile and of a key tile

template <int HD>
struct Tc {
  static constexpr int LD = HD + 8;         // row stride of a [row][d] tile (conflict-free)
  static constexpr int LDT = kTcRows + 8;   // row stride of a transposed [d][row] tile
  static constexpr int NB = HD / 8;         // n-blocks of 8 over d
  static constexpr size_t TILE = size_t(kTcRows) * LD * 2, TILE_T = size_t(HD) * LDT * 2;
  static constexpr size_t SMEM_DKDV = 4 * TILE + 2 * TILE_T + 8 * kTcRows;
  static constexpr size_t SMEM_DQ = 4 * TILE + TILE_T + 8 * kTcRows;
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 -> (bf16 pair of x, bf16 pair of the remainders)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
  const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
  hi = pack2(x0, x1);
  lo = pack2(x0 - h0, x1 - h1);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 × 8·NBLK) += A · Btᵀ: A's 16 rows at a (stride lda), Bt's 8·NBLK rows
// at bt (stride ldb), both contiguous along the K reduced elements
template <int K, int NBLK>
__device__ __forceinline__ void mma_ss(float (&c)[NBLK][4], const __nv_bfloat16* a, int lda,
                                       const __nv_bfloat16* bt, int ldb, int g, int t) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t af[4] = {lds32(a + g * lda + k0 + 2 * t), lds32(a + (g + 8) * lda + k0 + 2 * t),
                            lds32(a + g * lda + k0 + 2 * t + 8),
                            lds32(a + (g + 8) * lda + k0 + 2 * t + 8)};
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      const __nv_bfloat16* row = bt + (nb * 8 + g) * ldb + k0 + 2 * t;
      mma16816(c[nb], af, lds32(row), lds32(row + 8));
    }
  }
}

// c (16 × 8·NBLK) += R · Btᵀ: R (16 × K) in registers as the accumulator
// fragments of K/8 n-blocks, split into bf16 hi + lo; Bt as in mma_ss
template <int K, int NBLK>
__device__ __forceinline__ void mma_rs(float (&c)[NBLK][4], const float (&r)[K / 8][4],
                                       const __nv_bfloat16* bt, int ldb, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split2(r[2 * kk][0], r[2 * kk][1], hi[0], lo[0]);
    split2(r[2 * kk][2], r[2 * kk][3], hi[1], lo[1]);
    split2(r[2 * kk + 1][0], r[2 * kk + 1][1], hi[2], lo[2]);
    split2(r[2 * kk + 1][2], r[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      const __nv_bfloat16* row = bt + (nb * 8 + g) * ldb + kk * 16 + 2 * t;
      const uint32_t b0 = lds32(row), b1 = lds32(row + 8);
      mma16816(c[nb], hi, b0, b1);
      mma16816(c[nb], lo, b0, b1);
    }
  }
}

// 64 rows of one (batch, head) into dst [row][d] and, if asked, dst_t
// [d][row]; 16-byte loads (the wrapper checks strides and bases); zeros
// past S
template <int HD>
__device__ __forceinline__ void load_rows_tc(__nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                             const __nv_bfloat16* __restrict__ src,
                                             long long s_stride, int row0, int S) {
  constexpr int VPR = HD / 8, LD = Tc<HD>::LD, LDT = Tc<HD>::LDT;
  for (int i = threadIdx.x; i < kTcRows * VPR; i += kTcThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * LDT + r] = e[j];
    }
  }
}

// P and dS of one warp's 16 × 64 fragment tile: element e of n-block nb is
// (row g + 8·(e / 2), column 8·nb + 2t + e % 2); ``rows_are_keys`` says
// which index is the key. s holds q·k, dp holds dO·v; lse and D are
// indexed by the query within its tile.
__device__ __forceinline__ void probs_tc(float (&s)[8][4], float (&dp)[8][4], const float* sL,
                                         const float* sD, int row0, int col0, int q_in_tile0,
                                         bool rows_are_keys, int g, int t, int S, int causal,
                                         int window, float scale, float softcap) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = nb * 8 + 2 * t + (e & 1);
      const int key = rows_are_keys ? row0 + r : col0 + c;
      const int qr = rows_are_keys ? col0 + c : row0 + r;
      const int qi = rows_are_keys ? c : q_in_tile0 + r;
      float x = s[nb][e] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float th = tanhf(x / softcap);
        x = th * softcap;
        dcap = 1.f - th * th;
      }
      bool ok = qr < S && key < S;
      if (causal) ok = ok && key <= qr;
      if (window > 0) ok = ok && key > qr - window;
      const float p = ok ? expf(x - sL[qi]) : 0.f;
      s[nb][e] = p;
      dp[nb][e] = p * (dp[nb][e] - sD[qi]) * dcap;
    }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ Dg,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides sq,
                  Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                  int group, int S, int causal, int window, float scale, float softcap) {
  using C = Tc<HD>;
  constexpr int LD = C::LD, LDT = C::LDT, NB = C::NB;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [key][d]
  __nv_bfloat16* sV = sK + kTcRows * LD;                           // [key][d]
  __nv_bfloat16* sQ = sV + kTcRows * LD;                           // [query][d]
  __nv_bfloat16* sdO = sQ + kTcRows * LD;                          // [query][d]
  __nv_bfloat16* sQt = sdO + kTcRows * LD;                         // [d][query]
  __nv_bfloat16* sdOt = sQt + HD * LDT;                            // [d][query]
  float* sL = reinterpret_cast<float*>(sdOt + HD * LDT);
  float* sD = sL + kTcRows;

  const int k0 = blockIdx.x * kTcRows, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kw = 16 * warp;  // this warp's keys, within the tile
  load_rows_tc<HD>(sK, nullptr, k + b * sk.b + kvh * sk.h, sk.s, k0, S);
  load_rows_tc<HD>(sV, nullptr, v + b * sv.b + kvh * sv.h, sv.s, k0, S);

  const int k_last = min(k0 + kTcRows, S) - 1;
  const int qt_lo = causal ? k0 / kTcRows : 0;
  const int qt_hi = (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / kTcRows;

  float acc_k[NB][4], acc_v[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nb][e] = acc_v[nb][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* lb = lse + ((long long)b * H + h) * S;
    const float* Db = Dg + ((long long)b * H + h) * S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kTcRows;
      __syncthreads();  // the previous tile's Q and dO are no longer read
      load_rows_tc<HD>(sQ, sQt, q + b * sq.b + h * sq.h, sq.s, q0, S);
      load_rows_tc<HD>(sdO, sdOt, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
      for (int i = threadIdx.x; i < kTcRows; i += kTcThreads) {
        sL[i] = q0 + i < S ? lb[q0 + i] : 0.f;
        sD[i] = q0 + i < S ? Db[q0 + i] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];  // Sᵀ and dPᵀ: this warp's 16 keys × the 64 queries
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      mma_ss<HD, 8>(dp, sV + kw * LD, LD, sdO, LD, g, t);
      mma_ss<HD, 8>(s, sK + kw * LD, LD, sQ, LD, g, t);
      probs_tc(s, dp, sL, sD, k0 + kw, q0, 0, true, g, t, S, causal, window, scale, softcap);
      mma_rs<kTcRows, NB>(acc_v, s, sdOt, LDT, g, t);   // dV += Pᵀ·dO
      mma_rs<kTcRows, NB>(acc_k, dp, sQt, LDT, g, t);   // dK += dSᵀ·Q
    }
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kw + g + 8 * half;
    if (key >= S) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = nb * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&dkb[key * sdk.s + col]) =
          pack2(acc_k[nb][2 * half] * scale, acc_k[nb][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(&dvb[key * sdv.s + col]) =
          pack2(acc_v[nb][2 * half], acc_v[nb][2 * half + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ Dg,
                __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                Strides sdq, int H, int group, int S, int causal, int window, float scale,
                float softcap) {
  using C = Tc<HD>;
  constexpr int LD = C::LD, LDT = C::LDT, NB = C::NB;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [query][d]
  __nv_bfloat16* sdO = sQ + kTcRows * LD;                          // [query][d]
  __nv_bfloat16* sK = sdO + kTcRows * LD;                          // [key][d]
  __nv_bfloat16* sV = sK + kTcRows * LD;                           // [key][d]
  __nv_bfloat16* sKt = sV + kTcRows * LD;                          // [d][key]
  float* sL = reinterpret_cast<float*>(sKt + HD * LDT);
  float* sD = sL + kTcRows;

  const int nq = (S + kTcRows - 1) / kTcRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTcRows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qw = 16 * warp;  // this warp's queries, within the tile
  load_rows_tc<HD>(sQ, nullptr, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_rows_tc<HD>(sdO, nullptr, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  const float* lb = lse + ((long long)b * H + h) * S;
  const float* Db = Dg + ((long long)b * H + h) * S;
  for (int i = threadIdx.x; i < kTcRows; i += kTcThreads) {
    sL[i] = q0 + i < S ? lb[q0 + i] : 0.f;
    sD[i] = q0 + i < S ? Db[q0 + i] : 0.f;
  }
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;

  const int last_row = min(q0 + kTcRows, S) - 1;
  const int kt_hi = causal ? last_row / kTcRows : (S - 1) / kTcRows;
  const int kt_lo = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / kTcRows : 0;

  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kTcRows;
    __syncthreads();  // the previous tile's K, V are no longer read
    load_rows_tc<HD>(sK, sKt, kb, sk.s, k0, S);
    load_rows_tc<HD>(sV, nullptr, vb, sv.s, k0, S);
    __syncthreads();

    float s[8][4], dp[8][4];  // S and dP: this warp's 16 queries × the 64 keys
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_ss<HD, 8>(dp, sdO + qw * LD, LD, sV, LD, g, t);
    mma_ss<HD, 8>(s, sQ + qw * LD, LD, sK, LD, g, t);
    probs_tc(s, dp, sL, sD, q0 + qw, k0, qw, false, g, t, S, causal, window, scale, softcap);
    mma_rs<kTcRows, NB>(acc, dp, sKt, LDT, g, t);   // dQ += dS·K
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qw + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(&dqb[row * sdq.s + nb * 8 + 2 * t]) =
          pack2(acc[nb][2 * half] * scale, acc[nb][2 * half + 1] * scale);
  }
}

// the route of a dK/dV or dQ launch, chosen by the wrapper
constexpr int kRouteF32 = 0;           // f32: CUDA cores
constexpr int kRouteBf16 = 1;          // bf16 at hd = 256: CUDA cores
constexpr int kRouteTensorCores = 2;   // bf16 at hd <= 128: mma.sync

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *D;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, KV, S, causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_dkdv(const Args& a) {
  constexpr size_t smem = Cfg<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + Cfg<HD>::BT - 1) / Cfg<HD>::BT, a.KV, a.B);
  flash_bwd_dkdv<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.D, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq,
      a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.H / a.KV, a.S, a.causal, a.window, a.scale,
      a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const Args& a) {
  constexpr size_t smem = Cfg<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + Cfg<HD>::BT - 1) / Cfg<HD>::BT, a.H, a.B);
  flash_bwd_dq<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.D, static_cast<T*>(a.dq), a.sq, a.sk, a.sv, a.sdo,
      a.sdq, a.H, a.H / a.KV, a.S, a.causal, a.window, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tc(int pass, const Args& a) {
  using B16 = __nv_bfloat16;
  const dim3 block(kTcThreads), grid((a.S + kTcRows - 1) / kTcRows, pass == 0 ? a.KV : a.H, a.B);
  cudaError_t err;
  if (pass == 0) {
    constexpr size_t smem = Tc<HD>::SMEM_DKDV;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_tc<HD><<<grid, block, smem, a.stream>>>(
        static_cast<const B16*>(a.q), static_cast<const B16*>(a.k), static_cast<const B16*>(a.v),
        static_cast<const B16*>(a.dO), a.lse, a.D, static_cast<B16*>(a.dk),
        static_cast<B16*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.H / a.KV, a.S,
        a.causal, a.window, a.scale, a.softcap);
  } else {
    constexpr size_t smem = Tc<HD>::SMEM_DQ;
    err = cudaFuncSetAttribute(flash_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_tc<HD><<<grid, block, smem, a.stream>>>(
        static_cast<const B16*>(a.q), static_cast<const B16*>(a.k), static_cast<const B16*>(a.v),
        static_cast<const B16*>(a.dO), a.lse, a.D, static_cast<B16*>(a.dq), a.sq, a.sk, a.sv,
        a.sdo, a.sdq, a.H, a.H / a.KV, a.S, a.causal, a.window, a.scale, a.softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_pass(int pass, const Args& a) {
  return pass == 0 ? launch_dkdv<T, HD>(a) : launch_dq<T, HD>(a);
}

template <typename T>
int dispatch(int pass, int hd, const Args& a) {
  switch (hd) {
    case 16: return launch_pass<T, 16>(pass, a);
    case 32: return launch_pass<T, 32>(pass, a);
    case 64: return launch_pass<T, 64>(pass, a);
    case 128: return launch_pass<T, 128>(pass, a);
    case 256: return launch_pass<T, 256>(pass, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_tc(int pass, int hd, const Args& a) {
  switch (hd) {
    case 16: return launch_tc<16>(pass, a);
    case 32: return launch_tc<32>(pass, a);
    case 64: return launch_tc<64>(pass, a);
    case 128: return launch_tc<128>(pass, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int pass, const void* q, const void* k, const void* v, const void* dO, const float* lse,
        const float* D, void* dq, void* dk, void* dv, const long long* st, int B, int H, int KV,
        int S, int hd, int causal, int window, float scale, float softcap, int route,
        void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dO, lse, D, dq, dk, dv,
               {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
               {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
               {st[18], st[19], st[20]},
               B, H, KV, S, causal, window, scale, softcap, static_cast<cudaStream_t>(stream)};
  switch (route) {
    case kRouteF32: return dispatch<float>(pass, hd, a);
    case kRouteBf16: return dispatch<__nv_bfloat16>(pass, hd, a);
    case kRouteTensorCores: return dispatch_tc(pass, hd, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// D = rowsum(dO ∘ O) in f32, (B, H, S) contiguous. o and dO f32 or bf16
// (bf16 != 0), strides (batch, head, sequence) in elements.
extern "C" int flash_attention_bwd_prep(const void* o, const void* dO, float* D, long long ob,
                                        long long oh, long long os, long long db, long long dh,
                                        long long ds, int B, int H, int S, int hd, int bf16,
                                        void* stream) {
  const long long rows = (long long)B * H * S;
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  const Strides so{ob, oh, os}, sd{db, dh, ds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    flash_bwd_prep<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO), D, so, sd,
        H, S, hd, rows);
  else
    flash_bwd_prep<float><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(o),
                                                       static_cast<const float*>(dO), D, so, sd,
                                                       H, S, hd, rows);
  return static_cast<int>(cudaGetLastError());
}

// dK and dV (flash_attention_bwd_dkdv) or dQ (flash_attention_bwd_dq). Both
// take the same arguments: q, k, v, dO, lse, D, dq, dk, dv (the entry writes
// only its own outputs), then the (batch, head, sequence) element strides of
// q, k, v, dO, dq, dk and dv in that order, the sizes, the mask, the scale,
// the soft-cap (0: none) and the route: 0 f32 on the CUDA cores, 1 bf16 on
// the CUDA cores, 2 bf16 on the tensor cores (hd <= 128; q, k, v and dO
// with strides in multiples of 8 elements on 16-byte aligned bases).
#define FLASH_BWD_ENTRY(NAME, PASS)                                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dO,               \
                      const float* lse, const float* D, void* dq, void* dk, void* dv,            \
                      long long s0, long long s1, long long s2, long long s3, long long s4,      \
                      long long s5, long long s6, long long s7, long long s8, long long s9,       \
                      long long s10, long long s11, long long s12, long long s13, long long s14, \
                      long long s15, long long s16, long long s17, long long s18, long long s19, \
                      long long s20, int B, int H, int KV, int S, int hd, int causal,            \
                      int window, float scale, float softcap, int route, void* stream) {         \
    const long long st[21] = {s0,  s1,  s2,  s3,  s4,  s5,  s6,  s7,  s8,  s9, s10,              \
                              s11, s12, s13, s14, s15, s16, s17, s18, s19, s20};                 \
    return run(PASS, q, k, v, dO, lse, D, dq, dk, dv, st, B, H, KV, S, hd, causal, window,       \
               scale, softcap, route, stream);                                                   \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_dkdv, 0)
FLASH_BWD_ENTRY(flash_attention_bwd_dq, 1)
