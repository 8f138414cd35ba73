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
//     dV  = Σ_h Pᵀ·dO,  dK = scale · Σ_h dSᵀ·Q flash_bwd_dkdv*
//     dQ  = scale · dS·K                       flash_bwd_dq*
//
// flash_bwd_prep also writes lse·log2(e) next to D (P is taken as a power of
// 2), both as (B, H, Sp) f32 with rows padded with zeros to Sp = S rounded
// up to 64, so that a 64-row tile of either is one aligned bulk copy.
//
// Bound: operations. The function needs 10·hd flops a visible (query, key)
// pair (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K). Two routes, chosen by the wrapper:
// - bf16 (every hd): the products on the tensor cores (wgmma, below);
// - f32: CUDA-core f32 FMAs.
// Both take the same two passes, which keep every sum inside one block, in
// a fixed order: no atomics, and the result repeats bit for bit.
// - dK/dV: one block per (batch, KV head, key tile). It walks every query
//   head of the GQA group and, for each, the query tiles whose rows see one
//   of its keys, and keeps dK and dV in registers.
// - dQ: one block per (batch, head, query tile), longest first; it walks the
//   key tiles its rows see, as the forward does, and keeps dQ in registers.
// Both recompute QKᵀ and dO·Vᵀ, so the passes do 14·hd flops a pair.
// Scores past S, and those the causal window hides, give P = dS = 0.
//
// Tensor-core design (flash_bwd_dkdv_wgmma, flash_bwd_dq_wgmma). The
// forward's shape (flash_attention_wgmma.cu; helpers in hopper.cuh): 384
// threads, a producer warpgroup whose one thread issues TMA copies into a
// 2-stage ring guarded by full/empty mbarriers, and two consumer
// warpgroups (setmaxnreg 24/240). Tiles are 64 rows × hd bf16 as TMA
// writes them (128-byte swizzle), which is what the wgmma descriptors
// read, so no tile is copied, converted or transposed by a thread.
// - dK/dV: a block owns 128 keys, 64 a warpgroup (hd <= 128); its K and V
//   tiles are loaded once, and the ring carries (Q, dO, the rows' lse and
//   D) over the group's heads and the query tiles that see the block's
//   keys. A warpgroup computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma m64n64k16,
//   both operands from shared memory, hd the reduced axis), Pᵀ and dSᵀ in
//   registers, then dV += Pᵀ·dO and dK += dSᵀ·Q (wgmma m64n{hd}k16, A from
//   registers, B = dO or Q read through the transpose bit: the reduced axis
//   is the tile's rows). dK and dV are 2 × hd/2 f32 registers a thread.
// - dQ: a block owns 128 queries; Q and dO are loaded once, the ring
//   carries (K, V). S = Q·Kᵀ and dP = dO·Vᵀ as above, then dQ += dS·K with
//   K read transposed.
// hd = 256 (Wg<256>::kSplit). A warpgroup's 64 rows of f32 dK and dV at
// full width would take 2 × 128 registers a thread, and 128 rows of K and V
// beside the ring 256 KB of shared memory. So a block owns 64 rows (keys,
// or queries in the dQ pass) and its two warpgroups split hd: each keeps
// dK[:, half] and dV[:, half] (dQ[:, half]), 128 accumulator registers a
// thread as at hd 128, and multiplies by its half of dO, Q (K) through a
// descriptor that starts two column blocks in. Both warpgroups compute the
// same 64 × 64 Sᵀ and dPᵀ (S and dP) over the full hd: the products are
// duplicated rather than exchanged as two 64 × 64 f32 partials through
// shared memory, which would add 32 KB, two named barriers a tile and lock
// the warpgroups together. Shared memory: K and V 64 KB and a 2-stage ring
// of Q and dO 128 KB with the rows' lse and D (dK/dV), Q and dO 64 KB and a
// ring of K and V 128 KB (dQ): about 194 KB each (Wg's static_assert).
// At the train shape (KV = 1) the dK/dV grid is 256 blocks of 64 keys on
// 132 SMs, each walking all 16 heads; taken longest first they pair up
// (the key tile nearest the start sees 32 query tiles, the last one 1).
// P and dS, f32 in registers, enter the products that consume them as two
// bf16 halves, hi = bf16(x) and lo = bf16(x − hi) (about 16 significant
// bits, as the forward carries P); Q, K, V and dO are bf16 and exact in the
// products. So the route keeps the CUDA-core route's accuracy at 20·hd
// tensor-core flops a pair (28·hd at hd 256: 16·hd in dK/dV, 12·hd in dQ,
// with Sᵀ and dPᵀ duplicated), against the bound's 10·hd: the design's
// ceiling is half the bound's rate (5/14 at hd 256). Between the products
// a warpgroup's 64 × 64 tile is elementwise work (P = 2^(s·scale·log2 e −
// lse·log2 e), one FFMA and one ex2 a score; dS; the hi/lo splits), which
// at hd = 64 issues about as many instructions as the products take
// tensor-core cycles. So the mask is applied only to tiles that are not
// wholly visible (the diagonal, the window's edge, the ragged end), and
// within a tile P is computed while dP = dO·Vᵀ is still in flight and dS
// while dV += Pᵀ·dO runs (wgmma wait_group 1, then 0). Blocks go longest
// first in both passes (the key tile nearest the start sees the most
// queries); a warpgroup skips the products of a tile wholly outside its
// rows' window but still waits on it and releases it.
//
// CUDA-core design (f32): 256 threads as a 16 × 16 grid, tiles of BT rows
// (64, or 32 at hd = 256 to fit shared memory), staged in shared memory as
// f32 rows padded by four floats. A score tile is a BT × BT block, R × R
// values a thread (queries ty·R + i against keys tx + 16j) fed by float4
// reads along hd; dK and dV are kept for keys ty·R + i, R × hd/16 values
// each.
//
// Layout: q, k, v, o, dO and the outputs are (B, heads, S, hd) with hd
// contiguous and any (batch, head, sequence) strides, in elements (on the
// tensor-core route those of q, k, v and dO multiples of 8 on 16-byte
// aligned bases: the TMA descriptors' rule); lse is the forward's (B, H, S)
// f32, contiguous. Inputs and outputs are f32 or bf16 (one type for all of
// them); the arithmetic is f32.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (or 1000 + the driver's error code if a tensor map
// cannot be built).

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int kRowPad = 64;    // lse and D rows are padded to a multiple of this
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

__host__ __device__ __forceinline__ int padded(int S) {
  return (S + kRowPad - 1) / kRowPad * kRowPad;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// rows row0 .. row0 + BT − 1 of one (batch, head), zeros past S
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long s_stride, int row0, int S) {
  constexpr int BT = Cfg<HD>::BT, LD = Cfg<HD>::LD;
  for (int i = threadIdx.x; i < BT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * LD + d] =
        (row0 + r < S) ? src[(long long)(row0 + r) * s_stride + d] : 0.f;
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
      const float p = ok ? exp2f(fmaf(x, kLog2e, -sL[ty * R + i])) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - sD[ty * R + i]) * dcap;
    }
  }
}

// Σ o·dO over V elements (one 16-byte load of each where V > 1)
template <int V, typename T>
__device__ __forceinline__ float dot_chunk(const T* a, const T* b) {
  if constexpr (V == 1) {
    return to_f32(*a) * to_f32(*b);
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(to_f32(xs[e]), to_f32(ys[e]), acc);
    return acc;
  }
}

// D = rowsum(dO ∘ O) and lse·log2(e), both (B, H, Sp) with zeros past S. A
// row's hd / V chunks of V elements go to min(hd / V, 32) adjacent lanes,
// which sum them with shuffles: V = 16 bytes' worth where every row starts
// 16-byte aligned, else 1.
template <int V, typename T>
__global__ void flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dO,
                               const float* __restrict__ lse, float* __restrict__ L,
                               float* __restrict__ D, Strides so, Strides sdo, int H, int S,
                               int hd, long long rows) {
  const int chunks = hd / V, lanes = min(chunks, 32);
  const long long gl = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = gl / lanes;
  const int part = static_cast<int>(gl % lanes), Sp = padded(S);
  const int s = static_cast<int>(row % Sp);
  const long long bh = row / Sp;
  float acc = 0.f;
  if (row < rows && s < S) {
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const T* orow = o + b * so.b + h * so.h + s * so.s;
    const T* drow = dO + b * sdo.b + h * sdo.h + s * sdo.s;
    for (int c = part; c < chunks; c += lanes) acc += dot_chunk<V>(orow + c * V, drow + c * V);
  }
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows) {
    D[row] = acc;
    L[row] = s < S ? lse[bh * S + s] * kLog2e : 0.f;
  }
}

// ------------------------------------------------------------ CUDA-core route (f32)

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dO,
               const float* __restrict__ Lg, const float* __restrict__ Dg,
               float* __restrict__ dk, float* __restrict__ dv, Strides sq,
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

  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z, Sp = padded(S);
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
    const float* qb = q + b * sq.b + h * sq.h;
    const float* db = dO + b * sdo.b + h * sdo.h;
    const float* lb = Lg + ((long long)b * H + h) * Sp;
    const float* Db = Dg + ((long long)b * H + h) * Sp;
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

  float* dkb = dk + b * sdk.b + kvh * sdk.h;
  float* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkb[key * sdk.s + column<HD>(tx, c)] = acc_k[i][c] * scale;
      dvb[key * sdv.s + column<HD>(tx, c)] = acc_v[i][c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ Lg, const float* __restrict__ Dg,
             float* __restrict__ dq, Strides sq, Strides sk,
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
  const float* lb = Lg + ((long long)b * H + h) * padded(S);
  const float* Db = Dg + ((long long)b * H + h) * padded(S);
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    sL[i] = q0 + i < S ? lb[q0 + i] : 0.f;
    sD[i] = q0 + i < S ? Db[q0 + i] : 0.f;
  }
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

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

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqb[row * sdq.s + column<HD>(tx, c)] = acc[i][c] * scale;
  }
}

// ------------------------------------------------------------ tensor-core route (wgmma)

constexpr int kTcStages = 2;                   // ring depth of both passes
constexpr int kTcConsumers = 256;              // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // and the producer's warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128·24 + 256·240 ≤ 64 K
constexpr size_t kMaxSmem = 232448;            // dynamic shared memory a block may use

// The shape of a tensor-core block by head size. At hd <= 128 a block owns
// 128 rows (keys in dK/dV, queries in dQ), 64 a warpgroup, and a warpgroup
// all hd output columns of its rows. At hd = 256 (kSplit) it owns 64 rows,
// which both warpgroups share, each keeping hd/2 of the output columns.
template <int HD>
struct Wg {
  using T = hopper::Tiles<HD>;
  static constexpr bool kSplit = HD > 128;
  static constexpr int ROWS = kSplit ? hopper::kRows : 2 * hopper::kRows;
  static constexpr int OWN = ROWS / hopper::kRows;   // tiles of each operand the block owns
  static constexpr int COLS = kSplit ? HD / 2 : HD;  // output columns of a warpgroup
  // the block's own tiles of two operands, the ring's two tiles a stage, the
  // ring's lse and D rows (dK/dV), barriers, and 1 KB to align the start
  static constexpr size_t SMEM_DKDV = size_t(2 * OWN + 2 * kTcStages) * T::TILE +
                                      2 * kTcStages * hopper::kRows * 4 + 1024 + 128;
  static constexpr size_t SMEM_DQ = size_t(2 * OWN + 2 * kTcStages) * T::TILE + 1024 + 128;
  static_assert(SMEM_DKDV <= kMaxSmem && SMEM_DQ <= kMaxSmem,
                "a tensor-core backward block must fit the 227 KB of shared memory");
};

// the 64 × 16 A fragments of a 64 × 64 f32 accumulator tile, as bf16 hi + lo
// halves: keys (or queries) 16kk .. 16kk + 15 in hi[kk], lo[kk]
__device__ __forceinline__ void split_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // the pair x[2i], x[2i + 1]
    const uint32_t h = hopper::pack_bf16(x[2 * i], x[2 * i + 1]);
    hi[i / 4][i % 4] = h;
    lo[i / 4][i % 4] = hopper::pack_bf16(x[2 * i] - __uint_as_float(h << 16),
                                         x[2 * i + 1] - __uint_as_float(h & 0xffff0000u));
  }
}

// s (64 × 64) = A·Bᵀ over hd: both tiles from shared memory, hd contiguous
// (issued, not waited for; the first step overwrites s)
template <int HD>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* a, const uint8_t* b) {
  using T = hopper::Tiles<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    hopper::wgmma_ss_m64n64(s, T::k_desc(a, ks), T::k_desc(b, ks), ks > 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether every (query, key) pair of queries [q0, q0 + 63] and keys [k0,
// k0 + 63] is visible: then a tile needs no mask.
__device__ __forceinline__ bool all_visible(int q0, int k0, int S, int causal, int window) {
  return q0 + 63 < S && k0 + 63 < S && (!causal || k0 + 63 <= q0) &&
         (window <= 0 || q0 + 63 - window < k0);
}

__device__ __forceinline__ bool visible(int query, int key, int S, int causal, int window) {
  return query < S && key < S && (!causal || key <= query) &&
         (window <= 0 || key > query - window);
}

// The elementwise work of a warpgroup's 64 × 64 tile, s (scores) and dp
// (dO·Vᵀ) in its accumulator layout, both in flight (committed in that
// order), given at(j) = (query, key, the query's lse·log2(e) and D) of
// element j: P in place of s and dS in place of dp, split into the A
// fragments of the products that consume them (P's only kWithP), which
// `use_p` and `use_ds` issue; returns when they are done. Without a
// soft-cap, P is computed while dp is still in flight, and dS while the
// products of P run; with one, both wait for dp (dS needs the cap's
// derivative, 1 − tanh²). c is scale·log2(e).
template <bool kCap, bool kMask, bool kWithP, typename At, typename UseP, typename UseDs>
__device__ __forceinline__ void tile_elementwise(float (&s)[32], float (&dp)[32],
                                                 uint32_t (&p_hi)[4][4], uint32_t (&p_lo)[4][4],
                                                 uint32_t (&ds_hi)[4][4],
                                                 uint32_t (&ds_lo)[4][4], const At& at, int S,
                                                 int causal, int window, float c, float softcap,
                                                 const UseP& use_p, const UseDs& use_ds) {
  using namespace hopper;
  if constexpr (kCap) {
    wgmma_wait<0>();
    keep(s);
    keep(dp);
    const float inner = c / kLog2e / softcap, outer = softcap * kLog2e;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      int query, key;
      float l2, d;
      at(j, query, key, l2, d);
      const float th = tanhf(s[j] * inner);
      float p = ex2(fmaf(th, outer, -l2));
      if (kMask && !visible(query, key, S, causal, window)) p = 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - d) * (1.f - th * th);
    }
    if constexpr (kWithP) split_fragments(s, p_hi, p_lo);
    split_fragments(dp, ds_hi, ds_lo);
    wgmma_fence();
    use_p();
    use_ds();
  } else {
    wgmma_wait<1>();  // s has landed; dp may still be in flight
    keep(s);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      int query, key;
      float l2, d;
      at(j, query, key, l2, d);
      const float p = ex2(fmaf(s[j], c, -l2));
      s[j] = (kMask && !visible(query, key, S, causal, window)) ? 0.f : p;
    }
    if constexpr (kWithP) split_fragments(s, p_hi, p_lo);
    wgmma_wait<0>();
    keep(dp);
    if constexpr (kWithP) {
      wgmma_fence();
      use_p();
      wgmma_commit();
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      int query, key;
      float l2, d;
      at(j, query, key, l2, d);
      dp[j] = s[j] * (dp[j] - d);
    }
    split_fragments(dp, ds_hi, ds_lo);
    wgmma_fence();
    use_ds();
  }
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (kWithP) {
    keep(p_hi);
    keep(p_lo);
  }
  keep(ds_hi);
  keep(ds_lo);
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmdo, const float* __restrict__ Lg,
                     const float* __restrict__ Dg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv, int B, int H,
                     int KV, int S, int causal, int window, float scale, float softcap) {
  using namespace hopper;
  using T = Tiles<HD>;
  using W = Wg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);                 // W::OWN tiles: the block's keys
  uint8_t* sV = sK + W::OWN * T::TILE;               // W::OWN tiles
  uint8_t* sQ = sV + W::OWN * T::TILE;               // kTcStages tiles
  uint8_t* sdO = sQ + kTcStages * T::TILE;           // kTcStages tiles
  float* sL = reinterpret_cast<float*>(sdO + kTcStages * T::TILE);  // kTcStages × 64
  float* sD = sL + kTcStages * kRows;                // kTcStages × 64
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sD + kTcStages * kRows);
  uint64_t* bar_full = bar_kv + 1;                   // a stage's Q, dO, lse and D landed
  uint64_t* bar_empty = bar_full + kTcStages;        // every consumer warp is done with it

  // key tiles nearest the start first (they see the most queries)
  const int group = H / KV, Sp = padded(S);
  const int kvh = blockIdx.x % KV, b = (blockIdx.x / KV) % B;
  const int k0 = static_cast<int>(blockIdx.x / (KV * B)) * W::ROWS;
  // the query tiles some row of which sees one of keys k0 .. k_last
  const int k_last = min(k0 + W::ROWS, S) - 1;
  const int qt_lo = causal ? k0 / kRows : 0;
  const int qt_hi = (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / kRows;
  const int nq = qt_hi - qt_lo + 1, n_iter = group * nq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kTcConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTcConsumers / 32) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kTcConsumers) {
      mbar_expect_tx(bar_kv, 2 * W::OWN * T::TILE);
      for (int c = 0; c < W::OWN; ++c)
        for (int cb = 0; cb < T::NCB; ++cb) {
          tma_load(sK + c * T::TILE + cb * T::BLOCK, &tmk, bar_kv, cb * T::CB, k0 + kRows * c,
                   kvh, b);
          tma_load(sV + c * T::TILE + cb * T::BLOCK, &tmv, bar_kv, cb * T::CB, k0 + kRows * c,
                   kvh, b);
        }
      for (int i = 0; i < n_iter; ++i) {
        const int st = i % kTcStages, h = kvh * group + i / nq;
        const int q0 = (qt_lo + i % nq) * kRows;
        if (i >= kTcStages) mbar_wait(&bar_empty[st], (i / kTcStages - 1) & 1);
        mbar_expect_tx(&bar_full[st], 2 * T::TILE + 2 * kRows * 4);
        for (int cb = 0; cb < T::NCB; ++cb) {
          tma_load(sQ + st * T::TILE + cb * T::BLOCK, &tmq, &bar_full[st], cb * T::CB, q0, h, b);
          tma_load(sdO + st * T::TILE + cb * T::BLOCK, &tmdo, &bar_full[st], cb * T::CB, q0, h,
                   b);
        }
        const long long row = ((long long)b * H + h) * Sp + q0;
        bulk_load(sL + st * kRows, Lg + row, kRows * 4, &bar_full[st]);
        bulk_load(sD + st * kRows, Dg + row, kRows * 4, &bar_full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // a consumer warpgroup: keys kw0 .. kw0 + 63 and output columns col0 ..
  // col0 + W::COLS − 1; this thread holds keys key0 and key0 + 8
  // (accumulator rows), queries 8j + 2·t4 + {0, 1} of a tile
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int own = W::kSplit ? 0 : wg, col0 = W::kSplit ? wg * W::COLS : 0;
  const int kw0 = k0 + kRows * own, kw1 = min(kw0 + kRows - 1, S - 1);
  const int key0 = kw0 + 16 * (warp % 4) + g;
  const uint8_t* k_tile = sK + own * T::TILE;
  const uint8_t* v_tile = sV + own * T::TILE;
  const int cols = col0 / T::CB * T::BLOCK;          // bytes to this warpgroup's columns
  const float c = scale * kLog2e;

  float acc_k[W::COLS / 2], acc_v[W::COLS / 2];
#pragma unroll
  for (int i = 0; i < W::COLS / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int st = i % kTcStages, q0 = (qt_lo + i % nq) * kRows;
    mbar_wait(&bar_full[st], (i / kTcStages) & 1);
    const int q_last = min(q0 + kRows, S) - 1;
    if (kw0 < S && (!causal || q_last >= kw0) && (window <= 0 || q0 - window + 1 <= kw1)) {
      const uint8_t* q_tile = sQ + st * T::TILE;
      const uint8_t* do_tile = sdO + st * T::TILE;
      const float* l = sL + st * kRows;
      const float* d = sD + st * kRows;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warpgroup's keys × the tile's queries
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      wgmma_fence();
      scores<HD>(s, k_tile, q_tile);
      wgmma_commit();
      scores<HD>(dp, v_tile, do_tile);
      wgmma_commit();
      // then dV += Pᵀ·dO and dK += dSᵀ·Q over the tile's queries in steps of 16
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      const auto at = [&](int j, int& query, int& key, float& l2, float& dd) {
        const int qi = 8 * (j >> 2) + 2 * t4 + (j & 1);
        query = q0 + qi;
        key = key0 + 8 * ((j >> 1) & 1);
        l2 = l[qi];
        dd = d[qi];
      };
      const auto use_p = [&] {
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t desc = T::row_desc(do_tile + cols, kk);
          wgmma_rs<W::COLS>(acc_v, p_hi[kk], desc);
          wgmma_rs<W::COLS>(acc_v, p_lo[kk], desc);
        }
      };
      const auto use_ds = [&] {
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t desc = T::row_desc(q_tile + cols, kk);
          wgmma_rs<W::COLS>(acc_k, ds_hi[kk], desc);
          wgmma_rs<W::COLS>(acc_k, ds_lo[kk], desc);
        }
      };
      if (all_visible(q0, kw0, S, causal, window))
        tile_elementwise<kCap, false, true>(s, dp, p_hi, p_lo, ds_hi, ds_lo, at, S, causal,
                                            window, c, softcap, use_p, use_ds);
      else
        tile_elementwise<kCap, true, true>(s, dp, p_hi, p_lo, ds_hi, ds_lo, at, S, causal, window,
                                           c, softcap, use_p, use_ds);
      keep(acc_v);
      keep(acc_k);
    }
    if (lane == 0) mbar_arrive(&bar_empty[st]);
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    uint32_t* dst_k = reinterpret_cast<uint32_t*>(dkb + key * sdk.s + col0 + 2 * t4);
    uint32_t* dst_v = reinterpret_cast<uint32_t*>(dvb + key * sdv.s + col0 + 2 * t4);
#pragma unroll
    for (int j = 0; j < W::COLS / 8; ++j) {
      dst_k[4 * j] = pack_bf16(acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
      dst_v[4 * j] = pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmdo, const float* __restrict__ Lg,
                   const float* __restrict__ Dg, __nv_bfloat16* __restrict__ dq, Strides sdq,
                   int B, int H, int KV, int S, int causal, int window, float scale,
                   float softcap) {
  using namespace hopper;
  using T = Tiles<HD>;
  using W = Wg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);                 // W::OWN tiles: the block's queries
  uint8_t* sdO = sQ + W::OWN * T::TILE;              // W::OWN tiles
  uint8_t* sK = sdO + W::OWN * T::TILE;              // kTcStages tiles
  uint8_t* sV = sK + kTcStages * T::TILE;            // kTcStages tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + kTcStages * T::TILE);
  uint64_t* bar_full = bar_q + 1;                    // a stage's K and V landed
  uint64_t* bar_empty = bar_full + kTcStages;        // every consumer warp is done with it

  // longest query tiles first; the heads of one KV head adjacent
  const int nq = (S + W::ROWS - 1) / W::ROWS, group = H / KV;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B, kvh = h / group;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / (H * B))) * W::ROWS;
  // the key tiles some row in [r0, r1] sees
  const auto tile_range = [&](int r0, int r1, int& lo, int& hi) {
    hi = causal ? r1 / kRows : (S - 1) / kRows;
    lo = (window > 0 && r0 - window + 1 > 0) ? (r0 - window + 1) / kRows : 0;
  };
  int kt_lo, kt_hi;
  tile_range(q0, min(q0 + W::ROWS, S) - 1, kt_lo, kt_hi);
  const int n_tiles = kt_hi - kt_lo + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kTcConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTcConsumers / 32) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kTcConsumers) {
      mbar_expect_tx(bar_q, 2 * W::OWN * T::TILE);
      for (int c = 0; c < W::OWN; ++c)
        for (int cb = 0; cb < T::NCB; ++cb) {
          tma_load(sQ + c * T::TILE + cb * T::BLOCK, &tmq, bar_q, cb * T::CB, q0 + kRows * c, h,
                   b);
          tma_load(sdO + c * T::TILE + cb * T::BLOCK, &tmdo, bar_q, cb * T::CB, q0 + kRows * c,
                   h, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kTcStages, k0 = (kt_lo + i) * kRows;
        if (i >= kTcStages) mbar_wait(&bar_empty[st], (i / kTcStages - 1) & 1);
        mbar_expect_tx(&bar_full[st], 2 * T::TILE);
        for (int cb = 0; cb < T::NCB; ++cb) {
          tma_load(sK + st * T::TILE + cb * T::BLOCK, &tmk, &bar_full[st], cb * T::CB, k0, kvh,
                   b);
          tma_load(sV + st * T::TILE + cb * T::BLOCK, &tmv, &bar_full[st], cb * T::CB, k0, kvh,
                   b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // a consumer warpgroup: queries wr0 .. wr0 + 63 and output columns col0
  // .. col0 + W::COLS − 1; this thread holds rows row0 and row0 + 8, keys
  // 8j + 2·t4 + {0, 1} of a tile
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int own = W::kSplit ? 0 : wg, col0 = W::kSplit ? wg * W::COLS : 0;
  const int wr0 = q0 + kRows * own, row0 = wr0 + 16 * (warp % 4) + g;
  int w_lo = 0, w_hi = -1;  // the key tiles this warpgroup's rows see
  if (wr0 < S) tile_range(wr0, min(wr0 + kRows, S) - 1, w_lo, w_hi);
  const uint8_t* q_tile = sQ + own * T::TILE;
  const uint8_t* do_tile = sdO + own * T::TILE;
  const int cols = col0 / T::CB * T::BLOCK;          // bytes to this warpgroup's columns
  const long long lrow = ((long long)b * H + h) * padded(S);
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < S ? Lg[lrow + row] : 0.f;
    dr[r] = row < S ? Dg[lrow + row] : 0.f;
  }
  const float c = scale * kLog2e;

  float acc[W::COLS / 2];
#pragma unroll
  for (int i = 0; i < W::COLS / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kTcStages, kt = kt_lo + i, k0 = kt * kRows;
    mbar_wait(&bar_full[st], (i / kTcStages) & 1);
    if (kt >= w_lo && kt <= w_hi) {
      const uint8_t* k_tile = sK + st * T::TILE;
      // S = Q·Kᵀ and dP = dO·Vᵀ: this warpgroup's queries × the tile's keys
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      wgmma_fence();
      scores<HD>(s, q_tile, k_tile);
      wgmma_commit();
      scores<HD>(dp, do_tile, sV + st * T::TILE);
      wgmma_commit();
      // then dQ += dS·K over the tile's keys in steps of 16 (P feeds no product)
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      const auto at = [&](int j, int& query, int& key, float& ll, float& dd) {
        const int r = (j >> 1) & 1;
        query = row0 + 8 * r;
        key = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
        ll = l2[r];
        dd = dr[r];
      };
      const auto use_ds = [&] {
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t desc = T::row_desc(k_tile + cols, kk);
          wgmma_rs<W::COLS>(acc, ds_hi[kk], desc);
          wgmma_rs<W::COLS>(acc, ds_lo[kk], desc);
        }
      };
      const auto none = [] {};
      if (all_visible(wr0, k0, S, causal, window))
        tile_elementwise<kCap, false, false>(s, dp, p_hi, p_lo, ds_hi, ds_lo, at, S, causal,
                                             window, c, softcap, none, use_ds);
      else
        tile_elementwise<kCap, true, false>(s, dp, p_hi, p_lo, ds_hi, ds_lo, at, S, causal,
                                            window, c, softcap, none, use_ds);
      keep(acc);
    }
    if (lane == 0) mbar_arrive(&bar_empty[st]);
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(dqb + row * sdq.s + col0 + 2 * t4);
#pragma unroll
    for (int j = 0; j < W::COLS / 8; ++j)
      dst[4 * j] = pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------ host side

// the route of a dK/dV or dQ launch, chosen by the wrapper
constexpr int kRouteF32 = 0;           // f32: CUDA cores
constexpr int kRouteTensorCores = 2;   // bf16: wgmma

struct Args {
  const void *q, *k, *v, *dO;
  const float *L, *D;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, KV, S, causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <int HD>
int launch_dkdv(const Args& a) {
  constexpr size_t smem = Cfg<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + Cfg<HD>::BT - 1) / Cfg<HD>::BT, a.KV, a.B);
  flash_bwd_dkdv<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.L, a.D,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk,
      a.sdv, a.H, a.H / a.KV, a.S, a.causal, a.window, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const Args& a) {
  constexpr size_t smem = Cfg<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + Cfg<HD>::BT - 1) / Cfg<HD>::BT, a.H, a.B);
  flash_bwd_dq<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.L, a.D,
      static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, a.H / a.KV, a.S, a.causal,
      a.window, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kCap>
int launch_wgmma(int pass, const Args& a) {
  using T = hopper::Tiles<HD>;
  CUtensorMap mq, mk, mv, mdo;
  int err = hopper::make_map(&mq, a.q, HD, a.S, a.H, a.B, a.sq.s, a.sq.h, a.sq.b, T::CB,
                             T::SWIZZLE);
  if (err == 0)
    err = hopper::make_map(&mk, a.k, HD, a.S, a.KV, a.B, a.sk.s, a.sk.h, a.sk.b, T::CB,
                           T::SWIZZLE);
  if (err == 0)
    err = hopper::make_map(&mv, a.v, HD, a.S, a.KV, a.B, a.sv.s, a.sv.h, a.sv.b, T::CB,
                           T::SWIZZLE);
  if (err == 0)
    err = hopper::make_map(&mdo, a.dO, HD, a.S, a.H, a.B, a.sdo.s, a.sdo.h, a.sdo.b, T::CB,
                           T::SWIZZLE);
  if (err != 0) return err;
  using B16 = __nv_bfloat16;
  const long long tiles = (a.S + Wg<HD>::ROWS - 1) / Wg<HD>::ROWS;
  cudaError_t attr;
  if (pass == 0) {
    constexpr size_t smem = Wg<HD>::SMEM_DKDV;
    attr = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<HD, kCap>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_bwd_dkdv_wgmma<HD, kCap><<<static_cast<unsigned>(tiles * a.KV * a.B), kTcThreads,
                                     smem, a.stream>>>(
        mq, mk, mv, mdo, a.L, a.D, static_cast<B16*>(a.dk), static_cast<B16*>(a.dv), a.sdk,
        a.sdv, a.B, a.H, a.KV, a.S, a.causal, a.window, a.scale, a.softcap);
  } else {
    constexpr size_t smem = Wg<HD>::SMEM_DQ;
    attr = cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD, kCap>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_bwd_dq_wgmma<HD, kCap><<<static_cast<unsigned>(tiles * a.H * a.B), kTcThreads, smem,
                                   a.stream>>>(mq, mk, mv, mdo, a.L, a.D, static_cast<B16*>(a.dq),
                                               a.sdq, a.B, a.H, a.KV, a.S, a.causal, a.window,
                                               a.scale, a.softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma_hd(int pass, const Args& a) {
  return a.softcap > 0.f ? launch_wgmma<HD, true>(pass, a) : launch_wgmma<HD, false>(pass, a);
}

template <int HD>
int launch_pass(int pass, const Args& a) {
  return pass == 0 ? launch_dkdv<HD>(a) : launch_dq<HD>(a);
}

int dispatch_f32(int pass, int hd, const Args& a) {
  switch (hd) {
    case 16: return launch_pass<16>(pass, a);
    case 32: return launch_pass<32>(pass, a);
    case 64: return launch_pass<64>(pass, a);
    case 128: return launch_pass<128>(pass, a);
    case 256: return launch_pass<256>(pass, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_wgmma(int pass, int hd, const Args& a) {
  switch (hd) {
    case 16: return launch_wgmma_hd<16>(pass, a);
    case 32: return launch_wgmma_hd<32>(pass, a);
    case 64: return launch_wgmma_hd<64>(pass, a);
    case 128: return launch_wgmma_hd<128>(pass, a);
    case 256: return launch_wgmma_hd<256>(pass, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int pass, const void* q, const void* k, const void* v, const void* dO, const float* L,
        const float* D, void* dq, void* dk, void* dv, const long long* st, int B, int H, int KV,
        int S, int hd, int causal, int window, float scale, float softcap, int route,
        void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dO, L, D, dq, dk, dv,
               {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
               {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
               {st[18], st[19], st[20]},
               B, H, KV, S, causal, window, scale, softcap, static_cast<cudaStream_t>(stream)};
  switch (route) {
    case kRouteF32: return dispatch_f32(pass, hd, a);
    case kRouteTensorCores: return dispatch_wgmma(pass, hd, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int V, typename T>
void launch_prep(const void* o, const void* dO, const float* lse, float* L, float* D, Strides so,
                 Strides sd, int H, int S, int hd, long long rows, cudaStream_t stream) {
  const long long threads = rows * (hd / V < 32 ? hd / V : 32);
  flash_bwd_prep<V, T><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dO), lse, L,
                                   D, so, sd, H, S, hd, rows);
}

}  // namespace

// D = rowsum(dO ∘ O) and L = lse·log2(e) from the forward's lse (B, H, S),
// both written (B, H, Sp) f32 with Sp = S rounded up to 64 and zeros past
// S. o and dO f32 or bf16 (bf16 != 0), strides (batch, head, sequence) in
// elements.
extern "C" int flash_attention_bwd_prep(const void* o, const void* dO, const float* lse,
                                        float* L, float* D, long long ob, long long oh,
                                        long long os, long long db, long long dh, long long ds,
                                        int B, int H, int S, int hd, int bf16, void* stream) {
  const long long rows = (long long)B * H * padded(S);
  if (rows == 0) return 0;
  const Strides so{ob, oh, os}, sd{db, dh, ds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte chunks where every row of o and dO starts on a 16-byte boundary
  const int v = bf16 ? 8 : 4;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dO)) % 16 == 0 &&
      (ob | oh | os | db | dh | ds | hd) % v == 0;
  if (bf16 && aligned) launch_prep<8, __nv_bfloat16>(o, dO, lse, L, D, so, sd, H, S, hd, rows, st);
  else if (bf16) launch_prep<1, __nv_bfloat16>(o, dO, lse, L, D, so, sd, H, S, hd, rows, st);
  else if (aligned) launch_prep<4, float>(o, dO, lse, L, D, so, sd, H, S, hd, rows, st);
  else launch_prep<1, float>(o, dO, lse, L, D, so, sd, H, S, hd, rows, st);
  return static_cast<int>(cudaGetLastError());
}

// dK and dV (flash_attention_bwd_dkdv) or dQ (flash_attention_bwd_dq). Both
// take the same arguments: q, k, v, dO, L and D (prep's padded outputs), dq,
// dk, dv (the entry writes only its own outputs), then the (batch, head,
// sequence) element strides of q, k, v, dO, dq, dk and dv in that order, the
// sizes, the mask, the scale, the soft-cap (0: none) and the route: 0 f32 on
// the CUDA cores, 2 bf16 on the tensor cores (q, k, v and dO with strides in
// multiples of 8 elements on 16-byte aligned bases).
#define FLASH_BWD_ENTRY(NAME, PASS)                                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dO,               \
                      const float* L, const float* D, void* dq, void* dk, void* dv,              \
                      long long s0, long long s1, long long s2, long long s3, long long s4,      \
                      long long s5, long long s6, long long s7, long long s8, long long s9,       \
                      long long s10, long long s11, long long s12, long long s13, long long s14, \
                      long long s15, long long s16, long long s17, long long s18, long long s19, \
                      long long s20, int B, int H, int KV, int S, int hd, int causal,            \
                      int window, float scale, float softcap, int route, void* stream) {         \
    const long long st[21] = {s0,  s1,  s2,  s3,  s4,  s5,  s6,  s7,  s8,  s9, s10,              \
                              s11, s12, s13, s14, s15, s16, s17, s18, s19, s20};                 \
    return run(PASS, q, k, v, dO, L, D, dq, dk, dv, st, B, H, KV, S, hd, causal, window,         \
               scale, softcap, route, stream);                                                   \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_dkdv, 0)
FLASH_BWD_ENTRY(flash_attention_bwd_dq, 1)
