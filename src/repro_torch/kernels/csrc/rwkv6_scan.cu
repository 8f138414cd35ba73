// rwkv6_scan.cu — the chunked RWKV6 wkv recurrence on Hopper (sm_90a):
// chunk-parallel passes with the products on the tensor cores, and a decode
// route for one token.
//
// Per (batch, head), state S ∈ R^{hd×hd}, decay w_t = exp(logw_t) ≤ 1:
//     o_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t)
//     S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t                S_{-1} = S0 (or 0)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// and with it the chunk loop of the model's rwkv_time_mix (src/repro/models/
// rwkv6.py:90-121, :156-183): the same chunkwise form in chunks of W tokens,
// with c = Σ logw (inclusive, within the chunk) and c_excl = c − logw:
//     o_t  = (r_t ⊙ e^{c_excl,t}) · S_in
//          + Σ_{j<t} [Σ_d r_td k_jd e^{c_excl,td − c_jd}] v_j + (r_t · (u ⊙ k_t)) v_t
//     S_out = S_in ⊙ e^{c_W} + Σ_j (k_j ⊙ e^{c_W − c_j}) ⊗ v_j
// Unlike the TPU kernel it takes an initial state and any S: a ragged last
// chunk is zero-padded (logw = 0, k = 0), which leaves c_W and the state as
// the real tokens give them.
//
// Bound: bytes. r, k, v (bf16 on the serve path) and logw (f32) are read
// and o (f32) written once: 704 MB at rwkv6-3b's serve shape (B = 4, H = 48,
// S = 4096, hd = 64), 0.21 ms at 3.35 TB/s, while the chunked form's
// products are 1.9e10 flops (0.04 ms at the TF32 rate). The design before
// this one ran one block per (batch, head) down the chunks (192 blocks on
// 132 SMs) with W²·hd/2 exponentials a chunk on the CUDA cores.
//
// Design: three launches, chunk-parallel where the work is.
//   1. states, one block per (b, h, chunk): the chunk's own contribution
//      U = Σ_j (k_j ⊙ e^{c_W − c_j}) ⊗ v_j and its decay e^{c_W}, into a
//      scratch buffer (B, H, chunks, hd, hd).
//   2. scan, one thread per four state entries of a row: S_in of each chunk
//      in place of its U (S ← e^{c_W} ⊙ S + U, in f32, down the chunks, the
//      loads of 8 chunks in flight), and S_final.
//   3. outputs, one block per (b, h, chunk): o from r, k, v, logw and S_in.
// Passes 1 and 3 stay apart because pass 3 needs every earlier chunk's
// state; pass 2 is an elementwise scan (each entry of S evolves alone), so
// it runs at the byte rate.
// Fewer exponentials: the chunk is cut into sub-chunks of 16 tokens.
// With b_i the first token of sub-chunk i, e_j the last of sub-chunk j < i:
//     e^{c_excl,t − c_s} = e^{c_excl,t − c_excl,b_i} · e^{c_excl,b_i − c_e_j} · e^{c_e_j − c_s}
// All three exponents are ≤ 0 (c falls along the chunk), so nothing can
// overflow. The first factor is one array r̂ (each row against its own
// sub-chunk's start), the last one array k̂ (each row against its own
// sub-chunk's end), the middle a vector per block pair: an off-diagonal
// 16 × 16 block of the pair matrix is one product (r̂_i ⊙ g_ij) · k̂_jᵀ. Only
// the four diagonal blocks keep per-pair exponentials (4·136·hd against
// W²·hd/2 = 131,072 before). The cross-chunk term reuses r̂: e^{c_excl,t} =
// e^{c_excl,t − c_excl,b_i} · e^{c_excl,b_i}.
// Products on the tensor cores: mma.sync m16n8k8 TF32 with f32 accumulation,
// every operand split into hi + lo TF32 halves and three products (hi·hi,
// hi·lo, lo·hi): the operands are f32 after scaling, and the split keeps
// about 21 significant bits, as near f32 as the tolerance of the plain
// version asks (2e-3 relative) and the f32 model's 1e-4 parity needs. A
// bf16 v is exact in TF32, so products with v skip its lo half.
// Shared-memory rows are padded (68 floats where a fragment reads along
// rows, 72 where it reads down columns) so a fragment load hits 32
// different banks. Where hd = 64 and the rows are 16-byte aligned (the
// serve path), a block issues all its tile loads as 16-byte loads before
// it stores the first, so they are in flight together. Measured on the
// H100 at the serve shape (PERF.md): the diagonal blocks' per-pair loop is
// the largest compute cost (shared-memory bound), the rest of the time is
// the passes' memory traffic (about 1.9 GB: the scratch states are written
// and read twice).
//
// Decode (S = 1): its own launch. Blocks of 16 state columns × 8 row groups
// (4 blocks per head at hd = 64, 768 at the serve shape), each reading and
// writing its slice of the state once.
//
// Layout: r, k, v, logw and o are (B, H, S, hd) with hd contiguous and any
// (batch, head, sequence) strides in elements, so the model's (B, S, H, hd)
// activations go in and out without a copy; u is (H, hd), S0 and S_final
// (B, H, hd, hd), contiguous f32. hd ≤ 64, W ≤ 64.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// does not synchronise, allocates nothing (the wrapper passes the scratch),
// returns cudaGetLastError().

#include "rwkv6.cuh"

namespace {

constexpr int kSub = 16;          // sub-chunk

// ------------------------------------------------- pass 1: chunk states

// U = Σ_j (k_j ⊙ e^{c_W − c_j}) ⊗ v_j (hd × hd) and e^{c_W} (hd) of chunk
// blockIdx.x of (b, h) = (blockIdx.z, blockIdx.y)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rwkv6_states(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
             float* __restrict__ U, float* __restrict__ dec, Strides sk_, Strides sv_,
             Strides sw_, int H, int S, int hd, int W) {
  extern __shared__ float smem[];
  float* sK = smem;                 // k, then k ⊙ e^{c_W − c}: A = (that)ᵀ, down columns
  float* sV = sK + kN * kCol;       // v: B, down columns
  float* sC = sV + kN * kCol;       // c · log2 e
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = n * W, nt = min(W, S - t0);
  const int chunks = gridDim.x;
  {
    Tile<T, VEC> tk, tv;
    Tile<float, VEC> tw;
    tk.fetch(k + b * sk_.b + h * sk_.h, sk_.s, t0, nt, hd);
    if (!VEC) tk.put(sK, kCol);
    tv.fetch(v + b * sv_.b + h * sv_.h, sv_.s, t0, nt, hd);
    if (!VEC) tv.put(sV, kCol);
    tw.fetch(logw + b * sw_.b + h * sw_.h, sw_.s, t0, nt, hd);
    if (VEC) {
      tk.put(sK, kCol);
      tv.put(sV, kCol);
    }
    tw.put(sC, kN, kLog2e);
  }
  __syncthreads();
  column_cumsum<kN>(sC);
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) {
    const int t = i / kN, d = i % kN;
    sK[t * kCol + d] *= exp2f(sC[(kN - 1) * kN + d] - sC[t * kN + d]);
  }
  const long long item = ((long long)b * H + h) * chunks + n;
  if (threadIdx.x < hd) dec[item * hd + threadIdx.x] = exp2f(sC[(kN - 1) * kN + threadIdx.x]);
  __syncthreads();

  // U (64 × 64): warp w owns rows 16·(w / 2).., columns 32·(w % 2).. (4 n-tiles)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int m0 = 16 * (warp / 2), n0 = 32 * (warp % 2);
  float acc[4][4] = {};
  warp_mma<std::is_same<T, __nv_bfloat16>::value>(acc, sK, 1, kCol, sV, kCol, 1, m0, n0);
  float* Ub = U + item * hd * hd;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = m0 + g + 8 * r;
      if (d >= hd) continue;
      if (e < hd) Ub[d * hd + e] = acc[j][2 * r];
      if (e + 1 < hd) Ub[d * hd + e + 1] = acc[j][2 * r + 1];
    }
  }
}

// ------------------------------------------------------- pass 2: the scan

// per PER state entries (one row d) of (b, h) = (blockIdx.z, blockIdx.y):
// U[n] <- S_in of chunk n, S <- e^{c_W} ⊙ S + U[n]; S_final out. The loads
// of kGroup chunks are issued together: the chain runs through S only.
constexpr int kGroup = 8;

template <int PER>
__global__ void __launch_bounds__(kThreads)
rwkv6_state_scan(float* __restrict__ U, const float* __restrict__ dec,
                 const float* __restrict__ s0, float* __restrict__ s_out, int H, int hd,
                 int chunks) {
  using Vec = typename std::conditional<PER == 4, float4, float>::type;
  const int idx = (blockIdx.x * kThreads + threadIdx.x) * PER;
  if (idx >= hd * hd) return;
  const int h = blockIdx.y, b = blockIdx.z, d = idx / hd;
  const long long bh = (long long)b * H + h;
  const long long step = (long long)hd * hd / PER;   // one chunk, in Vec
  Vec* u = reinterpret_cast<Vec*>(U + bh * chunks * hd * hd + idx);
  const float* w = dec + bh * chunks * hd + d;
  float st[PER];
#pragma unroll
  for (int x = 0; x < PER; ++x) st[x] = s0 ? s0[bh * hd * hd + idx + x] : 0.f;
  for (int n0 = 0; n0 < chunks; n0 += kGroup) {
    Vec un[kGroup];
    float wn[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (n0 + i < chunks) {
        un[i] = u[(n0 + i) * step];
        wn[i] = w[(long long)(n0 + i) * hd];
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (n0 + i >= chunks) break;
      const float* uf = reinterpret_cast<const float*>(&un[i]);
      Vec out;
      float* of = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int x = 0; x < PER; ++x) {
        of[x] = st[x];
        st[x] = wn[i] * st[x] + uf[x];
      }
      u[(n0 + i) * step] = out;
    }
  }
#pragma unroll
  for (int x = 0; x < PER; ++x) s_out[bh * hd * hd + idx + x] = st[x];
}

// ------------------------------------------------------ pass 3: outputs

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rwkv6_outputs(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ logw, const float* __restrict__ u,
              const float* __restrict__ s_in, float* __restrict__ o, Strides sr_, Strides sk_,
              Strides sv_, Strides sw_, Strides so_, int H, int S, int hd, int W) {
  extern __shared__ float smem[];
  float* sR = smem;                 // r, then r̂            (A, along rows)
  float* sK = sR + kN * kRow;       // k, then k̂            (B of r̂·k̂ᵀ, along rows)
  float* sA = sK + kN * kRow;       // pair matrix           (A, along rows)
  float* sV = sA + kN * kRow;       // v                     (B, down columns)
  float* sS = sV + kN * kCol;       // S_in                  (B, down columns)
  float* sC = sS + kN * kCol;       // c · log2 e, inclusive (row stride kC)
  float* sG = sC + kN * kC;         // g_ij (6 block pairs j < i), then h_i (4)
  float* sU = sG + 10 * kN;         // u
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = n * W, nt = min(W, S - t0);
  const long long item = ((long long)b * H + h) * gridDim.x + n;
  {
    Tile<T, VEC> tr, tk, tv;
    Tile<float, VEC> tw, ts;
    tr.fetch(r + b * sr_.b + h * sr_.h, sr_.s, t0, nt, hd);
    if (!VEC) tr.put(sR, kRow);
    tk.fetch(k + b * sk_.b + h * sk_.h, sk_.s, t0, nt, hd);
    if (!VEC) tk.put(sK, kRow);
    tv.fetch(v + b * sv_.b + h * sv_.h, sv_.s, t0, nt, hd);
    if (!VEC) tv.put(sV, kCol);
    tw.fetch(logw + b * sw_.b + h * sw_.h, sw_.s, t0, nt, hd);
    if (!VEC) tw.put(sC, kC, kLog2e);
    ts.fetch(s_in + item * hd * hd, hd, 0, hd, hd);
    if (VEC) {
      tr.put(sR, kRow);
      tk.put(sK, kRow);
      tv.put(sV, kCol);
      tw.put(sC, kC, kLog2e);
    }
    ts.put(sS, kCol);
  }
  if (threadIdx.x < kN) sU[threadIdx.x] = threadIdx.x < hd ? u[h * hd + threadIdx.x] : 0.f;
  __syncthreads();
  column_cumsum<kC>(sC);

  // the pair matrix's upper triangle is 0; its four diagonal blocks take
  // per-pair exponentials (clamped at 0), the u-bonus on the diagonal
  for (int i = threadIdx.x; i < kN * kN; i += kThreads)
    if (i % kN > i / kN) sA[(i / kN) * kRow + i % kN] = 0.f;
  for (int item2 = threadIdx.x; item2 < 4 * 136; item2 += kThreads) {
    const int blk = item2 / 136;
    int p = item2 % 136, tt = 0;
    while (p > tt) p -= ++tt;  // (tt, p): p ≤ tt
    const int t = kSub * blk + tt, s = kSub * blk + p;
    float a = 0.f;
    if (s < t) {
      for (int d = 0; d < kN; ++d)
        a += sR[t * kRow + d] * sK[s * kRow + d] *
             exp2f(fminf(sC[(t - 1) * kC + d] - sC[s * kC + d], 0.f));
    } else {
      for (int d = 0; d < kN; ++d) a += sR[t * kRow + d] * (sU[d] * sK[t * kRow + d]);
    }
    sA[t * kRow + s] = a;
  }
  __syncthreads();

  // r̂ = r ⊙ e^{c_excl,t − c_excl,b_i}, k̂ = k ⊙ e^{c_e_i − c_t} (i: row's sub-chunk)
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) {
    const int t = i / kN, d = i % kN, b0 = t & ~(kSub - 1);
    const float start = b0 > 0 ? sC[(b0 - 1) * kC + d] : 0.f;
    const float excl = t > 0 ? sC[(t - 1) * kC + d] : 0.f;
    sR[t * kRow + d] *= exp2f(excl - start);
    sK[t * kRow + d] *= exp2f(sC[(b0 + kSub - 1) * kC + d] - sC[t * kC + d]);
  }
  // g_ij = e^{c_excl,b_i − c_e_j} (j < i; pair index i(i−1)/2 + j), h_i = e^{c_excl,b_i}
  for (int i = threadIdx.x; i < 10 * kN; i += kThreads) {
    const int pair = i / kN, d = i % kN;
    if (pair < 6) {
      const int bi = pair < 1 ? 1 : pair < 3 ? 2 : 3, bj = pair - bi * (bi - 1) / 2;
      sG[i] = exp2f(sC[(kSub * bi - 1) * kC + d] - sC[(kSub * bj + kSub - 1) * kC + d]);
    } else {
      const int bi = pair - 6;
      sG[i] = bi > 0 ? exp2f(sC[(kSub * bi - 1) * kC + d]) : 1.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  // off-diagonal blocks (i, j), j < i: 6 blocks × 2 n-tiles, (r̂_i ⊙ g_ij)·k̂_jᵀ
  for (int task = warp; task < 12; task += kThreads / 32) {
    const int pair = task / 2;
    const int bi = pair < 1 ? 1 : pair < 3 ? 2 : 3, bj = pair - bi * (bi - 1) / 2;
    const int m0 = kSub * bi, c0 = kSub * bj + 8 * (task % 2);
    const float* gv = sG + pair * kN;
    float acc[4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kN; k0 += 8) {
      const float a[4] = {sR[(m0 + g) * kRow + k0 + q] * gv[k0 + q],
                          sR[(m0 + g + 8) * kRow + k0 + q] * gv[k0 + q],
                          sR[(m0 + g) * kRow + k0 + q + 4] * gv[k0 + q + 4],
                          sR[(m0 + g + 8) * kRow + k0 + q + 4] * gv[k0 + q + 4]};
      const float bb[2] = {sK[(c0 + g) * kRow + k0 + q], sK[(c0 + g) * kRow + k0 + q + 4]};
      mma_3xtf32(acc, a, bb);
    }
    sA[(m0 + g) * kRow + c0 + 2 * q] = acc[0];
    sA[(m0 + g) * kRow + c0 + 2 * q + 1] = acc[1];
    sA[(m0 + g + 8) * kRow + c0 + 2 * q] = acc[2];
    sA[(m0 + g + 8) * kRow + c0 + 2 * q + 1] = acc[3];
  }
  __syncthreads();

  // o = (r̂ ⊙ h_i)·S_in + A·V: warp w owns rows 16·(w / 2).. (one sub-chunk),
  // columns 32·(w % 2).. (4 n-tiles)
  const int m0 = 16 * (warp / 2), n0 = 32 * (warp % 2);
  const float* hv = sG + (6 + warp / 2) * kN;
  float acc[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kN; k0 += 8) {
    const float a[4] = {sR[(m0 + g) * kRow + k0 + q] * hv[k0 + q],
                        sR[(m0 + g + 8) * kRow + k0 + q] * hv[k0 + q],
                        sR[(m0 + g) * kRow + k0 + q + 4] * hv[k0 + q + 4],
                        sR[(m0 + g + 8) * kRow + k0 + q + 4] * hv[k0 + q + 4]};
    const float p[4] = {sA[(m0 + g) * kRow + k0 + q], sA[(m0 + g + 8) * kRow + k0 + q],
                        sA[(m0 + g) * kRow + k0 + q + 4], sA[(m0 + g + 8) * kRow + k0 + q + 4]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = n0 + 8 * j + g;
      const float bs[2] = {sS[(k0 + q) * kCol + e], sS[(k0 + q + 4) * kCol + e]};
      const float bv[2] = {sV[(k0 + q) * kCol + e], sV[(k0 + q + 4) * kCol + e]};
      mma_3xtf32(acc[j], a, bs);
      mma_3xtf32<std::is_same<T, __nv_bfloat16>::value>(acc[j], p, bv);
    }
  }
  float* ob = o + b * so_.b + h * so_.h;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = m0 + g + 8 * rr;
      if (t >= nt || e >= hd) continue;
      float* dst = &ob[(long long)(t0 + t) * so_.s + e];
      if (e + 1 < hd)  // hd even: o's rows are 8-byte aligned
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
      else
        dst[0] = acc[j][2 * rr];
    }
  }
}

constexpr size_t kStatesSmem = sizeof(float) * (2 * kN * kCol + kN * kN);
constexpr size_t kOutputsSmem =
    sizeof(float) * (3 * kN * kRow + 2 * kN * kCol + kN * kC + 10 * kN + kN);

// ------------------------------------------------------- decode, S = 1

constexpr int kDecodeCols = 16, kDecodeRows = 8;  // threads: columns × row groups

// blockIdx.x: a slice of 16 state columns of (b, h) = (blockIdx.z, blockIdx.y)
template <typename T>
__global__ void __launch_bounds__(kDecodeCols * kDecodeRows)
rwkv6_decode(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ logw, const float* __restrict__ u,
             const float* __restrict__ s0, float* __restrict__ o, float* __restrict__ s_out,
             Strides sr_, Strides sk_, Strides sv_, Strides sw_, Strides so_, int H, int hd) {
  __shared__ float sR[kN], sK[kN], sW[kN], sBonus[kN], sPart[kDecodeRows][kDecodeCols];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kDecodeCols, ty = threadIdx.x / kDecodeCols;
  const int e = blockIdx.x * kDecodeCols + tx;
  for (int d = threadIdx.x; d < hd; d += kDecodeCols * kDecodeRows) {
    sR[d] = to_f32(r[b * sr_.b + h * sr_.h + d]);
    sK[d] = to_f32(k[b * sk_.b + h * sk_.h + d]);
    sW[d] = exp2f(logw[b * sw_.b + h * sw_.h + d] * kLog2e);
    sBonus[d] = sR[d] * (u[h * hd + d] * sK[d]);
  }
  __syncthreads();
  const long long state = ((long long)b * H + h) * hd * hd;
  float part = 0.f;
  if (e < hd) {
    const float ve = to_f32(v[b * sv_.b + h * sv_.h + e]);
    for (int d = ty; d < hd; d += kDecodeRows) {
      const float s = s0 ? s0[state + d * hd + e] : 0.f;
      part += sR[d] * s;
      s_out[state + d * hd + e] = sW[d] * s + sK[d] * ve;
    }
  }
  sPart[ty][tx] = part;
  __syncthreads();
  if (ty == 0 && e < hd) {
    float acc = 0.f, bonus = 0.f;
    for (int i = 0; i < kDecodeRows; ++i) acc += sPart[i][tx];
    for (int d = 0; d < hd; ++d) bonus += sBonus[d];
    o[b * so_.b + h * so_.h + e] = acc + bonus * to_f32(v[b * sv_.b + h * sv_.h + e]);
  }
}

template <typename T, bool VEC>
int run_chunked(const T* r, const T* k, const T* v, const float* logw, const float* u,
                const float* s0, float* o, float* s_out, float* scratch, float* dec, Strides sr,
                Strides sk, Strides sv, Strides sw, Strides so, int B, int H, int S, int hd,
                int W, cudaStream_t st) {
  const int chunks = (S + W - 1) / W;
  const dim3 grid(chunks, H, B);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_states<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kStatesSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_states<T, VEC><<<grid, kThreads, kStatesSmem, st>>>(k, v, logw, scratch, dec, sk, sv, sw,
                                                            H, S, hd, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd % 4 == 0)
    rwkv6_state_scan<4><<<dim3((hd * hd / 4 + kThreads - 1) / kThreads, H, B), kThreads, 0, st>>>(
        scratch, dec, s0, s_out, H, hd, chunks);
  else
    rwkv6_state_scan<1><<<dim3((hd * hd + kThreads - 1) / kThreads, H, B), kThreads, 0, st>>>(
        scratch, dec, s0, s_out, H, hd, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rwkv6_outputs<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kOutputsSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_outputs<T, VEC><<<grid, kThreads, kOutputsSmem, st>>>(r, k, v, logw, u, scratch, o, sr,
                                                              sk, sv, sw, so, H, S, hd, W);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte tile loads where hd = 64 and every row of every (b, h) slice of
// r, k, v and logw starts on a 16-byte boundary (the serve path's layout)
template <typename T>
int launch_chunked(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* s0, float* o, float* s_out, float* scratch,
                   float* dec, Strides sr, Strides sk, Strides sv, Strides sw, Strides so, int B,
                   int H, int S, int hd, int W, cudaStream_t st) {
  auto aligned = [](const void* p, Strides s_, size_t size) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s_.b * size) % 16 == 0 &&
           (s_.h * size) % 16 == 0 && (s_.s * size) % 16 == 0;
  };
  const bool vec = hd == kN && aligned(r, sr, sizeof(T)) && aligned(k, sk, sizeof(T)) &&
                   aligned(v, sv, sizeof(T)) && aligned(logw, sw, sizeof(float));
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  return vec ? run_chunked<T, true>(rt, kt, vt, logw, u, s0, o, s_out, scratch, dec, sr, sk, sv,
                                    sw, so, B, H, S, hd, W, st)
             : run_chunked<T, false>(rt, kt, vt, logw, u, s0, o, s_out, scratch, dec, sr, sk, sv,
                                     sw, so, B, H, S, hd, W, st);
}

template <typename T>
int launch_decode(const void* r, const void* k, const void* v, const float* logw, const float* u,
                  const float* s0, float* o, float* s_out, Strides sr, Strides sk, Strides sv,
                  Strides sw, Strides so, int B, int H, int hd, cudaStream_t st) {
  const dim3 grid((hd + kDecodeCols - 1) / kDecodeCols, H, B);
  rwkv6_decode<T><<<grid, kDecodeCols * kDecodeRows, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u, s0,
      o, s_out, sr, sk, sv, sw, so, H, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16; logw, u, s0 (nullable), o,
// s_out and the scratch are float32. Strides in elements: (batch, head,
// sequence) of r, k, v, logw and o in that order. hd ≤ 64, 1 ≤ W ≤ 64;
// scratch holds B·H·chunks·hd·hd floats, dec B·H·chunks·hd.
extern "C" int rwkv6_scan_fwd(int dtype, const void* r, const void* k, const void* v,
                              const float* logw, const float* u, const float* s0, float* o,
                              float* s_out, float* scratch, float* dec, long long rb,
                              long long rh, long long rs, long long kb, long long kh,
                              long long ks, long long vb, long long vh, long long vs,
                              long long wb, long long wh, long long ws, long long ob,
                              long long oh, long long os, int B, int H, int S, int hd, int W,
                              void* stream) {
  if (B == 0 || H == 0 || hd == 0 || S == 0) return 0;
  if (hd > kN || W < 1 || W > kN) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sr{rb, rh, rs}, sk{kb, kh, ks}, sv{vb, vh, vs}, sw{wb, wh, ws}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_chunked<float>(r, k, v, logw, u, s0, o, s_out, scratch, dec, sr, sk, sv, sw,
                                 so, B, H, S, hd, W, st);
  if (dtype == 1)
    return launch_chunked<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, scratch, dec, sr, sk,
                                         sv, sw, so, B, H, S, hd, W, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One token (S = 1): the same arguments without the scratch.
extern "C" int rwkv6_decode_fwd(int dtype, const void* r, const void* k, const void* v,
                                const float* logw, const float* u, const float* s0, float* o,
                                float* s_out, long long rb, long long rh, long long kb,
                                long long kh, long long vb, long long vh, long long wb,
                                long long wh, long long ob, long long oh, int B, int H, int hd,
                                void* stream) {
  if (B == 0 || H == 0 || hd == 0) return 0;
  if (hd > kN) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sr{rb, rh, 0}, sk{kb, kh, 0}, sv{vb, vh, 0}, sw{wb, wh, 0}, so{ob, oh, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(r, k, v, logw, u, s0, o, s_out, sr, sk, sv, sw, so, B, H, hd, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, sr, sk, sv, sw, so, B, H,
                                        hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
