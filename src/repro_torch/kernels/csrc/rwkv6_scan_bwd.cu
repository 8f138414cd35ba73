// rwkv6_scan_bwd.cu — the gradient of the chunked RWKV6 wkv recurrence on
// Hopper (sm_90a): the forward's three launches (rwkv6_scan.cu) in reverse.
//
// Forward, per (batch, head), state S ∈ R^{hd×hd}, w_t = e^{logw_t} ≤ 1:
//     o_t = S_{t-1}ᵀ r_t + (r_t · (u ⊙ k_t)) v_t,   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
// The TPU kernel (src/repro/kernels/rwkv6_scan.py::rwkv6_scan) has no
// backward: the reference trains through jax.grad of its jnp chunk body
// (src/repro/models/rwkv6.py:90-121, chunked by lax.scan at :178). This is
// new work held against that gradient, not a port of a Pallas body.
//
// Derivation. Let D_t = ∂L/∂S_t. Token by token, backwards:
//     D_{t-1} = diag(w_t) D_t + r_t do_tᵀ                  D_{S-1} = dS_final (or 0)
// A reverse recurrence of the forward's form, with r in k's place and do in
// v's. Over a chunk of W tokens, c = Σ logw (inclusive, within the chunk),
// ce = c − logw (exclusive), and D_{W-1} = dS_out (∂L/∂ of the chunk's
// S_out, which is the next chunk's dS_in):
//     dS_in = e^{c_{W-1}} ⊙ dS_out + Σ_s (r_s ⊙ e^{ce_s}) do_sᵀ            (rows scaled)
//     dr_t  = e^{ce_t} ⊙ (S_in do_t) + Σ_{j<t} P_tj (k_j ⊙ e^{ce_t − c_j}) + u ⊙ k_t P_tt
//     dk_j  = e^{c_{W-1} − c_j} ⊙ (dS_out v_j) + Σ_{t>j} P_tj (r_t ⊙ e^{ce_t − c_j}) + u ⊙ r_j P_jj
//     dv_j  = Σ_{t≥j} A_tj do_t + dS_outᵀ (k_j ⊙ e^{c_{W-1} − c_j})
//     du    = Σ_t r_t ⊙ k_t P_tt
// with P_tj = do_t · v_j and A the forward's pair matrix (A_tj = Σ_d r_td
// k_jd e^{ce_td − c_jd} for j < t, A_tt = r_t · (u ⊙ k_t)).
// dlogw without per-token states: logw enters only through the cumulative
// sums. With the whole sequence's sums G, r_t meets the decays as r_t ⊙
// e^{G_{t-1}} and k_j as k_j ⊙ e^{−G_j}, so ∂L/∂G_m = r_{m+1} ⊙ dr^w_{m+1} −
// k_m ⊙ dk^w_m, where ^w marks the part of a gradient that comes through the
// decayed terms (all of it but the u-bonus); logw_s enters every G_m, m ≥ s.
// Within one chunk the later chunks come in through S_out alone: ∂S_out/
// ∂logw_s = S_out − Σ_{j≥s} (k_j ⊙ e^{c_{W-1} − c_j}) v_jᵀ, whose second part
// is already in dk^w. So, with X = Σ_e dS_out ⊙ S_out (a vector over d),
//     dlogw_s = X + Σ_{t>s} r_t ⊙ dr^w_t − Σ_{t≥s} k_t ⊙ dk^w_t
// a reverse cumulative sum over the chunk. S_out is the next chunk's S_in
// (the forward's scratch) or, for the last chunk, S_final.
//
// Bound: bytes. r, k, v (bf16 on the train path), logw and do (f32) and the
// chunk states S_in are read once, dr, dk, dv, dlogw written once: about
// 1.4 GB at rwkv6-3b's train shape (B = 8, H = 48, S = 2048, hd = 64), while
// the chunked form's products are about 4.0e10 flops (0.08 ms at the TF32
// rate). chip_smoke.py computes both from the call's shapes.
//
// Design: three launches.
//   A. states, one block per (b, h, chunk): dU = Σ_s (r_s ⊙ e^{ce_s}) do_sᵀ
//      and the decay e^{c_{W-1}}, into a scratch buffer (B, H, chunks, hd, hd).
//   B. scan, one thread per four state entries: dS_out of each chunk in place
//      of its dU (dS ← e^{c_{W-1}} ⊙ dS + dU, in f32, from the last chunk to
//      the first, the loads of 8 chunks in flight), and dS0.
//   C. gradients, one block per (b, h, chunk): from the chunk's tiles, S_in
//      (the forward's scratch, saved by the autograd Function) and dS_out.
//      The products (P = do·vᵀ, S_in·do, dS_out·v, Aᵀ·do, k̃·dS_out) on the
//      tensor cores as the forward's, mma.sync m16n8k8 3 × TF32; the three
//      pair sums (A, and the intra-chunk parts of dr and dk) on the CUDA
//      cores, one exponential per pair and channel, each clamped at 0 (the
//      causal exponents are ≤ 0, so nothing overflows): the dr and dk sums
//      of one (t, d) run in one thread, t and 63 − t terms, so every thread
//      does the same work. dlogw: one thread a column, the reverse sum over
//      the chunk. du: one partial per (b, h, chunk) summed by the wrapper.
// This is the first, simple form: the pair sums take per-pair exponentials
// where the forward factors its off-diagonal sub-chunk blocks into products.
// Deterministic: no atomics; every sum in one thread or one product, in a
// fixed order.
//
// Layout: r, k, v, logw, do and the gradients dr, dk, dv, dlogw are
// (B, H, S, hd) with hd contiguous and any (batch, head, sequence) strides in
// elements (the model's (B, S, H, hd) activations without a copy); u is
// (H, hd); S_in, dS_out (B, H, chunks, hd, hd), S_final, dS_final, dS0
// (B, H, hd, hd), contiguous f32. hd ≤ 64, W ≤ 64.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// does not synchronise, allocates nothing (the wrapper passes the scratch),
// returns cudaGetLastError().

#include "rwkv6.cuh"

namespace {

__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// --------------------------------------------- pass A: the chunks' dU

// dU = Σ_s (r_s ⊙ e^{ce_s}) ⊗ do_s (hd × hd) and e^{c_{W-1}} (hd) of chunk
// blockIdx.x of (b, h) = (blockIdx.z, blockIdx.y)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_states(const T* __restrict__ r, const float* __restrict__ dout,
                 const float* __restrict__ logw, float* __restrict__ dU, float* __restrict__ dec,
                 Strides sr_, Strides sd_, Strides sw_, int H, int S, int hd, int W) {
  extern __shared__ float smem[];
  float* sR = smem;                 // r, then r ⊙ e^{ce}: A = (that)ᵀ, down columns
  float* sD = sR + kN * kCol;       // do: B, down columns
  float* sC = sD + kN * kCol;       // c · log2 e
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = n * W, nt = min(W, S - t0);
  {
    Tile<T, VEC> tr;
    Tile<float, VEC> td, tw;
    tr.fetch(r + b * sr_.b + h * sr_.h, sr_.s, t0, nt, hd);
    if (!VEC) tr.put(sR, kCol);
    td.fetch(dout + b * sd_.b + h * sd_.h, sd_.s, t0, nt, hd);
    if (!VEC) td.put(sD, kCol);
    tw.fetch(logw + b * sw_.b + h * sw_.h, sw_.s, t0, nt, hd);
    if (VEC) {
      tr.put(sR, kCol);
      td.put(sD, kCol);
    }
    tw.put(sC, kN, kLog2e);
  }
  __syncthreads();
  column_cumsum<kN>(sC);
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) {
    const int t = i / kN, d = i % kN;
    if (t > 0) sR[t * kCol + d] *= exp2f(fminf(sC[(t - 1) * kN + d], 0.f));
  }
  const long long item = ((long long)b * H + h) * gridDim.x + n;
  if (threadIdx.x < hd) dec[item * hd + threadIdx.x] = exp2f(sC[(kN - 1) * kN + threadIdx.x]);
  __syncthreads();

  // dU (64 × 64): warp w owns rows 16·(w / 2).., columns 32·(w % 2)..
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int m0 = 16 * (warp / 2), n0 = 32 * (warp % 2);
  float acc[4][4] = {};
  warp_mma(acc, sR, 1, kCol, sD, kCol, 1, m0, n0);   // (d, e) = Σ_s r̄_sd do_se
  float* Ub = dU + item * hd * hd;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int d = m0 + g + 8 * rr;
      if (d >= hd) continue;
      if (e < hd) Ub[d * hd + e] = acc[j][2 * rr];
      if (e + 1 < hd) Ub[d * hd + e + 1] = acc[j][2 * rr + 1];
    }
  }
}

// --------------------------------------------- pass B: the reverse scan

constexpr int kGroup = 8;

// per PER state entries (one row d) of (b, h) = (blockIdx.z, blockIdx.y):
// dU[n] <- dS_out of chunk n, dS <- e^{c_{W-1}} ⊙ dS + dU[n], from the last
// chunk to the first; dS0 out. The loads of kGroup chunks are issued
// together: the chain runs through dS only.
template <int PER>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_state_scan(float* __restrict__ dU, const float* __restrict__ dec,
                     const float* __restrict__ ds_final, float* __restrict__ ds0, int H, int hd,
                     int chunks) {
  using Vec = typename std::conditional<PER == 4, float4, float>::type;
  const int idx = (blockIdx.x * kThreads + threadIdx.x) * PER;
  if (idx >= hd * hd) return;
  const int h = blockIdx.y, b = blockIdx.z, d = idx / hd;
  const long long bh = (long long)b * H + h;
  const long long step = (long long)hd * hd / PER;   // one chunk, in Vec
  Vec* u = reinterpret_cast<Vec*>(dU + bh * chunks * hd * hd + idx);
  const float* w = dec + bh * chunks * hd + d;
  float st[PER];
#pragma unroll
  for (int x = 0; x < PER; ++x) st[x] = ds_final ? ds_final[bh * hd * hd + idx + x] : 0.f;
  for (int top = chunks - 1; top >= 0; top -= kGroup) {
    Vec un[kGroup];
    float wn[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (top - i >= 0) {
        un[i] = u[(top - i) * step];
        wn[i] = w[(long long)(top - i) * hd];
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (top - i < 0) break;
      const float* uf = reinterpret_cast<const float*>(&un[i]);
      Vec out;
      float* of = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int x = 0; x < PER; ++x) {
        of[x] = st[x];
        st[x] = wn[i] * st[x] + uf[x];
      }
      u[(top - i) * step] = out;
    }
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int x = 0; x < PER; ++x) ds0[bh * hd * hd + idx + x] = st[x];
  }
}

// ------------------------------------------------- pass C: the gradients

struct Grads {
  Strides r, k, v, w, d, dr, dk, dv, dw;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_grads(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                const float* __restrict__ dout, const float* __restrict__ s_in,
                const float* __restrict__ ds_out, const float* __restrict__ s_final,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dlogw, float* __restrict__ du_part, Grads st, int H, int S,
                int hd, int W) {
  extern __shared__ float smem[];
  float* sR = smem;                 // r (t, d)
  float* sK = sR + kN * kRow;       // k (j, d)
  float* sV = sK + kN * kRow;       // v (j, e)
  float* sD = sV + kN * kRow;       // do (t, e)
  float* sS = sD + kN * kRow;       // S_in (d, e), then k̃ = k ⊙ e^{c_{W-1} − c} (j, d)
  float* sG = sS + kN * kRow;       // dS_out (d, e)
  float* sP = sG + kN * kRow;       // P = do·vᵀ (t, j)
  float* sA = sP + kN * kRow;       // the pair matrix (t, j), u-bonus on the diagonal
  float* sT1 = sA + kN * kRow;      // dr's pair sum (t, d), then r ⊙ dr^w
  float* sT2 = sT1 + kN * kRow;     // dk's pair sum (j, d), then k ⊙ dk^w
  float* sC = sT2 + kN * kRow;      // c · log2 e, inclusive (row stride kC)
  float* sU = sC + kN * kC;         // u
  float* sX = sU + kN;              // X = Σ_e dS_out ⊙ S_out
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const int t0 = n * W, nt = min(W, S - t0);
  const long long bh = (long long)b * H + h, item = bh * chunks + n;
  {
    Tile<T, VEC> tr, tk, tv;
    Tile<float, VEC> tw, td;
    tr.fetch(r + b * st.r.b + h * st.r.h, st.r.s, t0, nt, hd);
    if (!VEC) tr.put(sR, kRow);
    tk.fetch(k + b * st.k.b + h * st.k.h, st.k.s, t0, nt, hd);
    if (!VEC) tk.put(sK, kRow);
    tv.fetch(v + b * st.v.b + h * st.v.h, st.v.s, t0, nt, hd);
    if (!VEC) tv.put(sV, kRow);
    tw.fetch(logw + b * st.w.b + h * st.w.h, st.w.s, t0, nt, hd);
    if (!VEC) tw.put(sC, kC, kLog2e);
    td.fetch(dout + b * st.d.b + h * st.d.h, st.d.s, t0, nt, hd);
    if (VEC) {
      tr.put(sR, kRow);
      tk.put(sK, kRow);
      tv.put(sV, kRow);
      tw.put(sC, kC, kLog2e);
    }
    td.put(sD, kRow);
  }
  {
    Tile<float, VEC> ts, tg;
    ts.fetch(s_in + item * hd * hd, hd, 0, hd, hd);
    tg.fetch(ds_out + item * hd * hd, hd, 0, hd, hd);
    ts.put(sS, kRow);
    tg.put(sG, kRow);
  }
  if (threadIdx.x < kN) sU[threadIdx.x] = threadIdx.x < hd ? u[h * hd + threadIdx.x] : 0.f;
  __syncthreads();
  column_cumsum<kC>(sC);

  // X: four threads a row d of dS_out ⊙ S_out, S_out read from device memory
  {
    const float* so = n + 1 < chunks ? s_in + (item + 1) * hd * hd : s_final + bh * hd * hd;
    const int d = threadIdx.x / 4, part = threadIdx.x % 4;
    float x = 0.f;
    if (d < hd)
      for (int e = part; e < hd; e += 4) x += sG[d * kRow + e] * so[(long long)d * hd + e];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0) sX[d] = x;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int m0 = 16 * (warp / 2), n0 = 32 * (warp % 2);
  // P = do·vᵀ (t, j)
  {
    float acc[4][4] = {};
    warp_mma<std::is_same<T, __nv_bfloat16>::value>(acc, sD, kRow, 1, sV, 1, kRow, m0, n0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = m0 + g + 8 * rr, c = n0 + 8 * j + 2 * q;
        sP[t * kRow + c] = acc[j][2 * rr];
        sP[t * kRow + c + 1] = acc[j][2 * rr + 1];
      }
  }
  // the pair matrix, as the forward's: per-pair exponentials below the
  // diagonal, the u-bonus on it, 0 above
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) {
    const int t = i / kN, j = i % kN;
    float a = 0.f;
    if (j < t) {
      for (int d = 0; d < kN; ++d)
        a += sR[t * kRow + d] * sK[j * kRow + d] *
             exp2f(fminf(sC[(t - 1) * kC + d] - sC[j * kC + d], 0.f));
    } else if (j == t) {
      for (int d = 0; d < kN; ++d) a += sR[t * kRow + d] * (sU[d] * sK[t * kRow + d]);
    }
    sA[t * kRow + j] = a;
  }
  __syncthreads();

  // the pair sums of dr at (t, d) and of dk at (j = t, d): t + (63 − t) terms
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) {
    const int t = i / kN, d = i % kN;
    const float ce = t > 0 ? sC[(t - 1) * kC + d] : 0.f, ct = sC[t * kC + d];
    float a = 0.f;
    for (int j = 0; j < t; ++j)
      a += sP[t * kRow + j] * sK[j * kRow + d] * exp2f(fminf(ce - sC[j * kC + d], 0.f));
    sT1[t * kRow + d] = a;
    float c = 0.f;
    for (int s = t + 1; s < kN; ++s)
      c += sP[s * kRow + t] * sR[s * kRow + d] * exp2f(fminf(sC[(s - 1) * kC + d] - ct, 0.f));
    sT2[t * kRow + d] = c;
  }
  __syncthreads();

  // dr = e^{ce} ⊙ (S_in·do) + pair sum + u ⊙ k P_tt; dk = e^{c_{W-1} − c} ⊙
  // (dS_out·v) + pair sum + u ⊙ r P_tt; keep r ⊙ dr^w and k ⊙ dk^w for dlogw
  {
    float acc_r[4][4] = {}, acc_k[4][4] = {};
    warp_mma(acc_r, sD, kRow, 1, sS, 1, kRow, m0, n0);   // (t, d) = Σ_e do_te S_in,de
    warp_mma(acc_k, sV, kRow, 1, sG, 1, kRow, m0, n0);   // (j, d) = Σ_e v_je dS_out,de
    T* drb = dr + b * st.dr.b + h * st.dr.h;
    T* dkb = dk + b * st.dk.b + h * st.dk.h;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = m0 + g + 8 * (e / 2), d = n0 + 8 * j + 2 * q + e % 2;
        const float ptt = sP[t * kRow + t];
        const float ce = t > 0 ? sC[(t - 1) * kC + d] : 0.f;
        const float drw = acc_r[j][e] * exp2f(fminf(ce, 0.f)) + sT1[t * kRow + d];
        const float dkw =
            acc_k[j][e] * exp2f(fminf(sC[(kN - 1) * kC + d] - sC[t * kC + d], 0.f)) +
            sT2[t * kRow + d];
        if (t < nt && d < hd) {
          from_f32(drw + sU[d] * sK[t * kRow + d] * ptt, &drb[(long long)(t0 + t) * st.dr.s + d]);
          from_f32(dkw + sU[d] * sR[t * kRow + d] * ptt, &dkb[(long long)(t0 + t) * st.dk.s + d]);
        }
        sT1[t * kRow + d] = sR[t * kRow + d] * drw;
        sT2[t * kRow + d] = sK[t * kRow + d] * dkw;
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) {   // k̃ over S_in, now read
    const int t = i / kN, d = i % kN;
    sS[t * kRow + d] =
        sK[t * kRow + d] * exp2f(fminf(sC[(kN - 1) * kC + d] - sC[t * kC + d], 0.f));
  }
  __syncthreads();

  // dv (j, e) = Σ_t A_tj do_te + Σ_d k̃_jd dS_out,de
  {
    float acc[4][4] = {};
    warp_mma(acc, sA, 1, kRow, sD, kRow, 1, m0, n0);
    warp_mma(acc, sS, kRow, 1, sG, kRow, 1, m0, n0);
    T* dvb = dv + b * st.dv.b + h * st.dv.h;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = m0 + g + 8 * (e / 2), c = n0 + 8 * j + 2 * q + e % 2;
        if (t < nt && c < hd) from_f32(acc[j][e], &dvb[(long long)(t0 + t) * st.dv.s + c]);
      }
  }
  // dlogw and du: one thread a column d, the chunk's rows in reverse
  if (threadIdx.x < kN) {
    const int d = threadIdx.x;
    float* dwb = dlogw + b * st.dw.b + h * st.dw.h;
    float z = 0.f, du = 0.f;
    for (int t = kN - 1; t >= 0; --t) {
      const float qt = sT1[t * kRow + d];
      z += qt - sT2[t * kRow + d];
      if (t < nt && d < hd) dwb[(long long)(t0 + t) * st.dw.s + d] = sX[d] + z - qt;
      du += sR[t * kRow + d] * sK[t * kRow + d] * sP[t * kRow + t];
    }
    if (d < hd) du_part[item * hd + d] = du;
  }
}

constexpr size_t kStatesSmem = sizeof(float) * (2 * kN * kCol + kN * kN);
constexpr size_t kGradsSmem = sizeof(float) * (10 * kN * kRow + kN * kC + 2 * kN);

template <typename T, bool VEC>
int run_bwd(const T* r, const T* k, const T* v, const float* logw, const float* u,
            const float* dout, const float* s_in, const float* s_final, const float* ds_final,
            float* dscratch, float* ddec, float* du_part, T* dr, T* dk, T* dv, float* dlogw,
            float* ds0, const Grads& st, int B, int H, int S, int hd, int W, cudaStream_t stream) {
  const int chunks = (S + W - 1) / W;
  const dim3 grid(chunks, H, B);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_states<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kStatesSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_states<T, VEC><<<grid, kThreads, kStatesSmem, stream>>>(
      r, dout, logw, dscratch, ddec, st.r, st.d, st.w, H, S, hd, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd % 4 == 0)
    rwkv6_bwd_state_scan<4><<<dim3((hd * hd / 4 + kThreads - 1) / kThreads, H, B), kThreads, 0,
                              stream>>>(dscratch, ddec, ds_final, ds0, H, hd, chunks);
  else
    rwkv6_bwd_state_scan<1><<<dim3((hd * hd + kThreads - 1) / kThreads, H, B), kThreads, 0,
                              stream>>>(dscratch, ddec, ds_final, ds0, H, hd, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rwkv6_bwd_grads<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kGradsSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_grads<T, VEC><<<grid, kThreads, kGradsSmem, stream>>>(
      r, k, v, logw, u, dout, s_in, dscratch, s_final, dr, dk, dv, dlogw, du_part, st, H, S, hd,
      W);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte tile loads where hd = 64 and every row of every (b, h) slice of
// r, k, v, logw and do starts on a 16-byte boundary (the train path's layout)
template <typename T>
int launch_bwd(const void* r, const void* k, const void* v, const float* logw, const float* u,
               const float* dout, const float* s_in, const float* s_final, const float* ds_final,
               float* dscratch, float* ddec, float* du_part, void* dr, void* dk, void* dv,
               float* dlogw, float* ds0, const Grads& st, int B, int H, int S, int hd, int W,
               cudaStream_t stream) {
  auto aligned = [](const void* p, Strides s_, size_t size) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s_.b * size) % 16 == 0 &&
           (s_.h * size) % 16 == 0 && (s_.s * size) % 16 == 0;
  };
  const bool vec = hd == kN && aligned(r, st.r, sizeof(T)) && aligned(k, st.k, sizeof(T)) &&
                   aligned(v, st.v, sizeof(T)) && aligned(logw, st.w, sizeof(float)) &&
                   aligned(dout, st.d, sizeof(float));
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  T *drt = static_cast<T*>(dr), *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  return vec ? run_bwd<T, true>(rt, kt, vt, logw, u, dout, s_in, s_final, ds_final, dscratch,
                                ddec, du_part, drt, dkt, dvt, dlogw, ds0, st, B, H, S, hd, W,
                                stream)
             : run_bwd<T, false>(rt, kt, vt, logw, u, dout, s_in, s_final, ds_final, dscratch,
                                 ddec, du_part, drt, dkt, dvt, dlogw, ds0, st, B, H, S, hd, W,
                                 stream);
}

}  // namespace

// dtype of r, k, v and of dr, dk, dv: 0 = float32, 1 = bfloat16; logw, u,
// do, the states and the rest are float32. s_in: the forward's scratch
// (S_in of every chunk), s_final its S_final; ds_final and ds0 nullable.
// dscratch holds B·H·chunks·hd·hd floats, ddec and du_part B·H·chunks·hd
// (du = du_part summed over batch and chunk). Strides in elements: (batch,
// head, sequence) of r, k, v, logw, do, dr, dk, dv and dlogw in that order.
// hd ≤ 64, 1 ≤ W ≤ 64.
extern "C" int rwkv6_scan_bwd(
    int dtype, const void* r, const void* k, const void* v, const float* logw, const float* u,
    const float* dout, const float* s_in, const float* s_final, const float* ds_final,
    float* dscratch, float* ddec, float* du_part, void* dr, void* dk, void* dv, float* dlogw,
    float* ds0, long long rb, long long rh, long long rs, long long kb, long long kh,
    long long ks, long long vb, long long vh, long long vs, long long wb, long long wh,
    long long ws, long long db, long long dh, long long ds, long long drb, long long drh,
    long long drs, long long dkb, long long dkh, long long dks, long long dvb, long long dvh,
    long long dvs, long long dwb, long long dwh, long long dws, int B, int H, int S, int hd,
    int W, void* stream) {
  if (B == 0 || H == 0 || hd == 0 || S == 0) return 0;
  if (hd > kN || W < 1 || W > kN) return static_cast<int>(cudaErrorInvalidValue);
  const Grads st{{rb, rh, rs},    {kb, kh, ks},    {vb, vh, vs},    {wb, wh, ws},   {db, dh, ds},
                 {drb, drh, drs}, {dkb, dkh, dks}, {dvb, dvh, dvs}, {dwb, dwh, dws}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(r, k, v, logw, u, dout, s_in, s_final, ds_final, dscratch, ddec,
                             du_part, dr, dk, dv, dlogw, ds0, st, B, H, S, hd, W, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(r, k, v, logw, u, dout, s_in, s_final, ds_final, dscratch,
                                     ddec, du_part, dr, dk, dv, dlogw, ds0, st, B, H, S, hd, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
