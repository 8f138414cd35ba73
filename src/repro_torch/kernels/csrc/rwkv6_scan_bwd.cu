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
//      Products (P = do·vᵀ, S_in·do, dS_out·v, Aᵀ·do, k̃·dS_out) on the
//      tensor cores as the forward's, mma.sync m16n8k8 3 × TF32 (2 × where
//      an operand is a bf16 input). The three pair sums — the pair matrix A
//      and the intra-chunk parts of dr and dk — are factored as the
//      forward's (rwkv6_scan.cu): the chunk is cut into four sub-chunks of
//      16 tokens, b_i the first and e_i the last row of sub-chunk i, and for
//      t in sub-chunk i, j in sub-chunk m < i
//          e^{ce_t − c_j} = e^{ce_t − ce_{b_i}} · e^{ce_{b_i} − c_{e_m}} · e^{c_{e_m} − c_j}
//      with r̂ = r ⊙ (the first factor), g_im (the middle one, a vector) and
//      k̂ = k ⊙ (the last), every exponent ≤ 0 (c falls along the chunk), so
//      nothing overflows. The off-diagonal 16 × 16 blocks become products:
//          A_im        = (r̂_i ⊙ g_im)·k̂_mᵀ
//          dr's sum, i = e^{ce_t − ce_{b_i}} ⊙ Σ_{m<i} P_im·(k̂_m ⊙ g_im)
//          dk's sum, m = e^{c_{e_m} − c_j} ⊙ Σ_{i>m} P_imᵀ·(r̂_i ⊙ g_im)
//      each operand formed as it is fetched into a fragment, its two
//      factors merged into one exponential (r ⊙ e^{ce_t − c_{e_m}}, k ⊙
//      e^{ce_{b_i} − c_j}), so neither r̂ nor k̂ takes shared memory. Only the
//      four diagonal blocks keep one exponential a pair and channel, 4·120
//      pairs each taken twice (for dr's sum and A's, then for dk's), against
//      3 × 2016 pairs (W²/2 a sum) in the first form. A warp owns one
//      sub-chunk's 16 rows and 32 channels of dr, dk and dv, so the
//      factored sums, the diagonal parts and the products with the states
//      all land in its registers: the dr and dk diagonal sums of a row take
//      o − b_i and b_i + 15 − o terms, 15 together, the same for every
//      thread; A's diagonal blocks are summed from the same terms, across a
//      row's four lanes by shuffles and across the sub-chunk's two warps in
//      shared memory, in a fixed order.
//      Shared memory: r, k, v in their own type (bf16: 9 KB each), three
//      f32 tiles reused as the pass goes on (S_in, then P, then r ⊙ k ⊙
//      P_tt; dS_out, then A, then r ⊙ dr^w; do, then k ⊙ dk^w) and the
//      decays: 96 KB where r, k, v are bf16, so two blocks (16 warps) share
//      an SM. The first form took ten f32 tiles, 191 KB: one block of 8
//      warps an SM. Its gradient pass took 199.23 ms over 32 calls (6.23
//      ms each) in torch.profiler's trace of an rwkv6-3b train step, of
//      6.82 ms a call for the three launches (chip_smoke.py, NVIDIA H100
//      80GB HBM3, 700 W): the per-pair loops (three sums × 2016 pairs × 64
//      channels, each an exponential and three shared-memory reads) were
//      issued by 8 warps, too few to hide the reads' latency behind one
//      another's work. The profiler times whole kernels only, so it does
//      not split that cost between the work and the occupancy; PERF.md §6
//      has this form's time.
//      dlogw: four threads a column, the reverse sum over the chunk from
//      quarter totals. du: one partial per (b, h, chunk) summed by the
//      wrapper.
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

constexpr int kSub = 16;          // sub-chunk of pass C, as the forward's

// 2^x for x ≤ 0 (a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// Pass C's shared memory: r, k and v in their own type (row stride LD: 72
// bf16 = 36 words keeps a fragment's rows and columns on distinct banks),
// three f32 tiles whose contents change as the pass goes on, the decays.
template <typename T>
struct GradsSmem {
  static constexpr int LD = sizeof(T) == 2 ? 72 : kRow;
  static constexpr size_t BYTES =
      3 * sizeof(T) * kN * LD + sizeof(float) * (3 * kN * kRow + kN * kC + 3 * kN);
};
// two blocks a SM where r, k, v come in bf16 (the train path): 228 KB an SM,
// 1 KB of it reserved for each block
static_assert(2 * (GradsSmem<__nv_bfloat16>::BYTES + 1024) <= 233472,
              "pass C must fit two blocks on an SM");
static_assert(GradsSmem<float>::BYTES <= 232448, "pass C must fit one block");

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_grads(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                const float* __restrict__ dout, const float* __restrict__ s_in,
                const float* __restrict__ ds_out, const float* __restrict__ s_final,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dlogw, float* __restrict__ du_part, Grads st, int H, int S,
                int hd, int W) {
  constexpr int LD = GradsSmem<T>::LD;
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;   // r, k, v exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sR = reinterpret_cast<T*>(smem_raw);          // r (t, d)
  T* sK = sR + kN * LD;                            // k (j, d)
  T* sV = sK + kN * LD;                            // v (j, e)
  float* sD = reinterpret_cast<float*>(sV + kN * LD);   // do (t, e); at the end k ⊙ dk^w
  float* sP = sD + kN * kRow;   // S_in (d, e); then P = do·vᵀ (t, j); then r ⊙ k ⊙ P_tt
  float* sA = sP + kN * kRow;   // dS_out (d, e); then the pair matrix (t, j); then r ⊙ dr^w
  float* sC = sA + kN * kRow;   // c · log2 e, inclusive (row stride kC)
  float* sU = sC + kN * kC;     // u
  float* sX = sU + kN;          // X = Σ_e dS_out ⊙ S_out
  float* sB = sX + kN;          // the u-bonus A_tt over channels 32 .. 63
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const int t0 = n * W, nt = min(W, S - t0);
  const long long bh = (long long)b * H + h, item = bh * chunks + n;
  {
    Tile<T, VEC> tr, tk, tv;
    Tile<float, VEC> tw, td;
    tr.fetch(r + b * st.r.b + h * st.r.h, st.r.s, t0, nt, hd);
    if (!VEC) tr.put_raw(sR, LD);
    tk.fetch(k + b * st.k.b + h * st.k.h, st.k.s, t0, nt, hd);
    if (!VEC) tk.put_raw(sK, LD);
    tv.fetch(v + b * st.v.b + h * st.v.h, st.v.s, t0, nt, hd);
    if (!VEC) tv.put_raw(sV, LD);
    tw.fetch(logw + b * st.w.b + h * st.w.h, st.w.s, t0, nt, hd);
    if (!VEC) tw.put(sC, kC, kLog2e);
    td.fetch(dout + b * st.d.b + h * st.d.h, st.d.s, t0, nt, hd);
    if (VEC) {
      tr.put_raw(sR, LD);
      tk.put_raw(sK, LD);
      tv.put_raw(sV, LD);
      tw.put(sC, kC, kLog2e);
    }
    td.put(sD, kRow);
  }
  {
    Tile<float, VEC> ts, tg;
    ts.fetch(s_in + item * hd * hd, hd, 0, hd, hd);
    tg.fetch(ds_out + item * hd * hd, hd, 0, hd, hd);
    ts.put(sP, kRow);
    tg.put(sA, kRow);
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
      for (int e = part; e < hd; e += 4) x += sA[d * kRow + e] * so[(long long)d * hd + e];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0) sX[d] = x;
  }

  // Every warp owns one 16-row sub-chunk i (rows b0 .. b0 + 15) and 32
  // columns n0 .. of the outputs dr, dk (rows t, j) and dv (rows j): this
  // thread rows b0 + g and b0 + g + 8, columns n0 + 8jj + 2q + {0, 1}.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int blk = warp / 2, b0 = kSub * blk, n0 = 32 * (warp % 2);
  const auto c_at = [&](int t, int d) { return sC[t * kC + d]; };
  const auto ce_at = [&](int t, int d) { return t > 0 ? sC[(t - 1) * kC + d] : 0.f; };
  const auto e2 = [](float x) { return ex2(fminf(x, 0.f)); };   // causal exponents are ≤ 0
  const auto col = [&](int jj, int e) { return n0 + 8 * jj + 2 * q + (e & 1); };
  const auto row = [&](int e) { return b0 + g + 8 * (e >> 1); };

  // The products with the chunk's states, into registers: S_in·do (t, d) and
  // dS_out·v (j, d) for dr^w and dk^w, then P = do·vᵀ (t, j), written over
  // S_in once every warp has read it, then k̃·dS_out (j, e) for dv with k̃ =
  // k ⊙ e^{c_63 − c}.
  float drw[4][4] = {}, dkw[4][4] = {}, dvv[4][4] = {};
  const auto rd_d = [&](int m, int kk) { return sD[m * kRow + kk]; };
  warp_mma_fn<4, false, false>(drw, rd_d, [&](int kk, int nn) { return sP[nn * kRow + kk]; },
                               b0, n0, 0, kN);
  warp_mma_fn<4, kExact, false>(dkw, [&](int m, int kk) { return to_f32(sV[m * LD + kk]); },
                                [&](int kk, int nn) { return sA[nn * kRow + kk]; }, b0, n0, 0,
                                kN);
  {
    float pp[4][4] = {};
    warp_mma_fn<4, false, kExact>(pp, rd_d,
                                  [&](int kk, int nn) { return to_f32(sV[nn * LD + kk]); }, b0,
                                  n0, 0, kN);
    __syncthreads();   // S_in is read: its tile takes P
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sP[row(e) * kRow + col(jj, e)] = pp[jj][e];
  }
  warp_mma_fn<4, false, false>(
      dvv,
      [&](int m, int kk) {
        return to_f32(sK[m * LD + kk]) * e2(c_at(kN - 1, kk) - c_at(m, kk));
      },
      [&](int kk, int nn) { return sA[kk * kRow + nn]; }, b0, n0, 0, kN);
  __syncthreads();   // P is complete; dS_out is read: its tile takes the pair matrix

  // The pair matrix's six off-diagonal blocks (i, m), m < i, one warp each,
  // as products: A_tj = Σ_d (r_td e^{ce_t − c_{e_m}}) (k_jd e^{c_{e_m} − c_j}),
  // e_m the last row of sub-chunk m. That is (r̂_i ⊙ g_im)·k̂_mᵀ with the
  // forward's r̂ (each row against its sub-chunk's start), k̂ (against its
  // end) and g_im = e^{ce_{b_i} − c_{e_m}}, g folded into r̂'s exponent:
  // every exponent ≤ 0.
  if (warp < 6) {
    const int bi = warp < 1 ? 1 : warp < 3 ? 2 : 3, bm = warp - bi * (bi - 1) / 2;
    const int em = kSub * bm + kSub - 1;
    float acc[2][4] = {};
    warp_mma_fn<2, false, false>(
        acc,
        [&](int t, int d) { return to_f32(sR[t * LD + d]) * e2(c_at(t - 1, d) - c_at(em, d)); },
        [&](int d, int j) { return to_f32(sK[j * LD + d]) * e2(c_at(em, d) - c_at(j, d)); },
        kSub * bi, kSub * bm, 0, kN);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sA[(kSub * bi + g + 8 * (e >> 1)) * kRow + kSub * bm + 8 * jj + 2 * q + (e & 1)] =
            acc[jj][e];
  }

  // dr^w (t, d) = e^{ce_t} ⊙ (S_in·do) + Σ_{j<t} P_tj k_j ⊙ e^{ce_t − c_j}, and
  // dk^w (j, d) = e^{c_63 − c_j} ⊙ (dS_out·v) + Σ_{t>j} P_tj r_t ⊙ e^{ce_t − c_j}.
  // Off the diagonal blocks, with b the sub-chunk's first row and e its last:
  //   dr^w = e^{ce_t − ce_b} ⊙ [e^{ce_b} ⊙ (S_in·do) + P_{t, <b}·(k ⊙ e^{ce_b − c})]
  //   dk^w = e^{c_e − c_j} ⊙ [e^{c_63 − c_e} ⊙ (dS_out·v) + P_{>e, j}ᵀ·(r ⊙ e^{ce − c_e})]
  // which are (P_ij·k̂_j) ⊙ e^{ce_t − ce_{b_i}} ⊙ g_ij and e^{c_{e_j} − c_j} ⊙
  // Σ_i g_ij ⊙ (P_ijᵀ·r̂_i) in the header's terms, g folded into the
  // operand's exponent; the products on the tensor cores.
  {
    const int e_last = b0 + kSub - 1;
    float off_r[4][4] = {}, off_k[4][4] = {};
    if (blk > 0)
      warp_mma_fn<4, false, false>(
          off_r, [&](int t, int j) { return sP[t * kRow + j]; },
          [&](int j, int d) { return to_f32(sK[j * LD + d]) * e2(ce_at(b0, d) - c_at(j, d)); },
          b0, n0, 0, b0);
    if (blk < 3)
      warp_mma_fn<4, false, false>(
          off_k, [&](int j, int t) { return sP[t * kRow + j]; },
          [&](int t, int d) {
            return to_f32(sR[t * LD + d]) * e2(c_at(t - 1, d) - c_at(e_last, d));
          },
          b0, n0, e_last + 1, kN);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row(e), d = col(jj, e);
        drw[jj][e] = e2(ce_at(t, d) - ce_at(b0, d)) *
                     (drw[jj][e] * e2(ce_at(b0, d)) + off_r[jj][e]);
        dkw[jj][e] = e2(c_at(e_last, d) - c_at(t, d)) *
                     (dkw[jj][e] * e2(c_at(kN - 1, d) - c_at(e_last, d)) + off_k[jj][e]);
      }
  }
  // The diagonal blocks, one exponential a pair and channel, shared by the
  // three sums. Own row o = b0 + g (+ 8): dr^w takes the o − b0 terms j < o,
  // dk^w the b0 + 15 − o terms t > o, so every thread adds 15 terms a row,
  // in 15 steps: at step s the term j = b0 + s of dr^w while s < o − b0,
  // else t = b0 + s + 1 of dk^w (both exponents read c of row b0 + s). A
  // step of dr^w also gives the pair matrix's A_oj over this thread's 8
  // channels; the four lanes of a row add theirs (32 channels), and the two
  // warps of a sub-chunk leave their halves below the diagonal (channels
  // 0 .. 31) and above it (32 .. 63), added in that order once both are in.
  // The u-bonus A_oo the same way, its second half in sB.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int o = b0 + g + 8 * half, lead = o - b0;
    float ce_o[8], c_o[8], r_o[8], a_u = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int d = col(x / 2, x);
      ce_o[x] = ce_at(o, d);
      c_o[x] = c_at(o, d);
      r_o[x] = to_f32(sR[o * LD + d]);
      a_u += r_o[x] * (sU[d] * to_f32(sK[o * LD + d]));
    }
    a_u += __shfl_xor_sync(0xffffffffu, a_u, 1);
    a_u += __shfl_xor_sync(0xffffffffu, a_u, 2);
    if (q == 0) {
      if (n0 == 0) sA[o * kRow + o] = a_u;
      else sB[o] = a_u;
    }
#pragma unroll 1
    for (int s_ = 0; s_ < kSub - 1; ++s_) {
      const bool to_r = s_ < lead;
      const int cr = b0 + s_;
      const float pv = to_r ? sP[o * kRow + cr] : sP[(cr + 1) * kRow + o];
      const T* xr = to_r ? sK + cr * LD : sR + (cr + 1) * LD;
      float a_part = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int d = col(x / 2, x);
        const float cs = c_at(cr, d), xv = to_f32(xr[d]);
        const float ee = e2(to_r ? ce_o[x] - cs : cs - c_o[x]);
        const float term = pv * xv * ee;
        if (to_r) drw[x / 2][2 * half + (x & 1)] += term;
        else dkw[x / 2][2 * half + (x & 1)] += term;
        a_part += r_o[x] * xv * ee;   // A_oj's part where to_r (xv is then k_j)
      }
      a_part += __shfl_xor_sync(0xffffffffu, a_part, 1);
      a_part += __shfl_xor_sync(0xffffffffu, a_part, 2);
      if (q == 0 && to_r) sA[n0 == 0 ? o * kRow + cr : cr * kRow + o] = a_part;
    }
  }
  // dr = dr^w + u ⊙ k P_tt, dk = dk^w + u ⊙ r P_tt
  float ptt[2];
  {
    T* drb = dr + b * st.dr.b + h * st.dr.h;
    T* dkb = dk + b * st.dk.b + h * st.dk.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) ptt[half] = sP[row(2 * half) * kRow + row(2 * half)];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row(e), d = col(jj, e);
        if (t < nt && d < hd) {
          const float p = ptt[e >> 1];
          drb[(long long)(t0 + t) * st.dr.s + d] =
              from_f32<T>(drw[jj][e] + sU[d] * to_f32(sK[t * LD + d]) * p);
          dkb[(long long)(t0 + t) * st.dk.s + d] =
              from_f32<T>(dkw[jj][e] + sU[d] * to_f32(sR[t * LD + d]) * p);
        }
      }
  }
  __syncthreads();   // both halves of the diagonal blocks are in
  for (int it = threadIdx.x; it < 4 * 136; it += kThreads) {
    int p = it % 136, tt = 0;
    while (p > tt) p -= ++tt;   // (tt, p): p <= tt
    const int t = kSub * (it / 136) + tt, s_ = kSub * (it / 136) + p;
    if (s_ < t) {
      sA[t * kRow + s_] += sA[s_ * kRow + t];
      sA[s_ * kRow + t] = 0.f;
    } else {
      sA[t * kRow + t] += sB[t];
    }
  }
  __syncthreads();   // the pair matrix is complete

  // dv (j, e) = Σ_{t ≥ j} A_tj do_te + k̃·dS_out; the pair matrix is 0 where
  // t's sub-chunk precedes j's
  {
    warp_mma_fn<4, false, false>(dvv, [&](int j, int t) { return sA[t * kRow + j]; }, rd_d, b0,
                                 n0, b0, kN);
    T* dvb = dv + b * st.dv.b + h * st.dv.h;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row(e), c = col(jj, e);
        if (t < nt && c < hd) dvb[(long long)(t0 + t) * st.dv.s + c] = from_f32<T>(dvv[jj][e]);
      }
  }
  __syncthreads();   // the pair matrix, do and P are read
  // r ⊙ dr^w, k ⊙ dk^w and r ⊙ k ⊙ P_tt for dlogw and du
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row(e), d = col(jj, e);
      const float rr = to_f32(sR[t * LD + d]), kk = to_f32(sK[t * LD + d]);
      sA[t * kRow + d] = rr * drw[jj][e];
      sD[t * kRow + d] = kk * dkw[jj][e];
      sP[t * kRow + d] = rr * kk * ptt[e >> 1];
    }
  __syncthreads();

  // dlogw and du: four threads a column d, 16 rows each. The reverse sum of
  // r ⊙ dr^w − k ⊙ dk^w over the chunk: each quarter's total (in sC, free
  // now), then each thread's rows from the sum of the later quarters.
  {
    const int d = threadIdx.x % kN, part = threadIdx.x / kN, r0 = kSub * part;
    float zq = 0.f, uq = 0.f;
    for (int t = r0; t < r0 + kSub; ++t) {
      zq += sA[t * kRow + d] - sD[t * kRow + d];
      uq += sP[t * kRow + d];
    }
    sC[part * kN + d] = zq;
    sC[(4 + part) * kN + d] = uq;
    __syncthreads();
    float z = 0.f;
    for (int later = 3; later > part; --later) z += sC[later * kN + d];
    float* dwb = dlogw + b * st.dw.b + h * st.dw.h;
    for (int t = r0 + kSub - 1; t >= r0; --t) {
      const float qt = sA[t * kRow + d];
      z += qt - sD[t * kRow + d];
      if (t < nt && d < hd) dwb[(long long)(t0 + t) * st.dw.s + d] = sX[d] + z - qt;
    }
    if (part == 0 && d < hd)
      du_part[item * hd + d] =
          ((sC[4 * kN + d] + sC[5 * kN + d]) + sC[6 * kN + d]) + sC[7 * kN + d];
  }
}

constexpr size_t kStatesSmem = sizeof(float) * (2 * kN * kCol + kN * kN);

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
  constexpr size_t grads_smem = GradsSmem<T>::BYTES;
  err = cudaFuncSetAttribute(rwkv6_bwd_grads<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(grads_smem));
  if (err == cudaSuccess)   // as much of each SM's 256 KB as shared memory as it takes
    err = cudaFuncSetAttribute(rwkv6_bwd_grads<T, VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_grads<T, VEC><<<grid, kThreads, grads_smem, stream>>>(
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
