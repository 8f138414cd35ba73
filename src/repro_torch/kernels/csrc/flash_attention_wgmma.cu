// flash_attention_wgmma.cu — causal GQA flash attention (forward), bf16, on
// Hopper's tensor cores (sm_90a): TMA-fed K/V ring, wgmma products.
//
//     o[b, h, t] = Σ_s softmax_s(scale · q[b, h, t] · k[b, h // g, s]) · v[b, h // g, s]
//                  over the keys s ≤ t (causal) with s > t − window (window > 0)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel) for bf16 inputs; f32 inputs keep the
// CUDA-core kernel in flash_attention.cu. The same function: scores, running
// max and running sum in f32, masked scores at −1e30, the output cast to
// bf16, the same skip of key tiles wholly outside every row's causal window,
// an optional logit soft-cap, and any S (the ragged last tile is masked).
//
// Bound: operations. A (64-row, 64-key) tile pair costs 4·64·64·hd flops on
// 2·64·hd bf16 K/V elements, far above the card's flop-per-byte balance, so
// the products belong on the tensor cores. At recurrentgemma-9b's serve shape
// (B = 4, H = 16, KV = 1, S = 4096, hd = 256, window 2048) a head needs 1,584
// of the 4,096 tile pairs.
//
// Design: one block owns a (batch, head, 128-row query tile) and runs three
// roles. Warpgroup 2 is the producer: one thread issues TMA copies of the Q
// tile and then of every K and V tile the rows can see into a 2-stage ring in
// shared memory, each stage guarded by "full" mbarriers (K and V apart, so
// QKᵀ starts while V is in flight) and an "empty" mbarrier the consumers
// arrive on. Warps 0-3 and 4-7 are two consumer warpgroups, 64 query rows
// each, that share the ring:
//   S = Q·Kᵀ    wgmma m64n64k16, both operands from shared memory, bf16 × bf16
//               products (exact in f32) accumulated in f32;
//   softmax     online, in registers, on log2(e)-scaled scores with exp2f; a
//               row's max and sum over the four lanes that hold it;
//   O += P·V    wgmma m64n{hd}k16 with P from registers and V (hd contiguous)
//               read transposed from shared memory. The TPU kernel multiplies
//               P by V in f32, so P goes in as two bf16 halves, P = P_hi + P_lo
//               (about 16 significant bits; V is exact in bf16): two wgmmas
//               per 16 keys, 1.5× the minimal tensor-core work.
// The O accumulator is 64 × hd f32 per warpgroup: 128 registers a thread at
// hd = 256, so setmaxnreg moves registers from the producer warpgroup (down
// to 24) to the consumers (up to 240); at 168 each (the 384-thread block's
// even share) hd = 256 spilled. Tiles are stored as TMA writes them:
// 64-element (128-byte) column blocks with the 128-byte swizzle (64- and
// 32-byte for hd = 32, 16), which is the layout the wgmma descriptors name;
// shared memory at hd = 256 is Q 64 KB + 2 × (K + V) 128 KB. Every score of
// a tile is masked (a branch that skipped the mask on interior tiles measured
// slower on the H100).
// A warpgroup skips the products of a tile wholly outside its own rows'
// window but still waits on it and releases it. Blocks go longest query tile
// first, and the heads of one batch are adjacent, so with KV = 1 the heads of
// a batch re-read one K/V from L2.
//
// Layout: q, k, v are (B, heads, S, hd) with hd contiguous and (batch, head,
// sequence) strides in elements that the TMA descriptors carry (multiples of
// 8 elements, a 16-byte aligned base; the wrapper checks), so the model's
// (B, S, heads, hd) activations go in without a copy. o is written with its
// own strides.
//
// Training: with a non-null lse the kernel also writes each query row's
// natural log-sum-exp, (m + log2 l)·ln 2 in f32 (m and l are in base 2),
// (B, H, S) contiguous, for the backward (flash_attention_bwd.cu). Serving
// passes null.
//
// The Hopper building blocks (mbarriers, TMA, wgmma descriptors and
// instructions, tensor maps) are in hopper.cuh, shared with the backward.
//
// Interface: plain C, loaded with ctypes. The entry point builds the three
// tensor maps (cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point), launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (or 1000 + the driver's
// error code if a tensor map cannot be built).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;             // query rows per block: two warpgroups
constexpr int kBK = kRows;           // keys per tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg: 128·24 + 256·240 ≤ 64 K
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ the kernel

// Q (two tiles), the K and V rings, barriers, and 1 KB to align the start
template <int HD>
constexpr size_t kSmem = size_t(2 + 2 * kStages) * Tiles<HD>::TILE + 1024 + 128;

// key tiles [lo, hi] that some query row in [r0, r1] can see
__device__ __forceinline__ void tile_range(int r0, int r1, int S, int causal, int window, int& lo,
                                           int& hi) {
  hi = causal ? r1 / kBK : (S - 1) / kBK;
  lo = (window > 0 && r0 - window + 1 > 0) ? (r0 - window + 1) / kBK : 0;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
            float* __restrict__ lse, long long ob, long long oh, long long os, int B, int H,
            int group, int S, int causal, int window, float scale, float softcap) {
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + 2 * T::TILE;                   // kStages tiles
  uint8_t* sV = sK + kStages * T::TILE;             // kStages tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + kStages * T::TILE);
  uint64_t* bar_k = bar_q + 1;                      // K of a stage landed
  uint64_t* bar_v = bar_k + kStages;                // V of a stage landed
  uint64_t* bar_empty = bar_v + kStages;            // every consumer warp is done with a stage

  // longest query tiles first; the heads of one batch adjacent
  const int nq = (S + kBQ - 1) / kBQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int q0 = (nq - 1 - blockIdx.x / (H * B)) * kBQ, kvh = h / group;
  int kt_lo, kt_hi;
  tile_range(q0, min(q0 + kBQ, S) - 1, S, causal, window, kt_lo, kt_hi);
  const int n_tiles = kt_hi - kt_lo + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, 2 * T::TILE);
      for (int c = 0; c < 2; ++c)
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(sQ + c * T::TILE + cb * T::BLOCK, &tmq, bar_q, cb * T::CB, q0 + 64 * c, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, k0 = (kt_lo + i) * kBK;
        if (i >= kStages) mbar_wait(&bar_empty[st], (i / kStages - 1) & 1);
        mbar_expect_tx(&bar_k[st], T::TILE);
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(sK + st * T::TILE + cb * T::BLOCK, &tmk, &bar_k[st], cb * T::CB, k0, kvh, b);
        mbar_expect_tx(&bar_v[st], T::TILE);
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(sV + st * T::TILE + cb * T::BLOCK, &tmv, &bar_v[st], cb * T::CB, k0, kvh, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // a consumer warpgroup: query rows wr0 .. wr0 + 63; this thread holds rows
  // row0 and row0 + 8, columns 8j + 2·t4 + {0, 1} of every 8-column group j
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int wr0 = q0 + 64 * wg, row0 = wr0 + 16 * (warp % 4) + g;
  int w_lo = 0, w_hi = -1;  // the key tiles this warpgroup's rows see
  if (wr0 < S) tile_range(wr0, min(wr0 + 63, S - 1), S, causal, window, w_lo, w_hi);
  const uint8_t* q_tile = sQ + wg * T::TILE;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, kt = kt_lo + i, k0 = kt * kBK;
    const uint32_t phase = (i / kStages) & 1;
    mbar_wait(&bar_k[st], phase);
    if (kt >= w_lo && kt <= w_hi) {
      // S = Q·Kᵀ over hd in steps of 16
      const uint8_t* k_tile = sK + st * T::TILE;
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss_m64n64(s, T::k_desc(q_tile, ks), T::k_desc(k_tile, ks), ks > 0);
      wgmma_commit();
      wgmma_wait_all();

      // mask, scale to log2 units, online softmax of rows row0 (r = 0), row0 + 8 (r = 1)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int row = row0 + 8 * ((j >> 1) & 1);
        const int col = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
        float x = s[j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[j] = ok ? x * kLog2e : kNegInf;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      // P = P_hi + P_lo as wgmma A fragments: keys 16kk.. of rows (g, g + 8)
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[4 * j + e] - m[e >> 1]);
          l[e >> 1] += p[e];
          lo[e] = p[e] - __bfloat162float(__float2bfloat16_rn(p[e]));
        }
        p_hi[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
        p_hi[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
        p_lo[j / 2][2 * (j % 2)] = pack_bf16(lo[0], lo[1]);
        p_lo[j / 2][2 * (j % 2) + 1] = pack_bf16(lo[2], lo[3]);
      }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= corr[(j >> 1) & 1];

      // O += P_hi·V + P_lo·V over the tile's keys in steps of 16
      mbar_wait(&bar_v[st], phase);
      const uint8_t* v_tile = sV + st * T::TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = T::row_desc(v_tile, kk);
        wgmma_rs<HD>(acc, p_hi[kk], dv);
        wgmma_rs<HD>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
    } else {
      mbar_wait(&bar_v[st], phase);  // keep the ring's phases in step
    }
    if (lane == 0) mbar_arrive(&bar_empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* obase = o + b * ob + h * oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * H + h) * S + row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
    uint32_t* dst = reinterpret_cast<uint32_t*>(obase + row * os + 2 * t4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      dst[4 * j] = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------ host side

struct Strides {
  long long b, h, s;
};

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int KV, int S, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  using T = Tiles<HD>;
  const CUtensorMapSwizzle swizzle = T::SWIZZLE;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, HD, S, H, B, sq.s, sq.h, sq.b, T::CB, swizzle);
  if (err == 0) err = make_map(&mk, k, HD, S, KV, B, sk.s, sk.h, sk.b, T::CB, swizzle);
  if (err == 0) err = make_map(&mv, v, HD, S, KV, B, sv.s, sv.h, sv.b, T::CB, swizzle);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem<HD>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * H * B;
  flash_wgmma<HD><<<static_cast<unsigned>(blocks), kThreads, kSmem<HD>, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, so.b, so.h, so.s, B, H, H / KV, S, causal,
      window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and o bf16; lse (B, H, S) float32 or null. Strides in elements:
// (batch, head, sequence) of q, k, v and o in that order; those of q, k and
// v multiples of 8, their bases 16-byte aligned (the TMA descriptors' rule).
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                         float* lse, long long qb, long long qh, long long qs,
                                         long long kb, long long kh, long long ks, long long vb, long long vh,
                                         long long vs, long long ob, long long oh, long long os,
                                         int B, int H, int KV, int S, int hd, int causal,
                                         int window, float scale, float softcap, void* stream) {
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
