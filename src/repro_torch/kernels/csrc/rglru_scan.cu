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
// Design: the recurrence is a chain of dependent multiply-adds per channel
// (unfused, two roundings each, as the plain version computes them, so the
// two agree bit for bit), walked in time order by one owner per channel;
// the loads of later steps do not depend on it. So the loads are taken off
// the chain: each block owns a tile of kTile = 32 channels of one batch row
// (one warp, one channel a lane) and keeps a ring of kStages shared-memory
// stages, each holding kSteps = 32 time steps of the tile's a and b. The
// lanes fill the stages with 16-byte cp.async copies (coalesced: 8 lanes
// a 128-byte time-step row) in commit groups, kStages - 1 stages ahead of
// the stage the lanes are running the chain on, so 24 KB of each block's
// loads are in flight while it computes. At the prefill shape the grid is
// 128 × 4 = 512 one-warp blocks, about four per SM, so every SM streams
// about 96 KB at once, enough to cover the device memory's latency at its
// full rate. Each step's h goes out as one 128-byte coalesced store per
// warp. A partial last stage (S % kSteps) and a partial last tile (C % 32)
// are masked; S = 1 (a decode step) is one partial stage. A scalar kernel
// (one thread a channel, direct loads) takes a C that is not a multiple of
// four or a pointer not 16-byte aligned, which the copies cannot.
//
// Backward (rglru_scan_bwd_f32): the reference trains through jax.grad of
// its associative scan (src/repro/models/rglru.py:56-62); the TPU kernel has
// no backward. Given out (= h), a, h0 and the incoming dout and dh_last:
//     dh_{S-1} = dout_{S-1} + dh_last,   dh_t = dout_t + a_{t+1}·dh_{t+1}
//     db_t = dh_t,   da_t = dh_t·h_{t-1} (h_{-1} = h0 or 0),   dh0 = a_0·dh_0
// the forward's ring run backwards in time: each stage holds 32 steps of a,
// dout and h_{t-1} (the out rows one step earlier; the lane supplies h0 at
// t = 0), kBwdStages - 1 stages in flight, one lane a channel walking the
// chain from the last step to the first with unfused multiplies and adds,
// so it matches its plain version bit for bit. Bound: bytes; a, out and
// dout read, da and db written: 1.34 GB at the train shape (B = 8,
// S = 2048, C = 4096), 0.40 ms at 3.35 TB/s.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;     // channels of a block: one warp, a channel a lane
constexpr int kSteps = 32;    // time steps a stage holds
constexpr int kStages = 4;    // ring depth: kStages - 1 stages in flight
constexpr int kChunks = kTile / 4;   // 16-byte copies per time-step row of a tile

// a·h + b with two roundings and no FMA contraction, as the plain version
// computes it, so the two agree bit for bit
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Ring {
  float a[kStages][kSteps][kTile];
  float b[kStages][kSteps][kTile];
};   // 32 KB

__global__ void __launch_bounds__(kTile)
rglru_ring(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ h0, float* __restrict__ out, float* __restrict__ hlast,
           int S, int C) {
  __shared__ __align__(16) Ring ring;
  const int lane = threadIdx.x, c0 = blockIdx.x * kTile, bi = blockIdx.y;
  const bool live = c0 + lane < C;
  const int chunks = min(kTile, C - c0) / 4;           // C % 4 == 0 here
  const int n_stages = (S + kSteps - 1) / kSteps;
  const int64_t base = static_cast<int64_t>(bi) * S * C + c0;

  // Issue stage st's copies into its slot; every lane commits one group per
  // call, empty past the end, so the group count stays kStages - 1 ahead.
  auto fill = [&](int st) {
    if (st < n_stages) {
      const int t0 = st * kSteps, slot = st % kStages, n_t = min(kSteps, S - t0);
      for (int k = lane; k < n_t * kChunks; k += kTile) {
        const int t = k / kChunks, q = k % kChunks;
        if (q < chunks) {
          const int64_t g = base + static_cast<int64_t>(t0 + t) * C + 4 * q;
          cp_async16(&ring.a[slot][t][4 * q], a + g);
          cp_async16(&ring.b[slot][t][4 * q], b + g);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) fill(st);
  float h = (h0 != nullptr && live) ? h0[static_cast<int64_t>(bi) * C + c0 + lane] : 0.f;
  float* o = out + base + lane;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();   // this lane's copies of stage st have landed,
    __syncwarp();                   // every lane's too; all have left stage st - 1
    fill(st + kStages - 1);         // into stage st - 1's slot
    const int slot = st % kStages, t0 = st * kSteps, n_t = min(kSteps, S - t0);
    const float* as = ring.a[slot][0] + lane;
    const float* bs = ring.b[slot][0] + lane;
    float* ot = o + static_cast<int64_t>(t0) * C;
    if (live && n_t == kSteps) {
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        h = step(as[t * kTile], h, bs[t * kTile]);
        ot[static_cast<int64_t>(t) * C] = h;
      }
    } else if (live) {
      for (int t = 0; t < n_t; ++t) {
        h = step(as[t * kTile], h, bs[t * kTile]);
        ot[static_cast<int64_t>(t) * C] = h;
      }
    }
  }
  cp_async_wait<0>();
  if (live) hlast[static_cast<int64_t>(bi) * C + c0 + lane] = h;
}

__global__ void __launch_bounds__(kTile)
rglru_scalar(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, float* __restrict__ hlast,
             int B, int S, int C) {
  const long long g = (long long)blockIdx.x * kTile + threadIdx.x;
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

// ------------------------------------------------------------- backward

constexpr int kBwdStages = 3;   // three arrays a stage: 12 KB, two stages in flight

struct BwdRing {
  float a[kBwdStages][kSteps][kTile];
  float h[kBwdStages][kSteps][kTile];   // h_{t-1}
  float g[kBwdStages][kSteps][kTile];   // dout_t
};   // 36 KB

// the reverse chain of one step: dh = dout + carry; db = dh; da = dh·h_{t-1};
// carry = a·dh, each with one rounding as the plain version
__device__ __forceinline__ void bwd_step(float a, float hprev, float dout, float& carry,
                                         float* da, float* db) {
  const float dh = __fadd_rn(dout, carry);
  *db = dh;
  *da = __fmul_rn(dh, hprev);
  carry = __fmul_rn(a, dh);
}

__global__ void __launch_bounds__(kTile)
rglru_bwd_ring(const float* __restrict__ a, const float* __restrict__ out,
               const float* __restrict__ h0, const float* __restrict__ dout,
               const float* __restrict__ dhlast, float* __restrict__ da, float* __restrict__ db,
               float* __restrict__ dh0, int S, int C) {
  __shared__ __align__(16) BwdRing ring;
  const int lane = threadIdx.x, c0 = blockIdx.x * kTile, bi = blockIdx.y;
  const bool live = c0 + lane < C;
  const int chunks = min(kTile, C - c0) / 4;           // C % 4 == 0 here
  const int n_stages = (S + kSteps - 1) / kSteps;
  const int64_t base = static_cast<int64_t>(bi) * S * C + c0;

  // Issue the k-th stage in processing order (time stage n_stages - 1 - k)
  // into slot k % kBwdStages; every lane commits one group per call, empty
  // past the end. Row t of h is out row t - 1; at t = 0 the lane writes h0.
  auto fill = [&](int k) {
    if (k < n_stages) {
      const int t0 = (n_stages - 1 - k) * kSteps, slot = k % kBwdStages,
                n_t = min(kSteps, S - t0);
      for (int i = lane; i < n_t * kChunks; i += kTile) {
        const int t = i / kChunks, q = i % kChunks;
        if (q < chunks) {
          const int64_t g = base + static_cast<int64_t>(t0 + t) * C + 4 * q;
          cp_async16(&ring.a[slot][t][4 * q], a + g);
          cp_async16(&ring.g[slot][t][4 * q], dout + g);
          if (t0 + t > 0) cp_async16(&ring.h[slot][t][4 * q], out + g - C);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kBwdStages - 1; ++k) fill(k);
  const int64_t row = static_cast<int64_t>(bi) * C + c0 + lane;
  float carry = (dhlast != nullptr && live) ? dhlast[row] : 0.f;
  const float h_init = (h0 != nullptr && live) ? h0[row] : 0.f;
  for (int k = 0; k < n_stages; ++k) {
    cp_async_wait<kBwdStages - 2>();   // this lane's copies of stage k have landed,
    __syncwarp();                      // every lane's too; all have left stage k - 1
    fill(k + kBwdStages - 1);          // into stage k - 1's slot
    const int slot = k % kBwdStages, t0 = (n_stages - 1 - k) * kSteps,
              n_t = min(kSteps, S - t0);
    if (t0 == 0) ring.h[slot][0][lane] = h_init;   // no copy wrote this row
    const float* as = ring.a[slot][0] + lane;
    const float* hs = ring.h[slot][0] + lane;
    const float* gs = ring.g[slot][0] + lane;
    const int64_t off = base + lane + static_cast<int64_t>(t0) * C;
    if (live && n_t == kSteps) {
#pragma unroll
      for (int t = kSteps - 1; t >= 0; --t)
        bwd_step(as[t * kTile], hs[t * kTile], gs[t * kTile], carry,
                 da + off + static_cast<int64_t>(t) * C, db + off + static_cast<int64_t>(t) * C);
    } else if (live) {
      for (int t = n_t - 1; t >= 0; --t)
        bwd_step(as[t * kTile], hs[t * kTile], gs[t * kTile], carry,
                 da + off + static_cast<int64_t>(t) * C, db + off + static_cast<int64_t>(t) * C);
    }
  }
  cp_async_wait<0>();
  if (live && dh0 != nullptr) dh0[row] = carry;
}

__global__ void __launch_bounds__(kTile)
rglru_bwd_scalar(const float* __restrict__ a, const float* __restrict__ out,
                 const float* __restrict__ h0, const float* __restrict__ dout,
                 const float* __restrict__ dhlast, float* __restrict__ da,
                 float* __restrict__ db, float* __restrict__ dh0, int B, int S, int C) {
  const long long g = (long long)blockIdx.x * kTile + threadIdx.x;
  if (g >= (long long)B * C) return;
  const int bi = static_cast<int>(g / C), c = static_cast<int>(g % C);
  const long long row = (long long)bi * C + c, base = (long long)bi * S * C + c;
  float carry = dhlast ? dhlast[row] : 0.f;
  const float h_init = h0 ? h0[row] : 0.f;
  for (int t = S - 1; t >= 0; --t) {
    const long long i = base + (long long)t * C;
    bwd_step(a[i], t > 0 ? out[i - C] : h_init, dout[i], carry, da + i, db + i);
  }
  if (dh0) dh0[row] = carry;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// a, b, out: (B, S, C) f32 contiguous; h0 (nullable), hlast: (B, C) f32.
extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0, float* out,
                              float* hlast, int B, int S, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  const bool ring = C % 4 == 0 && aligned16(a) && aligned16(b);
  if (ring) {
    if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);   // grid.y
    const dim3 grid((C + kTile - 1) / kTile, B);
    rglru_ring<<<grid, kTile, 0, st>>>(a, b, h0, out, hlast, S, C);
  } else {
    const long long threads = (long long)B * C;
    rglru_scalar<<<static_cast<unsigned>((threads + kTile - 1) / kTile), kTile, 0, st>>>(
        a, b, h0, out, hlast, B, S, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, out, dout, da, db: (B, S, C) f32 contiguous; h0, dhlast, dh0 (each
// nullable): (B, C) f32. dh0 gets a_0·dh_0 where it is given.
extern "C" int rglru_scan_bwd_f32(const float* a, const float* out, const float* h0,
                                  const float* dout, const float* dhlast, float* da, float* db,
                                  float* dh0, int B, int S, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  const bool ring = C % 4 == 0 && aligned16(a) && aligned16(out) && aligned16(dout);
  if (ring) {
    if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);   // grid.y
    const dim3 grid((C + kTile - 1) / kTile, B);
    rglru_bwd_ring<<<grid, kTile, 0, st>>>(a, out, h0, dout, dhlast, da, db, dh0, S, C);
  } else {
    const long long threads = (long long)B * C;
    rglru_bwd_scalar<<<static_cast<unsigned>((threads + kTile - 1) / kTile), kTile, 0, st>>>(
        a, out, h0, dout, dhlast, da, db, dh0, B, S, C);
  }
  return static_cast<int>(cudaGetLastError());
}
