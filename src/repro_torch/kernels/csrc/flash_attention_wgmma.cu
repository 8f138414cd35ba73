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
// Interface: plain C, loaded with ctypes. The entry point builds the three
// tensor maps (cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point), launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (or 1000 + the driver's
// error code if a tensor map cannot be built).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;             // query rows per block: two warpgroups
constexpr int kBK = 64;              // keys per tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg: 128·24 + 256·240 ≤ 64 K
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a (cols, rows) box of a 4-D tensor map at (c0, c1, c2, c3) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(mode) << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ wgmma wrappers
// m64n64k16 with A and B from shared memory (S = Q·Kᵀ); m64n{hd}k16 with A
// from registers and B transposed (O += P·V).

__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ the kernel

template <int HD>
struct Tiles {
  static constexpr int CB = HD < 64 ? HD : 64;       // elements in one column block's row
  static constexpr int RB = 2 * CB;                  // its bytes: the swizzle span
  static constexpr int NCB = HD / CB;                // column blocks of a tile
  static constexpr int BLOCK = kBK * RB;             // bytes of one 64-row column block
  static constexpr int TILE = NCB * BLOCK;           // bytes of a 64 × hd bf16 tile
  static constexpr uint32_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * RB;            // 8-row groups (both operand kinds)
  // Q (two tiles), the K and V rings, barriers, and 1 KB to align the start
  static constexpr size_t SMEM = size_t(2 + 2 * kStages) * TILE + 1024 + 128;
};

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_m64n16(d, a, db);
  else if constexpr (HD == 32) wgmma_rs_m64n32(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_m64n64(d, a, db);
  else if constexpr (HD == 128) wgmma_rs_m64n128(d, a, db);
  else wgmma_rs_m64n256(d, a, db);
}

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
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
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
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int off = (ks * 16 / T::CB) * T::BLOCK + (ks * 16 % T::CB) * 2;
        wgmma_ss_m64n64(s, make_desc(q_tile + off, 16, T::SBO, T::MODE),
                        make_desc(k_tile + off, 16, T::SBO, T::MODE), ks > 0);
      }
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
        const uint64_t dv = make_desc(v_tile + kk * 16 * T::RB, T::BLOCK, T::SBO, T::MODE);
        wgmma_pv<HD>(acc, p_hi[kk], dv);
        wgmma_pv<HD>(acc, p_lo[kk], dv);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, S, heads, B) bf16 with element strides (s, h, b); boxes of (cb, 64) elements
int make_map(CUtensorMap* map, const void* base, int hd, int S, int heads, int B, long long ss,
             long long sh, long long sb, int cb, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(cb), cuuint32_t(kBK), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

struct Strides {
  long long b, h, s;
};

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int KV, int S, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  using T = Tiles<HD>;
  const CUtensorMapSwizzle swizzle = T::MODE == 1   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::MODE == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, HD, S, H, B, sq.s, sq.h, sq.b, T::CB, swizzle);
  if (err == 0) err = make_map(&mk, k, HD, S, KV, B, sk.s, sk.h, sk.b, T::CB, swizzle);
  if (err == 0) err = make_map(&mv, v, HD, S, KV, B, sv.s, sv.h, sv.b, T::CB, swizzle);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * H * B;
  flash_wgmma<HD><<<static_cast<unsigned>(blocks), kThreads, T::SMEM, stream>>>(
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
