// im2col.cu — the FEMNIST CNN's patch gather on Hopper (sm_90a): every
// sample's 5×5 patches at SAME padding and stride 1, in one launch.
//
//     cols[b, c·25 + 5·ki + kj, W·oh + ow] = x[b, c, oh + ki − 2, ow + kj − 2]
//                                            (0 outside the plane)
//
// x (B, C, H, W) f32 contiguous -> cols (B, C·25, H·W) contiguous: exactly
// F.unfold(x, 5, padding=2), the same values in the same order.
//
// Replaces no TPU kernel: the reference computes its convolutions with
// XLA (jax.lax.conv_general_dilated), not Pallas. It exists because the
// port computes each convolution as an f32 matmul over these patches
// (models/femnist_cnn.py::conv5_same: cuDNN's weight gradient is not
// f32-exact on the H100), and ATen's CUDA im2col launches once per sample:
// under the vmap of a 16-client chunk, 2 convolutions × 160 samples = 320
// small launches a local step, each far too small to fill the card.
//
// Bound: bytes, and the writes are 25× the reads: B·C·H·W·4 bytes read,
// B·C·25·H·W·4 written. At the full-width CNN's chunk shapes (160 samples;
// conv1 (160, 1, 28, 28), conv2 (160, 32, 14, 14)) that is 113 MB written
// and 4.5 MB read: 35 µs at 3.35 TB/s for both calls.
//
// Design: one block per (plane, band of output rows, group of kernel
// rows). The block stages its band of the (sample, channel) plane, with
// the 2-pixel halo and zeros outside the plane, in shared memory — the
// plane is read from device memory once (again only by the other groups
// of the same plane, from L2) — then writes its kernel rows: each of the
// 25 rows of a plane is one contiguous run of H·W floats, so a thread owns
// V = 4 neighbouring positions (one 16-byte store) of a run and walks the
// rows of its group with them; its 4 shared-memory offsets are computed
// once. The caller (kernels/im2col.py::tiling) picks the band (the whole
// plane unless it would not fit 48 KB of shared memory), the kernel-row
// groups (1, 5 or 25, the fewest that give the card 4 blocks an SM:
// conv2's chunk has 5,120 planes and takes one group, conv1's has 160 and
// takes 5) and the block's threads (the run's float4s, then as many rows
// side by side as fit 256 threads). A scalar variant (V = 1) takes an H·W
// that is not a multiple of four.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise and allocates nothing; it returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a
// tiling the kernel does not take) so the wrapper can raise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 25;                  // 5 × 5
constexpr int kMaxThreads = 256;
constexpr int kMaxStagedFloats = 12288;    // 48 KB: no opt-in attribute needed

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
im2col5_kernel(const float* __restrict__ x, int H, int W, int band, int bands, int groups,
               float* __restrict__ cols) {
  extern __shared__ float tile[];          // (band + 4) × (W + 4), zero halo
  const int64_t blk = blockIdx.x;
  const int group = static_cast<int>(blk % groups);
  const int oh0 = static_cast<int>((blk / groups) % bands) * band;
  const int64_t plane = blk / (static_cast<int64_t>(groups) * bands);
  const int bh = min(band, H - oh0);
  const int pitch = W + 4;
  const int hw = H * W;

  const float* src = x + plane * hw;
  for (int i = threadIdx.x; i < (bh + 4) * pitch; i += blockDim.x) {
    const int ih = oh0 - 2 + i / pitch, iw = i % pitch - 2;
    tile[i] = (ih >= 0 && ih < H && iw >= 0 && iw < W) ? src[ih * W + iw] : 0.0f;
  }
  __syncthreads();

  // the thread layout: `lanes` threads across a run, `side` rows side by side
  const int lanes = min((band * W + V - 1) / V, static_cast<int>(blockDim.x));
  const int side = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, first = threadIdx.x / lanes;
  if (first >= side) return;
  const int rows = kTaps / groups, r0 = group * rows;
  const int run = bh * W;                  // this band's positions of a row
  float* dst = cols + plane * kTaps * hw + oh0 * W;
  for (int j = lane * V; j < run; j += lanes * V) {
    int off[V];
    int oh = j / W, ow = j - oh * W;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      off[e] = oh * pitch + ow;
      if (++ow == W) { ow = 0; ++oh; }
    }
    for (int r = r0 + first; r < r0 + rows; r += side) {
      const int k = (r / 5) * pitch + r % 5;
      float* o = dst + static_cast<int64_t>(r) * hw + j;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(tile[off[0] + k], tile[off[1] + k], tile[off[2] + k], tile[off[3] + k]);
      } else {
        *o = tile[off[0] + k];
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (planes = B·C, H, W) f32; cols: (planes · 25, H·W) f32. band, groups,
// vec (4 or 1) and threads are kernels/im2col.py::tiling's.
extern "C" int im2col5_f32(const void* x, long long planes, int H, int W, int band,
                           int groups, int vec, int threads, void* cols, void* stream) {
  const int bands = (H + band - 1) / band;
  const long long blocks = planes * bands * groups;
  const int staged = (band + 4) * (W + 4);
  const bool vec_ok = (H * W) % 4 == 0 && (bands == 1 || (band * W) % 4 == 0) &&
                      aligned(cols, 16);
  if (band < 1 || kTaps % groups != 0 || staged > kMaxStagedFloats || threads < 1 ||
      threads > kMaxThreads || blocks < 1 || blocks > INT32_MAX || (vec != 1 && vec != 4) ||
      (vec == 4 && !vec_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = staged * sizeof(float);
  const float* xp = static_cast<const float*>(x);
  float* cp = static_cast<float*>(cols);
  if (vec == 4) {
    im2col5_kernel<4><<<static_cast<unsigned>(blocks), threads, smem, s>>>(
        xp, H, W, band, bands, groups, cp);
  } else {
    im2col5_kernel<1><<<static_cast<unsigned>(blocks), threads, smem, s>>>(
        xp, H, W, band, bands, groups, cp);
  }
  return static_cast<int>(cudaGetLastError());
}
