// 3x3 stride-1 pad-1 convolution plus bias, with the InstanceNorm statistics
// of its output, NCHW, for Hopper (sm_90a):
//
//   y = conv3x3(x, w) + b,   mean[n, c] = sum(y) / HW,
//   rstd[n, c] = 1 / sqrt(max(sum(y^2) / HW - mean^2, 0) + eps)
//
// with the sums taken over the f32 accumulator (bias included) before y is
// cast to x's type, as the Pallas kernel does.
//
// Replaces: supervised_gan_tpu/ops/pallas/conv3x3_in.py `_kernel` (:65),
// reached through `_fwd_impl` (:114) of `conv3x3_in_act` (:179).  There the
// per-lane (sum, sum of squares) ride the conv's f32 accumulator across the
// TPU's sequential grid and are folded per channel after the call (:157-162).
// CUDA blocks run in no order, so each block writes its own partial sums and
// a second pass folds them.
//
// What bounds it on the H100: arithmetic, as conv3x3.cu: 2*9*Ci*Co FLOPs per
// output pixel (19.3 GFLOP at the 512^2 64->64 site, 0.29 ms at the f32
// CUDA-core rate); the statistics add 2 FLOPs per output element.
//
// Design (simple and right first):
//   * pass 1: the tiled main loop of conv3x3_tile.cuh (a block owns a 16x16
//     output tile for 32 output channels), the bias and the store of y; then
//     each channel's f32 values (0 outside the image) are summed, and their
//     squares, over the block's 256 pixels: warp shuffles, then the 8 warps'
//     sums in a fixed order in shared memory; one float2 per (n, c, tile);
//   * pass 2: one block per (n, c) sums its tiles' partials in a fixed order
//     (strided per thread, then warp shuffles and shared memory) and writes
//     mean and rstd.  No atomics and no running sum across tiles: the result
//     is the same from run to run.

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3_tile;

constexpr int COB = 32;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_in_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float2* __restrict__ partials, int Ci, int Co, int H, int W,
                  int tiles_w, int tiles) {
  __shared__ Smem<COB> sm;
  __shared__ float2 red[WARPS][COB];
  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * COB;
  const int n = blockIdx.z;
  const size_t plane = (size_t)H * W;

  float acc[COB];
  accumulate<T, COB>(x + (size_t)n * Ci * plane, w, Ci, Co, H, W, oy0, ox0,
                     co0, sm, acc);

  const int oy = oy0 + threadIdx.x / TW;
  const int ox = ox0 + threadIdx.x % TW;
  const bool inside = oy < H && ox < W;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    float v = 0.f;
    if (inside && co0 + j < Co) {
      v = acc[j] + (bias != nullptr ? bias[co0 + j] : 0.f);
      store(y + ((size_t)n * Co + co0 + j) * plane + (size_t)oy * W + ox, v);
    }
    const float s1 = warp_sum(v);
    const float s2 = warp_sum(v * v);
    if (lane == 0) red[warp][j] = make_float2(s1, s2);
  }
  __syncthreads();
  if (threadIdx.x < COB && co0 + threadIdx.x < Co) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      s1 += red[k][threadIdx.x].x;
      s2 += red[k][threadIdx.x].y;
    }
    partials[((size_t)n * Co + co0 + threadIdx.x) * tiles + tile] =
        make_float2(s1, s2);
  }
}

// one block per (n, c) plane: fold its `tiles` partials into mean and rstd
__global__ void __launch_bounds__(THREADS)
conv3x3_in_fold_kernel(const float2* __restrict__ partials,
                       float* __restrict__ stats, int NC, int tiles, int HW,
                       float eps) {
  __shared__ float red[2][WARPS];
  const int p = blockIdx.x;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < tiles; i += THREADS) {
    const float2 v = partials[(size_t)p * tiles + i];
    s1 += v.x;
    s2 += v.y;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < WARPS ? red[0][lane] : 0.f;
    s2 = lane < WARPS ? red[1][lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / (float)HW;
      const float var = fmaxf(s2 / (float)HW - mean * mean, 0.f);
      stats[p] = mean;
      stats[NC + p] = 1.f / sqrtf(var + eps);
    }
  }
}

int num_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

template <typename T>
void launch(const void* x, const void* w, const float* bias, void* y,
            float* partials, float* stats, int N, int Ci, int Co, int H,
            int W, float eps, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = num_tiles(H, W);
  const dim3 grid(tiles, (Co + COB - 1) / COB, N);
  float2* part = reinterpret_cast<float2*>(partials);
  conv3x3_in_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), part, Ci, Co, H, W, tiles_w, tiles);
  conv3x3_in_fold_kernel<<<N * Co, THREADS, 0, stream>>>(
      part, stats, N * Co, tiles, H * W, eps);
}

}  // namespace

// Floats of scratch that conv3x3_in_fwd needs for its partial sums.
extern "C" long long conv3x3_in_workspace(int N, int Co, int H, int W) {
  return 2LL * N * Co * num_tiles(H, W);
}

// x (N, Ci, H, W), w (Co, Ci, 3, 3) and y (N, Co, H, W) of `dtype` (0 =
// float32, 1 = bfloat16); bias float32 (Co) or null; partials: the
// workspace; stats: 2 * N * Co floats that receive each plane's mean and then
// its rstd.  Returns cudaGetLastError() after both launches.
extern "C" int conv3x3_in_fwd(const void* x, const void* w, const float* bias,
                              void* y, float* partials, float* stats, int N,
                              int Ci, int Co, int H, int W, float eps,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, bias, y, partials, stats, N, Ci, Co, H, W, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, bias, y, partials, stats, N, Ci, Co, H, W,
                          eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
