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
// a second kernel folds them.
//
// What bounds it on the H100: the convolution, as in conv3x3.cu.  At the
// 512^2 64->64 site f32 runs as 3xTF32 and is bound by operations (0.117
// ms), bf16 by bytes (0.020 ms); the statistics add 3 FLOPs an output value
// and 8 bytes a (channel, pixel tile).
//
// Design:
//   * main loop: conv3x3_mma.cuh's `accumulate`, as conv3x3.cu runs it (a
//     block owns 8 x 16 output pixels x 64 output channels, 8 warps on
//     mma.sync: bf16 m16n8k16, f32 as 3xTF32), over every input channel:
//     no split of K and no cluster;
//   * epilogue: the bias is added in f32 to each accumulator element and y
//     is stored from the fragments, as conv3x3.cu does.  From the same
//     values (0 outside the image and past Co) each lane sums its 4 values
//     of each of its 8 channels, and their squares (each square rounded
//     before it is added); xor shuffles by 4, 8 and 16 add the 8 lanes that
//     hold the same channels; the WARPS_M warps along the pixels are added
//     in order through shared memory (the main loop's buffers, free after a
//     barrier).  One float2 (sum, sum of squares) a (n, pixel tile,
//     channel), laid out [n][tile][channel]: a block's 64 channels are one
//     512-byte run;
//   * fold: a second kernel, one block of 1024 threads for 8 channels of
//     one image.  Thread (r, c) adds tiles r, r + 128, r + 256, ... in
//     order (a warp reads four tiles' 8 channels, 64-byte runs), then the
//     128 sums are added as a tree in shared memory (row r takes row
//     r + h, h = 64, 32, ..., 1), and one thread a channel forms mean, var
//     and rstd with every quotient, product and difference rounded apart:
//     no FMA, so a constant plane keeps var exactly 0.
// No atomics; the order of every sum is fixed by the shape, so two runs
// agree bitwise.

#include "conv3x3_epilogue.cuh"

namespace {

using namespace conv3x3_mma;
using namespace conv3x3_epilogue;

constexpr int FOLD_C = 8;                  // channels of one fold block
constexpr int FOLD_R = 128;                // tile strides of one fold block
constexpr int FOLD_THREADS = FOLD_C * FOLD_R;

// grid: (pixel tiles, output-channel tiles, N)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_in_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ y,
                     float2* __restrict__ partials, int Ci, int Co, int H,
                     int W, int tiles_w, int tiles, bool wvec, bool xvec) {
  extern __shared__ __align__(16) char smem[];
  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const int chunks = (Ci + Elem<T>::KC - 1) / Elem<T>::KC;

  float acc[2][4][4];
  accumulate<T>(x + (size_t)n * Ci * plane, w, Ci, Co, H, W, oy0, ox0, co0,
                0, chunks, smem, wvec, xvec, acc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  T* yn = y + (size_t)n * Co * plane;
  // s1[nt][jc], s2[nt][jc]: this lane's sums of channel
  // co0 + warp_n * 32 + nt * 8 + 2 * (lane & 3) + jc over its 4 pixels, in
  // the order (mt, jr) = (0, 0), (0, 1), (1, 0), (1, 1)
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int jc = 0; jc < 2; ++jc) s1[nt][jc] = s2[nt][jc] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Pos p = frag_pos(oy0, co0, ox0, warp_m, warp_n, lane, mt, nt, j);
        float v = 0.f;
        if (p.oy < H && p.co < Co && p.ox < W) {
          v = acc[mt][nt][j] + (bias != nullptr ? bias[p.co] : 0.f);
          store(yn + (size_t)p.co * plane + (size_t)p.oy * W + p.ox, v);
        }
        s1[nt][j & 1] += v;
        s2[nt][j & 1] += __fmul_rn(v, v);
      }
    }
  }
  // lanes with the same lane & 3 hold the same channels: after the
  // butterfly each of them has the warp's 32-pixel sums
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int jc = 0; jc < 2; ++jc) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[nt][jc] += __shfl_xor_sync(0xffffffffu, s1[nt][jc], o);
        s2[nt][jc] += __shfl_xor_sync(0xffffffffu, s2[nt][jc], o);
      }
    }
  }
  // red[warp_m][channel of the block]; the main loop's buffers are free
  // once every warp has passed its last MMA
  float2* red = reinterpret_cast<float2*>(smem);
  __syncthreads();
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int jc = 0; jc < 2; ++jc)
        red[warp_m * BN + warp_n * 32 + nt * 8 + 2 * lane + jc] =
            make_float2(s1[nt][jc], s2[nt][jc]);
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BN && co0 + c < Co) {
    float2 t = red[c];
#pragma unroll
    for (int m = 1; m < WARPS_M; ++m) {
      t.x += red[m * BN + c].x;
      t.y += red[m * BN + c].y;
    }
    partials[((size_t)n * tiles + tile) * Co + co0 + c] = t;
  }
}

// grid: (channel groups of FOLD_C, N).  Folds each plane's `tiles` partials
// into its mean and rstd.
__global__ void __launch_bounds__(FOLD_THREADS)
conv3x3_in_fold_kernel(const float2* __restrict__ partials,
                       float* __restrict__ stats, int N, int Co, int tiles,
                       int HW, float eps) {
  __shared__ float2 red[FOLD_R][FOLD_C];
  const int r = threadIdx.x / FOLD_C, cc = threadIdx.x % FOLD_C;
  const int c = blockIdx.x * FOLD_C + cc;
  const int n = blockIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (c < Co) {
    const float2* p = partials + (size_t)n * tiles * Co + c;
    for (int t = r; t < tiles; t += FOLD_R) {
      const float2 v = p[(size_t)t * Co];
      s1 += v.x;
      s2 += v.y;
    }
  }
  red[r][cc] = make_float2(s1, s2);
  __syncthreads();
#pragma unroll
  for (int h = FOLD_R / 2; h > 0; h >>= 1) {
    if (r < h) {
      red[r][cc].x += red[r + h][cc].x;
      red[r][cc].y += red[r + h][cc].y;
    }
    __syncthreads();
  }
  if (r == 0 && c < Co) {
    s1 = red[0][cc].x;
    s2 = red[0][cc].y;
    const float hw = (float)HW;
    const float mean = __fdiv_rn(s1, hw);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(s2, hw), __fmul_rn(mean, mean)), 0.f);
    const size_t p = (size_t)n * Co + c;
    stats[p] = mean;
    stats[(size_t)N * Co + p] =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
}

int num_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, void* y,
           float* partials, float* stats, int N, int Ci, int Co, int H,
           int W, float eps, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_in_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = num_tiles(H, W);
  const bool wvec = weights_vec<T>(w, Ci), xvec = halo_vec<T>(x, W);
  float2* part = reinterpret_cast<float2*>(partials);
  const dim3 grid(tiles, (Co + BN - 1) / BN, N);
  conv3x3_in_tc_kernel<T><<<grid, THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), part, Ci, Co, H, W, tiles_w, tiles, wvec, xvec);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return static_cast<int>(le);
  conv3x3_in_fold_kernel<<<dim3((Co + FOLD_C - 1) / FOLD_C, N), FOLD_THREADS,
                           0, stream>>>(part, stats, N, Co, tiles, H * W,
                                        eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that conv3x3_in_fwd needs for its partial sums: a
// (sum, sum of squares) for each image, 8 x 16 pixel tile and channel.
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
  if (dtype == 0)
    return launch<float>(x, w, bias, y, partials, stats, N, Ci, Co, H, W, eps,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, y, partials, stats, N, Ci, Co, H,
                                 W, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
