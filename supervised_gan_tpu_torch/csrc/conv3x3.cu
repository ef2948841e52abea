// 3x3 stride-1 pad-1 convolution plus optional bias, NCHW, for Hopper (sm_90a).
//
// Replaces: supervised_gan_tpu/ops/pallas/conv3x3.py `_kernel` (:143), reached
// through `conv3x3_same` (:497).  The Pallas kernel packs P = 128/C pixels into
// the 128 TPU lanes and multiplies banded block weights on the MXU; that
// packing exists to fill 128-lane vregs and is not carried over.
//
// What bounds it on the H100: arithmetic.  The G2 CRN sites do 2*9*Ci*Co
// FLOPs per output pixel against 4*(Ci+Co) bytes of activation traffic, so at
// Ci = Co = 64 (the 512^2 trunk) the work is ~9x past the f32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).
//
// Design (simple and right first; wgmma/TMA are later work): the tiled main
// loop of conv3x3_tile.cuh (a block owns a 16x16 output tile for COB output
// channels, staged 8 input channels at a time, f32 accumulation), then the
// bias in the epilogue and the output in the input's type, masked on store.

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3_tile;

template <typename T, int COB>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               int Ci, int Co, int H, int W, int tiles_w) {
  __shared__ Smem<COB> sm;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * COB;
  const int n = blockIdx.z;
  const size_t plane = (size_t)H * W;

  float acc[COB];
  accumulate<T, COB>(x + (size_t)n * Ci * plane, w, Ci, Co, H, W, oy0, ox0,
                     co0, sm, acc);

  const int oy = oy0 + threadIdx.x / TW;
  const int ox = ox0 + threadIdx.x % TW;
  if (oy < H && ox < W) {
    T* yn = y + (size_t)n * Co * plane + (size_t)oy * W + ox;
#pragma unroll
    for (int j = 0; j < COB; ++j) {
      if (co0 + j < Co) {
        const float b = bias != nullptr ? bias[co0 + j] : 0.f;
        store(yn + (size_t)(co0 + j) * plane, acc[j] + b);
      }
    }
  }
}

template <typename T, int COB>
void launch(const void* x, const void* w, const float* bias, void* y,
            int N, int Ci, int Co, int H, int W, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (Co + COB - 1) / COB, N);
  conv3x3_kernel<T, COB><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), Ci, Co, H, W, tiles_w);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it); bias is float32 or
// null.  Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_fwd(const void* x, const void* w, const float* bias,
                           void* y, int N, int Ci, int Co, int H, int W,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = Co > 4;   // narrow heads (Co <= 4) take a 4-channel block
  if (dtype == 0) {
    if (wide) launch<float, 32>(x, w, bias, y, N, Ci, Co, H, W, s);
    else launch<float, 4>(x, w, bias, y, N, Ci, Co, H, W, s);
  } else if (dtype == 1) {
    if (wide) launch<__nv_bfloat16, 32>(x, w, bias, y, N, Ci, Co, H, W, s);
    else launch<__nv_bfloat16, 4>(x, w, bias, y, N, Ci, Co, H, W, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
