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
// Design (simple and right first; wgmma/TMA are later work):
//   * a block owns a TH x TW tile of output pixels for COB output channels;
//     one thread per output pixel keeps COB f32 accumulators in registers;
//   * the input tile plus its 1-px halo is staged in shared memory CIB input
//     channels at a time, with those channels' weights laid out [ci][tap][co]
//     so every thread reads the same float4 of weights (a broadcast) and
//     reuses each staged input value for COB FMAs;
//   * f32 and bf16 inputs, f32 staging and accumulation, bias in the
//     epilogue, output in the input's type.  Any N, Ci, Co, H, W: ragged
//     edges and channel tails are zero-filled when staged and masked on store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TH = 16;   // output tile height
constexpr int TW = 16;   // output tile width (one thread per pixel)
constexpr int CIB = 8;   // input channels staged per step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int COB>
__global__ void __launch_bounds__(TH * TW)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               int Ci, int Co, int H, int W, int tiles_w) {
  __shared__ float xs[CIB][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[CIB][9][COB];

  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * COB;
  const int n = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* xn = x + (size_t)n * Ci * plane;

  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CIB) {
    // input tile with halo; zero outside the image and past Ci
    for (int i = tid; i < CIB * (TH + 2) * (TW + 2); i += TH * TW) {
      const int c = i / ((TH + 2) * (TW + 2));
      const int r = i % ((TH + 2) * (TW + 2));
      const int yy = r / (TW + 2);
      const int xx = r % (TW + 2);
      const int gy = oy0 + yy - 1;
      const int gx = ox0 + xx - 1;
      float v = 0.f;
      if (c0 + c < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xn[(size_t)(c0 + c) * plane + (size_t)gy * W + gx]);
      xs[c][yy][xx] = v;
    }
    // weights (Co, Ci, 3, 3) -> ws[ci][tap][co]; consecutive i read
    // consecutive (ci, tap) of one output channel
    for (int i = tid; i < CIB * 9 * COB; i += TH * TW) {
      const int j = i / (CIB * 9);
      const int r = i % (CIB * 9);
      const int c = r / 9;
      const int t = r % 9;
      float v = 0.f;
      if (co0 + j < Co && c0 + c < Ci)
        v = to_f(w[((size_t)(co0 + j) * Ci + (c0 + c)) * 9 + t]);
      ws[c][t][j] = v;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CIB; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = xs[c][ty + ky][tx + kx];
          const float4* wp = reinterpret_cast<const float4*>(&ws[c][ky * 3 + kx][0]);
#pragma unroll
          for (int j4 = 0; j4 < COB / 4; ++j4) {
            const float4 wv = wp[j4];
            acc[4 * j4 + 0] = fmaf(v, wv.x, acc[4 * j4 + 0]);
            acc[4 * j4 + 1] = fmaf(v, wv.y, acc[4 * j4 + 1]);
            acc[4 * j4 + 2] = fmaf(v, wv.z, acc[4 * j4 + 2]);
            acc[4 * j4 + 3] = fmaf(v, wv.w, acc[4 * j4 + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  const int ox = ox0 + tx;
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
  conv3x3_kernel<T, COB><<<grid, TH * TW, 0, stream>>>(
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
