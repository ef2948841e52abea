// The main loop of the 3x3 stride-1 pad-1 convolution, NCHW, shared by
// conv3x3.cu (the convolution) and conv3x3_in.cu (the convolution with the
// InstanceNorm statistics of its output).  Each source adds its own epilogue.
//
//   * a block owns a TH x TW tile of output pixels for COB output channels;
//     one thread per output pixel keeps COB f32 accumulators in registers;
//   * the input tile plus its 1-px halo is staged in shared memory CIB input
//     channels at a time, with those channels' weights laid out [ci][tap][co]
//     so every thread reads the same float4 of weights (a broadcast) and
//     reuses each staged input value for COB FMAs;
//   * f32 and bf16 inputs, f32 staging and accumulation.  Any Ci, Co, H, W:
//     ragged edges and channel tails are zero-filled when staged.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace conv3x3_tile {

constexpr int TH = 16;   // output tile height
constexpr int TW = 16;   // output tile width (one thread per pixel)
constexpr int CIB = 8;   // input channels staged per step
constexpr int THREADS = TH * TW;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int COB>
struct Smem {
  float xs[CIB][TH + 2][TW + 2];
  alignas(16) float ws[CIB][9][COB];
};

// acc[j] = sum over ci, ky, kx of x[ci, oy0+ty+ky-1, ox0+tx+kx-1] *
// w[co0+j, ci, ky, kx] for this thread's pixel (ty, tx) = (tid / TW, tid % TW)
// of the tile at (oy0, ox0); xn is one image (Ci, H, W).  Every thread of the
// block must call it (it synchronizes the block).
template <typename T, int COB>
__device__ __forceinline__ void accumulate(const T* __restrict__ xn,
                                           const T* __restrict__ w, int Ci,
                                           int Co, int H, int W, int oy0,
                                           int ox0, int co0, Smem<COB>& sm,
                                           float (&acc)[COB]) {
  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const size_t plane = (size_t)H * W;

#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CIB) {
    // input tile with halo; zero outside the image and past Ci
    for (int i = tid; i < CIB * (TH + 2) * (TW + 2); i += THREADS) {
      const int c = i / ((TH + 2) * (TW + 2));
      const int r = i % ((TH + 2) * (TW + 2));
      const int yy = r / (TW + 2);
      const int xx = r % (TW + 2);
      const int gy = oy0 + yy - 1;
      const int gx = ox0 + xx - 1;
      float v = 0.f;
      if (c0 + c < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xn[(size_t)(c0 + c) * plane + (size_t)gy * W + gx]);
      sm.xs[c][yy][xx] = v;
    }
    // weights (Co, Ci, 3, 3) -> ws[ci][tap][co]; consecutive i read
    // consecutive (ci, tap) of one output channel
    for (int i = tid; i < CIB * 9 * COB; i += THREADS) {
      const int j = i / (CIB * 9);
      const int r = i % (CIB * 9);
      const int c = r / 9;
      const int t = r % 9;
      float v = 0.f;
      if (co0 + j < Co && c0 + c < Ci)
        v = to_f(w[((size_t)(co0 + j) * Ci + (c0 + c)) * 9 + t]);
      sm.ws[c][t][j] = v;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CIB; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = sm.xs[c][ty + ky][tx + kx];
          const float4* wp = reinterpret_cast<const float4*>(&sm.ws[c][ky * 3 + kx][0]);
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
}

}  // namespace conv3x3_tile
