// ConvTranspose2d k4 s2 p1 output-padding 0 plus optional bias, NCHW, for
// Hopper (sm_90a).  Weight in torch's (Ci, Co, 4, 4) layout.
//
// Replaces: supervised_gan_tpu/ops/pallas/convt4s2.py `_kernel` (:157),
// reached through `convt4s2` (:269).  The Pallas kernel packs T pixels into
// the 128 TPU lanes and folds the stride-2 column interleave into banded
// weights; that packing is a TPU layout concern and is not carried over.
//
// The phase decomposition (convt4s2.py:21-28): output pixel (2m+q, 2n+r) is
// a 2x2 gather over x, 4 of the 16 taps.  Along one axis,
//   q = 0: tap 1 reads x row m,   tap 3 reads x row m-1;
//   q = 1: tap 0 reads x row m+1, tap 2 reads x row m.
// It is computed directly; no conv runs over a zero-dilated input.
//
// What bounds it on the H100: arithmetic at the wide G1 sites (2*4*Ci FLOPs
// per output element against ~4 bytes of output, e.g. 2048 FLOP/element at
// Ci = 256), bytes only at the narrow 32 -> 2 head.
//
// Design: a block owns a TMH x TMW tile of INPUT positions (m, n) for COB
// output channels; each position owns the four output pixels (2m+q, 2n+r).
// The tile plus a 1-px halo and the weights of CIB input channels, laid out
// [ci][ky*4+kx][co], are staged in shared memory; each staged input value
// feeds 4 taps and each weight float4 is a broadcast.  The G1 sites are
// small (8^2 to 128^2 inputs, 16 to 256 tiles), so to fill the SMs the
// block's KS thread groups split the input channels of every staged chunk
// and the groups' 4*COB f32 accumulators are summed through shared memory
// in the epilogue.  f32 and bf16 inputs, f32 accumulation, bias in the
// epilogue, any N, Ci, Co, H, W.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TMH = 8;           // input rows per block
constexpr int TMW = 8;           // input cols per block
constexpr int POS = TMH * TMW;   // positions per block
constexpr int KS = 4;            // thread groups splitting the input channels
constexpr int CIB = 8;           // input channels staged per step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// output phase q (0/1), tap a (0/1) -> kernel index along that axis
__device__ __forceinline__ int ktap(int q, int a) {
  return q == 0 ? (a == 0 ? 1 : 3) : (a == 0 ? 0 : 2);
}
// ... and the staged-tile offset (halo row/col 0 is x index m-1)
__device__ __forceinline__ int koff(int q, int a) {
  return q == 0 ? (a == 0 ? 1 : 0) : (a == 0 ? 2 : 1);
}

template <typename T, int COB>
__global__ void __launch_bounds__(POS * KS)
convt4s2_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ y,
                int Ci, int Co, int H, int W, int tiles_w) {
  __shared__ float xs[CIB][TMH + 2][TMW + 2];
  __shared__ __align__(16) float ws[CIB][16][COB];
  __shared__ float red[KS][4 * COB][POS];

  const int tid = threadIdx.x;
  const int pos = tid % POS;
  const int g = tid / POS;
  const int tx = pos % TMW;
  const int ty = pos / TMW;
  const int m0 = (blockIdx.x / tiles_w) * TMH;
  const int n0 = (blockIdx.x % tiles_w) * TMW;
  const int co0 = blockIdx.y * COB;
  const int nb = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* xn = x + (size_t)nb * Ci * plane;

  float acc[2][2][COB];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < COB; ++j) acc[q][r][j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CIB) {
    for (int i = tid; i < CIB * (TMH + 2) * (TMW + 2); i += POS * KS) {
      const int c = i / ((TMH + 2) * (TMW + 2));
      const int rr = i % ((TMH + 2) * (TMW + 2));
      const int yy = rr / (TMW + 2);
      const int xx = rr % (TMW + 2);
      const int gy = m0 + yy - 1;
      const int gx = n0 + xx - 1;
      float v = 0.f;
      if (c0 + c < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xn[(size_t)(c0 + c) * plane + (size_t)gy * W + gx]);
      xs[c][yy][xx] = v;
    }
    // weights (Ci, Co, 4, 4) -> ws[ci][k][co]; consecutive i read
    // consecutive (co, k) of one input channel
    for (int i = tid; i < CIB * 16 * COB; i += POS * KS) {
      const int c = i / (16 * COB);
      const int rr = i % (16 * COB);
      const int j = rr / 16;
      const int k = rr % 16;
      float v = 0.f;
      if (c0 + c < Ci && co0 + j < Co)
        v = to_f(w[((size_t)(c0 + c) * Co + (co0 + j)) * 16 + k]);
      ws[c][k][j] = v;
    }
    __syncthreads();

#pragma unroll
    for (int cc = 0; cc < CIB / KS; ++cc) {
      const int c = g + cc * KS;   // this group's channels of the chunk
      float v[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[dy][dx] = xs[c][ty + dy][tx + dx];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const float xv = v[koff(q, a)][koff(r, b)];
              const float4* wp = reinterpret_cast<const float4*>(
                  &ws[c][ktap(q, a) * 4 + ktap(r, b)][0]);
#pragma unroll
              for (int j4 = 0; j4 < COB / 4; ++j4) {
                const float4 wv = wp[j4];
                acc[q][r][4 * j4 + 0] = fmaf(xv, wv.x, acc[q][r][4 * j4 + 0]);
                acc[q][r][4 * j4 + 1] = fmaf(xv, wv.y, acc[q][r][4 * j4 + 1]);
                acc[q][r][4 * j4 + 2] = fmaf(xv, wv.z, acc[q][r][4 * j4 + 2]);
                acc[q][r][4 * j4 + 3] = fmaf(xv, wv.w, acc[q][r][4 * j4 + 3]);
              }
            }
    }
    __syncthreads();
  }

  // sum the KS groups' partial sums; every thread then stores a share of
  // the 4*COB outputs of its position
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < COB; ++j) red[g][(q * 2 + r) * COB + j][pos] = acc[q][r][j];
  __syncthreads();

  const int m = m0 + ty;
  const int n = n0 + tx;
  if (m < H && n < W) {
    const int Wo = 2 * W;
    const size_t oplane = (size_t)(2 * H) * Wo;
    T* yn = y + (size_t)nb * Co * oplane;
    for (int k = g; k < 4 * COB; k += KS) {
      const int j = k % COB;
      const int q = k / (2 * COB);
      const int r = (k / COB) % 2;
      if (co0 + j < Co) {
        float s = bias != nullptr ? bias[co0 + j] : 0.f;
#pragma unroll
        for (int gg = 0; gg < KS; ++gg) s += red[gg][k][pos];
        store(yn + (size_t)(co0 + j) * oplane + (size_t)(2 * m + q) * Wo
                  + (2 * n + r), s);
      }
    }
  }
}

template <typename T, int COB>
void launch(const void* x, const void* w, const float* bias, void* y,
            int N, int Ci, int Co, int H, int W, cudaStream_t stream) {
  const int tiles_w = (W + TMW - 1) / TMW;
  const int tiles_h = (H + TMH - 1) / TMH;
  const dim3 grid(tiles_w * tiles_h, (Co + COB - 1) / COB, N);
  convt4s2_kernel<T, COB><<<grid, POS * KS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), Ci, Co, H, W, tiles_w);
}

}  // namespace

// x (N, Ci, H, W) -> y (N, Co, 2H, 2W).  dtype: 0 = float32, 1 = bfloat16
// (x, w and y share it); bias is float32 or null.  Returns
// cudaGetLastError() after the launch.
extern "C" int convt4s2_fwd(const void* x, const void* w, const float* bias,
                            void* y, int N, int Ci, int Co, int H, int W,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = Co > 4;   // the label head (Co = 2) takes a 4-channel block
  if (dtype == 0) {
    if (wide) launch<float, 8>(x, w, bias, y, N, Ci, Co, H, W, s);
    else launch<float, 4>(x, w, bias, y, N, Ci, Co, H, W, s);
  } else if (dtype == 1) {
    if (wide) launch<__nv_bfloat16, 8>(x, w, bias, y, N, Ci, Co, H, W, s);
    else launch<__nv_bfloat16, 4>(x, w, bias, y, N, Ci, Co, H, W, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
