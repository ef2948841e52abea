// Weight gradient of the 3x3 stride-1 pad-1 convolution, NCHW, for Hopper
// (sm_90a):
//
//   dW[co, ci, ky, kx] = sum over n, y, x of g[n, co, y, x] * x[n, ci, y+ky-1, x+kx-1]
//
// in float32, for any N, Ci, Co, H, W; x and g float32 or bfloat16.
//
// Replaces: supervised_gan_tpu/ops/pallas/conv3x3.py `_dw_kernel` (:226,
// through `_conv3x3_dw` :305) and `_dwT_kernel` (:339, through
// `_conv3x3_dw_v2` :420).  Both compute this one function on banded
// 128-lane operands and carry the pixel sum in the output block from one
// grid step to the next; that relies on the TPU's sequential grid.
//
// What bounds it on the H100: arithmetic.  It does the forward's FLOPs,
// 2*9*Ci*Co per pixel (19.3 GFLOP at the 512^2 64->64 site, 0.29 ms at the
// f32 CUDA-core rate), against one read of x and g.
//
// Design (simple and right first; wgmma is later work):
//   * pass 1: a block owns COB output channels x CIB input channels x 9
//     taps and a contiguous range of 4x32-pixel tiles (the pixel sum is
//     split over `splits` blocks so that the small-channel sites still fill
//     the SMs).  Per tile it stages g (pixel-major, so a warp's 32 output
//     channels read consecutive words) and x with a 1-pixel halo in shared
//     memory; each thread keeps COPT x 9 f32 sums for one input channel and
//     slides a 3x3 register window along each tile row (3 new x reads and
//     COPT g reads per 9*COPT FMAs; x reads are warp broadcasts);
//   * pass 2: every (co, ci, tap) sums its `splits` partials in a fixed
//     order.  No atomics: the result is the same from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int TR = 4;              // pixel rows per staged tile
constexpr int TC = 32;             // pixel columns per staged tile
constexpr int PIX = TR * TC;
constexpr int TARGET_BLOCKS = 4 * 132;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int COT, int COPT>
__global__ void __launch_bounds__(THREADS)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ part, int Ci, int Co, int H, int W,
                  int tiles_w, int tiles_img, int tiles_total, int splits) {
  constexpr int COB = COT * COPT;       // output channels per block
  constexpr int CIB = THREADS / COT;    // input channels per block
  __shared__ float xs[CIB][TR + 2][TC + 2];
  __shared__ float gs[PIX][COB + 1];    // +1: conflict-free transposed stores

  const int tid = threadIdx.x;
  const int col = tid % COT;
  const int cil = tid / COT;
  const int co0 = blockIdx.x * COB;
  const int ci0 = blockIdx.y * CIB;
  const int s = blockIdx.z;
  const int t_beg = (int)((long long)tiles_total * s / splits);
  const int t_end = (int)((long long)tiles_total * (s + 1) / splits);
  const size_t plane = (size_t)H * W;

  float acc[COPT][9];
#pragma unroll
  for (int j = 0; j < COPT; ++j)
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[j][k] = 0.f;

  for (int t = t_beg; t < t_end; ++t) {
    const int n = t / tiles_img;
    const int r = t % tiles_img;
    const int y0 = (r / tiles_w) * TR;
    const int x0 = (r % tiles_w) * TC;
    const T* xn = x + (size_t)n * Ci * plane;
    const T* gn = g + (size_t)n * Co * plane;
    for (int i = tid; i < CIB * (TR + 2) * (TC + 2); i += THREADS) {
      const int c = i / ((TR + 2) * (TC + 2));
      const int rr = i % ((TR + 2) * (TC + 2));
      const int yy = rr / (TC + 2);
      const int xx = rr % (TC + 2);
      const int gy = y0 + yy - 1;
      const int gx = x0 + xx - 1;
      float v = 0.f;
      if (ci0 + c < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xn[(size_t)(ci0 + c) * plane + (size_t)gy * W + gx]);
      xs[c][yy][xx] = v;
    }
    for (int i = tid; i < COB * PIX; i += THREADS) {
      const int j = i / PIX;
      const int p = i % PIX;
      const int gy = y0 + p / TC;
      const int gx = x0 + p % TC;
      float v = 0.f;
      if (co0 + j < Co && gy < H && gx < W)
        v = to_f(gn[(size_t)(co0 + j) * plane + (size_t)gy * W + gx]);
      gs[p][j] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ry = 0; ry < TR; ++ry) {
      float v[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        v[ky][0] = xs[cil][ry + ky][0];
        v[ky][1] = xs[cil][ry + ky][1];
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) v[ky][2] = xs[cil][ry + ky][c + 2];
#pragma unroll
        for (int j = 0; j < COPT; ++j) {
          const float gv = gs[ry * TC + c][col + j * COT];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[j][ky * 3 + kx] = fmaf(gv, v[ky][kx], acc[j][ky * 3 + kx]);
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          v[ky][0] = v[ky][1];
          v[ky][1] = v[ky][2];
        }
      }
    }
    __syncthreads();
  }

  const int ci = ci0 + cil;
  if (ci < Ci) {
#pragma unroll
    for (int j = 0; j < COPT; ++j) {
      const int co = co0 + col + j * COT;
      if (co < Co) {
        float* dst = part + (((size_t)s * Co + co) * Ci + ci) * 9;
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k] = acc[j][k];
      }
    }
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int count,
                                 int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
  dw[i] = s;
}

struct Plan {
  int cot, copt, tiles_w, tiles_img, tiles_total, splits;
  dim3 grid;
};

Plan plan(int N, int Ci, int Co, int H, int W) {
  Plan p;
  const bool wide = Co > 8;   // the 1-channel head takes an 8-channel block
  p.cot = wide ? 32 : 8;
  p.copt = wide ? 2 : 1;
  const int cob = p.cot * p.copt;
  const int cib = THREADS / p.cot;
  p.tiles_w = (W + TC - 1) / TC;
  p.tiles_img = p.tiles_w * ((H + TR - 1) / TR);
  p.tiles_total = N * p.tiles_img;
  const int base = ((Co + cob - 1) / cob) * ((Ci + cib - 1) / cib);
  int splits = (TARGET_BLOCKS + base - 1) / base;
  if (splits > p.tiles_total) splits = p.tiles_total;
  if (splits < 1) splits = 1;
  p.splits = splits;
  p.grid = dim3((Co + cob - 1) / cob, (Ci + cib - 1) / cib, splits);
  return p;
}

template <typename T>
void launch(const Plan& p, const void* x, const void* g, float* part,
            float* dw, int Ci, int Co, int H, int W, cudaStream_t stream) {
  if (p.cot == 32)
    dw_partial_kernel<T, 32, 2><<<p.grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), part, Ci, Co, H,
        W, p.tiles_w, p.tiles_img, p.tiles_total, p.splits);
  else
    dw_partial_kernel<T, 8, 1><<<p.grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), part, Ci, Co, H,
        W, p.tiles_w, p.tiles_img, p.tiles_total, p.splits);
  const int count = Co * Ci * 9;
  dw_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(part, dw, count,
                                                           p.splits);
}

}  // namespace

// Floats of scratch that conv3x3_dw needs for these shapes.
extern "C" long long conv3x3_dw_workspace(int N, int Ci, int Co, int H, int W) {
  const Plan p = plan(N, Ci, Co, H, W);
  return (long long)p.splits * Co * Ci * 9;
}

// x (N, Ci, H, W), g (N, Co, H, W), both of `dtype` (0 = float32,
// 1 = bfloat16); dw (Co, Ci, 3, 3) float32; partials: conv3x3_dw_workspace
// floats.  Returns cudaGetLastError() after both launches.
extern "C" int conv3x3_dw(const void* x, const void* g, float* partials,
                          float* dw, int N, int Ci, int Co, int H, int W,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(N, Ci, Co, H, W);
  if (dtype == 0) {
    launch<float>(p, x, g, partials, dw, Ci, Co, H, W, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(p, x, g, partials, dw, Ci, Co, H, W, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
