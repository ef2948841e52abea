// 4x4 stride-2 pad-1 convolution plus optional bias, NCHW, for Hopper
// (sm_90a).  Weight in torch's (Co, Ci, 4, 4) layout; output
// (N, Co, Ho, Wo) with Ho = (H - 2) / 2 + 1.
//
// Replaces: supervised_gan_tpu/ops/pallas/conv4s2.py `_kernel` (:81), reached
// through `conv4s2_same` (:183).  The Pallas kernel packs two input pixels
// into the lane dimension so that the stride-2 taps become three banded
// tuple-shift dots, and its gate refuses Ci or Co that do not fill 64 lanes
// (the 1-, 2- and 3-channel stems); that packing is a TPU layout concern and
// is not carried over.  This kernel takes any Ci, Co, H and W.
//
// It serves every stride-2 conv of the PatchGAN trunks and of the unet
// down path, and it is the dx of every ConvTranspose2d k4 s2 p1 (the
// adjoint of a transposed conv is the conv with the same weight tensor).
//
// What bounds it on the H100: arithmetic at the wide sites (2*16*Ci FLOPs
// per output element, e.g. 4096 at Ci = 128), bytes only at the 1- to
// 3-channel stems, where each output pixel reads a 4x4 window of a thin
// input.
//
// Design (the conv3x3 kernel's, with a stride-2 input tile): a block owns a
// TH x TW tile of output pixels for COB output channels, one thread per
// output pixel with COB f32 accumulators in registers.  The (2TH+2) x
// (2TW+2) input window of CIB input channels and those channels' weights,
// laid out [ci][tap][co] so that every weight read is a float4 broadcast,
// are staged in shared memory per step.  f32 and bf16 inputs, f32
// accumulation, bias in the epilogue, output in the input's type; ragged
// edges and channel tails are zero-filled when staged and masked on store.
//
// The deep sites have few output pixels and many input channels (256->512
// at 16^2 outputs is 16 blocks), so their serial Ci loop would run on a
// handful of SMs.  When tiles x channel blocks fall short of two waves, Ci
// is split over `splits` blocks that write f32 partials, and a second pass
// sums them in a fixed order and adds the bias.  No atomics: the result is
// the same from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TH = 16;   // output tile height
constexpr int TW = 16;   // output tile width (one thread per pixel)
constexpr int CIB = 4;   // input channels staged per step
constexpr int XH = 2 * TH + 2;
constexpr int XW = 2 * TW + 2;
constexpr int TARGET_BLOCKS = 2 * 132;   // two waves on the H100's SMs

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int COB>
__global__ void __launch_bounds__(TH * TW)
conv4s2_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               float* __restrict__ part, int N, int Ci, int Co, int H, int W,
               int Ho, int Wo, int tiles_w, int ci_chunk) {
  __shared__ float xs[CIB][XH][XW];
  __shared__ __align__(16) float ws[CIB][16][COB];

  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * COB;
  const int n = blockIdx.z % N;
  const int split = blockIdx.z / N;
  const int c_beg = split * ci_chunk;
  const int c_end = min(Ci, c_beg + ci_chunk);
  const size_t plane = (size_t)H * W;
  const T* xn = x + (size_t)n * Ci * plane;
  // input row of tile row 0: output row oy reads rows 2*oy - 1 .. 2*oy + 2
  const int iy0 = 2 * oy0 - 1;
  const int ix0 = 2 * ox0 - 1;

  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;

  for (int c0 = c_beg; c0 < c_end; c0 += CIB) {
    for (int i = tid; i < CIB * XH * XW; i += TH * TW) {
      const int c = i / (XH * XW);
      const int r = i % (XH * XW);
      const int yy = r / XW;
      const int xx = r % XW;
      const int gy = iy0 + yy;
      const int gx = ix0 + xx;
      float v = 0.f;
      if (c0 + c < c_end && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xn[(size_t)(c0 + c) * plane + (size_t)gy * W + gx]);
      xs[c][yy][xx] = v;
    }
    // weights (Co, Ci, 4, 4) -> ws[ci][tap][co]; consecutive i read
    // consecutive (ci, tap) of one output channel
    for (int i = tid; i < CIB * 16 * COB; i += TH * TW) {
      const int j = i / (CIB * 16);
      const int r = i % (CIB * 16);
      const int c = r / 16;
      const int t = r % 16;
      float v = 0.f;
      if (co0 + j < Co && c0 + c < c_end)
        v = to_f(w[((size_t)(co0 + j) * Ci + (c0 + c)) * 16 + t]);
      ws[c][t][j] = v;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CIB; ++c) {
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
          const float v = xs[c][2 * ty + ky][2 * tx + kx];
          const float4* wp = reinterpret_cast<const float4*>(&ws[c][ky * 4 + kx][0]);
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
  if (oy < Ho && ox < Wo) {
    const size_t oplane = (size_t)Ho * Wo;
    const size_t pix = (size_t)oy * Wo + ox;
#pragma unroll
    for (int j = 0; j < COB; ++j) {
      const int co = co0 + j;
      if (co < Co) {
        const size_t i = ((size_t)n * Co + co) * oplane + pix;
        if (part != nullptr) {
          part[(size_t)split * N * Co * oplane + i] = acc[j];
        } else {
          store(y + i, acc[j] + (bias != nullptr ? bias[co] : 0.f));
        }
      }
    }
  }
}

// y[i] = sum of the splits' partials in split order, plus the bias
template <typename T>
__global__ void conv4s2_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ bias,
                                      T* __restrict__ y, int count, int Co,
                                      int oplane, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
  if (bias != nullptr) s += bias[(i / oplane) % Co];
  store(y + i, s);
}

struct Plan {
  int cob, Ho, Wo, tiles_w, tiles, splits, ci_chunk;
};

Plan plan(int N, int Ci, int Co, int H, int W) {
  Plan p;
  p.cob = Co > 4 ? 32 : 4;
  p.Ho = (H - 2) / 2 + 1;
  p.Wo = (W - 2) / 2 + 1;
  p.tiles_w = (p.Wo + TW - 1) / TW;
  p.tiles = p.tiles_w * ((p.Ho + TH - 1) / TH);
  const int steps = (Ci + CIB - 1) / CIB;   // staged chunks of the Ci loop
  const int base = p.tiles * ((Co + p.cob - 1) / p.cob) * N;
  int splits = base >= TARGET_BLOCKS ? 1 : (TARGET_BLOCKS + base - 1) / base;
  if (splits > steps) splits = steps;
  const int per = (steps + splits - 1) / splits;   // chunks per split
  p.ci_chunk = per * CIB;
  p.splits = (steps + per - 1) / per;
  return p;
}

template <typename T, int COB>
void launch(const Plan& p, const void* x, const void* w, const float* bias,
            void* y, float* part, int N, int Ci, int Co, int H, int W,
            cudaStream_t stream) {
  const dim3 grid(p.tiles, (Co + COB - 1) / COB, N * p.splits);
  conv4s2_kernel<T, COB><<<grid, TH * TW, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), p.splits > 1 ? part : nullptr, N, Ci, Co, H, W,
      p.Ho, p.Wo, p.tiles_w, p.ci_chunk);
  if (p.splits > 1) {
    const int oplane = p.Ho * p.Wo;
    const int count = N * Co * oplane;
    conv4s2_reduce_kernel<T><<<(count + 255) / 256, 256, 0, stream>>>(
        part, bias, static_cast<T*>(y), count, Co, oplane, p.splits);
  }
}

}  // namespace

// Floats of scratch that conv4s2_fwd needs for these shapes (0: none).
extern "C" long long conv4s2_workspace(int N, int Ci, int Co, int H, int W) {
  const Plan p = plan(N, Ci, Co, H, W);
  return p.splits > 1 ? (long long)p.splits * N * Co * p.Ho * p.Wo : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it); bias is float32 or
// null; partials: conv4s2_workspace floats (null when that is 0).  H, W >= 2.
// Returns cudaGetLastError() after the launches.
extern "C" int conv4s2_fwd(const void* x, const void* w, const float* bias,
                           void* y, float* partials, int N, int Ci, int Co,
                           int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(N, Ci, Co, H, W);
  const bool wide = p.cob == 32;
  if (dtype == 0) {
    if (wide) launch<float, 32>(p, x, w, bias, y, partials, N, Ci, Co, H, W, s);
    else launch<float, 4>(p, x, w, bias, y, partials, N, Ci, Co, H, W, s);
  } else if (dtype == 1) {
    if (wide)
      launch<__nv_bfloat16, 32>(p, x, w, bias, y, partials, N, Ci, Co, H, W, s);
    else
      launch<__nv_bfloat16, 4>(p, x, w, bias, y, partials, N, Ci, Co, H, W, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
