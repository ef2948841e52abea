// InstanceNorm(affine=False) fused with LeakyReLU(slope) / ReLU (slope 0) /
// identity, NCHW, for Hopper (sm_90a).
//
// Replaces: supervised_gan_tpu/ops/pallas/instance_norm.py, the forward of
// `fused_instance_norm_act` (:148): the whole-plane `_kernel` (:109) and the
// streaming `_fwd_stats_kernel` (:297) / `_fwd_apply_kernel` (:312).  They
// compute one function, so here they are one statistics pass and one apply
// pass, launched back to back by `instance_norm_act`.  The apply pass also
// writes each plane's mean and 1/std, which the backward reuses (the JAX
// `_fwd` residuals, instance_norm.py:154-181).
//
// Also the backward, replacing `_bwd_stats_kernel` (:319) and
// `_bwd_apply_kernel` (:337) of `_stream_bwd` (:416): with
// x^ = (x - mean) * rstd and g' = g * act'(x^), a statistics pass writes
// per-chunk f32 sums of g' and g' * x^, and an apply pass combines its
// plane's partials and writes dx = rstd * (g' - mean(g') - x^ * mean(g' x^)).
// x^ is recomputed from x and the saved statistics.  It is bound by bytes
// too: it reads x and g twice and writes dx once.
//
// What bounds it on the H100: bytes.  It does ~7 operations per element
// against 2 reads and 1 write of the element; at 512^2 x 64 channels the
// planes are 64 MB in f32, past the 50 MB L2.
//
// Design: a (n, c) plane at 512^2 is 1 MB in f32 (too big for one block's
// shared memory), and N*C = 64 planes would leave most of the 132 SMs idle,
// so each plane is split into `splits` chunks.  Pass 1: each (plane, chunk)
// block sums x and x^2 in f32 (coalesced strided loads, warp-shuffle then
// shared-memory reduction) and writes one float2 partial.  Pass 2: each
// (plane, chunk) block combines its plane's partials (var = max(E[x^2] -
// mean^2, 0), as the JAX forward computes it), then normalizes and activates
// its chunk, writing x's type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
in_stats_kernel(const T* __restrict__ x, float2* __restrict__ partials,
                int HW, int chunk, int splits) {
  __shared__ float red[2][THREADS / 32];
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  const T* xp = x + (size_t)p * HW;
  const int beg = s * chunk;
  const int end = min(beg + chunk, HW);
  float s1 = 0.f, s2 = 0.f;
  for (int i = beg + threadIdx.x; i < end; i += THREADS) {
    const float v = to_f(xp[i]);
    s1 += v;
    s2 = fmaf(v, v, s2);
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
    s1 = lane < THREADS / 32 ? red[0][lane] : 0.f;
    s2 = lane < THREADS / 32 ? red[1][lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) partials[(size_t)p * splits + s] = make_float2(s1, s2);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
in_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float2* __restrict__ partials, int HW, int chunk,
                int splits, float eps, int has_act, float slope,
                float* __restrict__ stats, int NC) {
  __shared__ float stat[2];
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < splits; i += 32) {
      const float2 v = partials[(size_t)p * splits + i];
      s1 += v.x;
      s2 += v.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      const float mean = s1 / HW;
      const float var = fmaxf(s2 / HW - mean * mean, 0.f);
      stat[0] = mean;
      stat[1] = 1.f / sqrtf(var + eps);
      if (stats != nullptr && s == 0) {
        stats[p] = stat[0];
        stats[NC + p] = stat[1];
      }
    }
  }
  __syncthreads();
  const float mean = stat[0];
  const float rstd = stat[1];
  const size_t base = (size_t)p * HW;
  const int beg = s * chunk;
  const int end = min(beg + chunk, HW);
  for (int i = beg + threadIdx.x; i < end; i += THREADS) {
    float z = (to_f(x[base + i]) - mean) * rstd;
    if (has_act && z < 0.f) z *= slope;
    store(y + base + i, z);
  }
}

// normalize + activate one chunk of a plane with given statistics
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               int HW, int chunk, int has_act, float slope) {
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  const float m = mean[p];
  const float r = rstd[p];
  const size_t base = (size_t)p * HW;
  const int beg = s * chunk;
  const int end = min(beg + chunk, HW);
  for (int i = beg + threadIdx.x; i < end; i += THREADS) {
    float z = (to_f(x[base + i]) - m) * r;
    if (has_act && z < 0.f) z *= slope;
    store(y + base + i, z);
  }
}

// sum of g' and g' * x^ over one chunk of a plane
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    float2* __restrict__ partials, int HW, int chunk,
                    int splits, int has_act, float slope) {
  __shared__ float red[2][THREADS / 32];
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  const float m = mean[p];
  const float r = rstd[p];
  const size_t base = (size_t)p * HW;
  const int beg = s * chunk;
  const int end = min(beg + chunk, HW);
  float s1 = 0.f, s2 = 0.f;
  for (int i = beg + threadIdx.x; i < end; i += THREADS) {
    const float xh = (to_f(x[base + i]) - m) * r;
    float gp = to_f(g[base + i]);
    if (has_act && xh < 0.f) gp *= slope;
    s1 += gp;
    s2 = fmaf(gp, xh, s2);
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
    s1 = lane < THREADS / 32 ? red[0][lane] : 0.f;
    s2 = lane < THREADS / 32 ? red[1][lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) partials[(size_t)p * splits + s] = make_float2(s1, s2);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float2* __restrict__ partials, T* __restrict__ dx,
                    int HW, int chunk, int splits, int has_act, float slope) {
  __shared__ float stat[2];
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < splits; i += 32) {
      const float2 v = partials[(size_t)p * splits + i];
      s1 += v.x;
      s2 += v.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      stat[0] = s1 / HW;
      stat[1] = s2 / HW;
    }
  }
  __syncthreads();
  const float gm = stat[0];
  const float gz = stat[1];
  const float m = mean[p];
  const float r = rstd[p];
  const size_t base = (size_t)p * HW;
  const int beg = s * chunk;
  const int end = min(beg + chunk, HW);
  for (int i = beg + threadIdx.x; i < end; i += THREADS) {
    const float xh = (to_f(x[base + i]) - m) * r;
    float gp = to_f(g[base + i]);
    if (has_act && xh < 0.f) gp *= slope;
    store(dx + base + i, (gp - gm - xh * gz) * r);
  }
}

template <typename T>
void launch_bwd(const void* x, const void* g, const float* mean,
                const float* rstd, void* dx, float* partials, int NC, int HW,
                int splits, int has_act, float slope, cudaStream_t stream) {
  const int chunk = (HW + splits - 1) / splits;
  const dim3 grid(NC, splits);
  float2* part = reinterpret_cast<float2*>(partials);
  in_bwd_stats_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd, part,
      HW, chunk, splits, has_act, slope);
  in_bwd_apply_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd, part,
      static_cast<T*>(dx), HW, chunk, splits, has_act, slope);
}

template <typename T>
void launch_norm(const void* x, void* y, const float* mean, const float* rstd,
                 int NC, int HW, int splits, int has_act, float slope,
                 cudaStream_t stream) {
  const int chunk = (HW + splits - 1) / splits;
  in_norm_kernel<T><<<dim3(NC, splits), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, HW, chunk,
      has_act, slope);
}

template <typename T>
void launch(const void* x, void* y, float* partials, float* stats, int NC,
            int HW, int splits, float eps, int has_act, float slope,
            cudaStream_t stream) {
  const int chunk = (HW + splits - 1) / splits;
  const dim3 grid(NC, splits);
  float2* part = reinterpret_cast<float2*>(partials);
  in_stats_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), part, HW, chunk, splits);
  in_apply_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), part, HW, chunk, splits,
      eps, has_act, slope, stats, NC);
}

}  // namespace

// x, y: NC planes of HW elements each; partials: 2 * NC * splits floats of
// scratch; stats: null, or 2 * NC floats that receive each plane's mean and
// then its 1/std.  dtype: 0 = float32, 1 = bfloat16.  has_act = 0 is
// identity; otherwise negative outputs are scaled by slope (0 = ReLU).
// Returns cudaGetLastError() after both launches.
extern "C" int instance_norm_act_fwd(const void* x, void* y, float* partials,
                                     float* stats, int NC, int HW, int splits,
                                     float eps, int has_act, float slope,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, partials, stats, NC, HW, splits, eps, has_act, slope, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, partials, stats, NC, HW, splits, eps, has_act,
                          slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The apply pass alone, with given statistics (the fused conv3x3 + IN
// region's normalize, supervised_gan_tpu/ops/pallas/conv3x3_in.py `_norm_act`
// :166, which runs `stream_apply`, instance_norm.py:389, the
// `_fwd_apply_kernel` :312): y = act((x - mean) * rstd) for x, y NC planes of
// HW elements of `dtype`, mean and rstd NC floats each.  Returns
// cudaGetLastError() after the launch.
extern "C" int instance_norm_apply(const void* x, void* y, const float* mean,
                                   const float* rstd, int NC, int HW,
                                   int splits, int has_act, float slope,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_norm<float>(x, y, mean, rstd, NC, HW, splits, has_act, slope, s);
  } else if (dtype == 1) {
    launch_norm<__nv_bfloat16>(x, y, mean, rstd, NC, HW, splits, has_act,
                               slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: x, g, dx NC planes of HW elements of `dtype`; mean, rstd NC
// floats each (the forward's stats); partials: 2 * NC * splits floats of
// scratch.  Returns cudaGetLastError() after both launches.
extern "C" int instance_norm_act_bwd(const void* x, const void* g,
                                     const float* mean, const float* rstd,
                                     void* dx, float* partials, int NC,
                                     int HW, int splits, int has_act,
                                     float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(x, g, mean, rstd, dx, partials, NC, HW, splits,
                      has_act, slope, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(x, g, mean, rstd, dx, partials, NC, HW, splits,
                              has_act, slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
