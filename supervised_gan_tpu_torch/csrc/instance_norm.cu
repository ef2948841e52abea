// InstanceNorm(affine=False) fused with LeakyReLU(slope) / ReLU (slope 0) /
// identity, NCHW, for Hopper (sm_90a), forward and backward.
//
// Replaces: supervised_gan_tpu/ops/pallas/instance_norm.py, the forward of
// `fused_instance_norm_act` (:148): the whole-plane `_kernel` (:109) and the
// streaming `_fwd_stats_kernel` (:297) / `_fwd_apply_kernel` (:312); and the
// backward's `_bwd_stats_kernel` (:319) and `_bwd_apply_kernel` (:337) of
// `_stream_bwd` (:416).  The forward also writes each plane's mean and 1/std,
// which the backward reuses (the JAX `_fwd` residuals, instance_norm.py:
// 154-181).  With x^ = (x - mean) * rstd and g' = g * act'(x^), the backward
// is dx = rstd * (g' - mean(g') - x^ * mean(g' x^)), x^ recomputed from x and
// the saved statistics.
//
// What bounds it on the H100: bytes.  About 7 operations an element against
// one read and one write (forward) or two reads and one write (backward); at
// 512^2 x 64 channels the planes are 64 MB in f32, past the 50 MB L2.
//
// Design: one launch that reads every element once.  The TPU's `_kernel`
// keeps a whole (n, c) plane in VMEM for one pass; a Hopper block has at most
// 227 KB of shared memory, so a plane is cut into `cluster` contiguous chunks
// held by the blocks of one thread-block cluster (1 to 16 blocks; `plan`
// says how many).  Each block loads its chunk into shared memory once with
// 16-byte loads (a scalar head and tail where a plane starts or ends off a
// 16-byte boundary: odd planes such as 15^2 are not aligned), summing as it
// loads: x and x^2 forward, g' and g' x^ backward, in f32.  The block's two
// sums go to its shared memory; after a cluster barrier every block reads
// all ranks' sums through distributed shared memory and adds them in rank
// order 0..R-1, so every block (and every run) gets the same statistics.  It
// then applies from shared memory and writes with 16-byte stores: HBM
// traffic is the bound's.  A plane too large for 16 blocks' shared memory
// takes the two-pass kernels below (statistics, then apply, over per-chunk
// partials), as `plan` decides from the shape alone.  A cluster launch that
// the card refuses returns its error; nothing switches route on an error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // the two-pass kernels

// The one-launch route's plan (ops/kernels/instance_norm.py `in_plan` is the
// same rule): a block holds about TARGET_BYTES of its plane; planes of
// MIN_BYTES or more are cut further until the grid has FILL_BLOCKS blocks
// (two on each of the 132 SMs); the cluster size is a power of two up to
// MAX_CLUSTER; a plane whose chunk at MAX_CLUSTER would need more than
// MAX_SMEM bytes of shared memory takes the two-pass route.
constexpr long long TARGET_BYTES = 64 * 1024;
constexpr long long MIN_BYTES = 16 * 1024;
constexpr long long FILL_BLOCKS = 264;
constexpr int MAX_CLUSTER = 16;
constexpr long long MAX_SMEM = 200 * 1024;
// the two-pass route: elements of a plane per block, at most MAX_SPLITS
constexpr long long SPLIT_CHUNK = 8192;
constexpr long long MAX_SPLITS = 1024;

enum Route { ROUTE_BLOCK = 0, ROUTE_CLUSTER = 1, ROUTE_TWO_PASS = 2 };

// cluster: blocks a plane (the two-pass route: its splits); chunk: elements
// a block; smem: dynamic shared memory bytes a block; threads: a block's
struct Plan {
  int route, cluster, chunk, smem, threads;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

int splits_for(long long HW) {
  const long long s = cdiv(HW, SPLIT_CHUNK);
  return static_cast<int>(s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s));
}

Plan make_plan(long long NC, long long HW, int dtype, int bwd) {
  const long long esize = dtype == 0 ? 4 : 2;
  const long long V = 16 / esize;
  const long long bpe = esize * (bwd ? 2 : 1);  // shared bytes an element
  const long long pbytes = HW * bpe;
  long long fill = cdiv(FILL_BLOCKS, NC);
  if (pbytes / MIN_BYTES < fill) fill = pbytes / MIN_BYTES;
  long long want = cdiv(pbytes, TARGET_BYTES);
  if (fill > want) want = fill;
  int R = 1;
  while (R < want && R < MAX_CLUSTER) R *= 2;
  const long long chunk = cdiv(cdiv(HW, R), V) * V;
  const long long smem = (chunk + V) * bpe;
  Plan p;
  if (smem > MAX_SMEM) {
    const int splits = splits_for(HW);
    p.route = ROUTE_TWO_PASS;
    p.cluster = splits;
    p.chunk = static_cast<int>(cdiv(HW, splits));
    p.smem = 0;
    p.threads = THREADS;
  } else {
    // a thread moves about 256 bytes of its block's chunk (128 to 512
    // threads): more, smaller blocks an SM hide one another's latency
    const long long bytes = chunk * bpe;
    p.route = R > 1 ? ROUTE_CLUSTER : ROUTE_BLOCK;
    p.cluster = R;
    p.chunk = static_cast<int>(chunk);
    p.smem = static_cast<int>(smem);
    p.threads = bytes >= 128 * 1024 ? 512 : (bytes >= 64 * 1024 ? 256 : 128);
  }
  return p;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------ the two-pass route --

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
      const float var = fmaxf(__fsub_rn(s2 / HW, __fmul_rn(mean, mean)), 0.f);
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

// dx of one chunk of a plane from `nparts` partial sums a plane of g' and
// g' x^, each mean taken over `count` elements (the plane's HW, or under a
// row split the global plane's)
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float2* __restrict__ partials, T* __restrict__ dx,
                    int HW, int chunk, int nparts, float count, int has_act,
                    float slope) {
  __shared__ float stat[2];
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < nparts; i += 32) {
      const float2 v = partials[(size_t)p * nparts + i];
      s1 += v.x;
      s2 += v.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      stat[0] = s1 / count;
      stat[1] = s2 / count;
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

// each plane's `splits` partial sums folded into one (sum, sum) pair, in the
// order the apply kernels fold them: the sums of a plane's rows on this
// rank, which a row-split run all-reduces before it applies
__global__ void __launch_bounds__(32)
in_fold_kernel(const float2* __restrict__ partials, float2* __restrict__ sums,
               int splits) {
  const int p = blockIdx.x;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < splits; i += 32) {
    const float2 v = partials[(size_t)p * splits + i];
    s1 += v.x;
    s2 += v.y;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (threadIdx.x == 0) sums[p] = make_float2(s1, s2);
}

// ------------------------------------------------------ the one-launch route --

// 16 bytes of T as floats
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);           // lower address
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack2(float a, float b) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(b)))
            << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// x, g: inputs (g only backward); y: y forward, dx backward; mean, rstd: the
// forward's statistics (backward); stats: null or 2 * NC floats that receive
// each plane's mean and rstd (forward); cluster: blocks a plane
struct Job {
  const void* x;
  const void* g;
  void* y;
  const float* mean;
  const float* rstd;
  float* stats;
  int NC, HW, chunk, cluster, has_act;
  float eps, slope;
};

__device__ __forceinline__ void fwd_acc(float v, float& s1, float& s2) {
  s1 += v;
  s2 = fmaf(v, v, s2);
}

__device__ __forceinline__ float fwd_out(float v, float mean, float rstd,
                                         int has_act, float slope) {
  float z = (v - mean) * rstd;
  if (has_act && z < 0.f) z *= slope;
  return z;
}

__device__ __forceinline__ void bwd_acc(float xv, float gv, float m, float r,
                                        int has_act, float slope, float& s1,
                                        float& s2) {
  const float xh = (xv - m) * r;
  float gp = gv;
  if (has_act && xh < 0.f) gp *= slope;
  s1 += gp;
  s2 = fmaf(gp, xh, s2);
}

__device__ __forceinline__ float bwd_out(float xv, float gv, float m, float r,
                                         float gm, float gz, int has_act,
                                         float slope) {
  const float xh = (xv - m) * r;
  float gp = gv;
  if (has_act && xh < 0.f) gp *= slope;
  return (gp - gm - xh * gz) * r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// One block: rank blockIdx.x % cluster of plane blockIdx.x / cluster.
template <typename T, bool BWD, int NT>
__device__ __forceinline__ void plane_body(const Job& j) {
  using P = Pack<T>;
  constexpr int V = P::N;  // elements a 16-byte vector
  constexpr int U = BWD ? 4 : 8;  // vectors in flight a thread, each input
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][NW];
  __shared__ float pub[2];
  __shared__ float stat[2];

  const int R = j.cluster;
  const int p = blockIdx.x / R;
  const int rank = blockIdx.x - p * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this block's elements [g0, g1) of the whole tensor: a scalar head
  // [g0, a0), 16-byte vectors [a0, a1), a scalar tail [a1, g1)
  const long long first = static_cast<long long>(rank) * j.chunk;
  const long long b = first < j.HW ? first : j.HW;
  const long long e = b + j.chunk < j.HW ? b + j.chunk : j.HW;
  const long long g0 = static_cast<long long>(p) * j.HW + b;
  const long long g1 = static_cast<long long>(p) * j.HW + e;
  long long a0 = (g0 + V - 1) / V * V;
  long long a1 = g1 / V * V;
  if (a0 > a1) a0 = a1 = g1;  // no whole vector: all head
  const long long base = g0 / V * V;  // element at shared index 0
  const int nv = static_cast<int>((a1 - a0) / V);
  const int nhead = static_cast<int>(a0 - g0);
  const int nscalar = nhead + static_cast<int>(g1 - a1);

  const T* x = static_cast<const T*>(j.x);
  const T* g = static_cast<const T*>(j.g);
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + (j.chunk + V);  // backward: g's chunk after x's
  const int off = static_cast<int>(a0 - base);
  const uint4* xv = reinterpret_cast<const uint4*>(x + a0);
  uint4* xsv = reinterpret_cast<uint4*>(xs + off);
  const uint4* gv = nullptr;
  uint4* gsv = nullptr;
  float m = 0.f, r = 0.f;
  if constexpr (BWD) {
    gv = reinterpret_cast<const uint4*>(g + a0);
    gsv = reinterpret_cast<uint4*>(gs + off);
    m = j.mean[p];
    r = j.rstd[p];
  }

  // load once, summing as the vectors arrive
  float s1 = 0.f, s2 = 0.f;
  for (int v0 = 0; v0 < nv; v0 += NT * U) {
    uint4 bx[U], bg[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int v = v0 + k * NT + tid;
      if (v < nv) {
        bx[k] = __ldg(xv + v);
        if constexpr (BWD) bg[k] = __ldg(gv + v);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int v = v0 + k * NT + tid;
      if (v < nv) {
        float fx[V];
        xsv[v] = bx[k];
        P::unpack(bx[k], fx);
        if constexpr (BWD) {
          float fg[V];
          gsv[v] = bg[k];
          P::unpack(bg[k], fg);
#pragma unroll
          for (int i = 0; i < V; ++i)
            bwd_acc(fx[i], fg[i], m, r, j.has_act, j.slope, s1, s2);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) fwd_acc(fx[i], s1, s2);
        }
      }
    }
  }
  if (tid < nscalar) {
    const long long gi = tid < nhead ? g0 + tid : a1 + (tid - nhead);
    const T xe = x[gi];
    xs[gi - base] = xe;
    if constexpr (BWD) {
      const T ge = g[gi];
      gs[gi - base] = ge;
      bwd_acc(to_f(xe), to_f(ge), m, r, j.has_act, j.slope, s1, s2);
    } else {
      fwd_acc(to_f(xe), s1, s2);
    }
  }

  // the block's sums, then the plane's: ranks 0..R-1 in order
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      t1 += red[0][w];
      t2 += red[1][w];
    }
    pub[0] = t1;
    pub[1] = t2;
  }
  if (R > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (warp == 0) {
    float a = 0.f, c = 0.f;
    if (R > 1) {
      if (lane < R) {
        const float* q = cg::this_cluster().map_shared_rank(&pub[0], lane);
        a = q[0];
        c = q[1];
      }
    } else if (lane == 0) {
      a = pub[0];
      c = pub[1];
    }
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < R; ++q) {
      t1 += __shfl_sync(0xffffffffu, a, q);
      t2 += __shfl_sync(0xffffffffu, c, q);
    }
    if (lane == 0) {
      if constexpr (BWD) {
        stat[0] = t1 / j.HW;
        stat[1] = t2 / j.HW;
      } else {
        // E[x^2] - mean^2 rounded as two f32 operations, not one fma: a
        // constant plane's variance is then 0, as the plain version has it
        const float mean = t1 / j.HW;
        const float var = fmaxf(__fsub_rn(t2 / j.HW, __fmul_rn(mean, mean)),
                                0.f);
        stat[0] = mean;
        stat[1] = 1.f / sqrtf(var + j.eps);
        if (j.stats != nullptr && rank == 0) {
          j.stats[p] = stat[0];
          j.stats[j.NC + p] = stat[1];
        }
      }
    }
  }
  // this block has read the other ranks' sums; none may exit before all
  // have (cluster_wait at the end)
  if (R > 1) cluster_arrive();
  __syncthreads();
  const float sa = stat[0];
  const float sb = stat[1];

  // apply from shared memory
  T* y = static_cast<T*>(j.y);
  uint4* yv = reinterpret_cast<uint4*>(y + a0);
  for (int v = tid; v < nv; v += NT) {
    float fx[V];
    P::unpack(xsv[v], fx);
    if constexpr (BWD) {
      float fg[V];
      P::unpack(gsv[v], fg);
#pragma unroll
      for (int i = 0; i < V; ++i)
        fx[i] = bwd_out(fx[i], fg[i], m, r, sa, sb, j.has_act, j.slope);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        fx[i] = fwd_out(fx[i], sa, sb, j.has_act, j.slope);
    }
    yv[v] = P::pack(fx);
  }
  if (tid < nscalar) {
    const long long gi = tid < nhead ? g0 + tid : a1 + (tid - nhead);
    const float xe = to_f(xs[gi - base]);
    if constexpr (BWD) {
      store(y + gi, bwd_out(xe, to_f(gs[gi - base]), m, r, sa, sb, j.has_act,
                            j.slope));
    } else {
      store(y + gi, fwd_out(xe, sa, sb, j.has_act, j.slope));
    }
  }
  if (R > 1) cluster_wait();
}

// Two names, so that a profile tells the directions apart.
template <typename T, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
in_fwd_plane_kernel(Job j) {
  plane_body<T, false, NT>(j);
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
in_bwd_plane_kernel(Job j) {
  plane_body<T, true, NT>(j);
}

// The kernel's attributes (dynamic shared memory up to MAX_SMEM, clusters of
// up to 16 blocks), set once on each device.
template <typename K>
cudaError_t prepare(K kern, std::atomic<unsigned>& ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load() & bit) return cudaSuccess;
  const void* f = reinterpret_cast<const void*>(kern);
  e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(MAX_SMEM));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready.fetch_or(bit);
  return e;
}

template <typename T, bool BWD, int NT>
cudaError_t config(const Plan& pl, int NC, cudaStream_t s,
                   cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   void (**kern)(Job)) {
  static std::atomic<unsigned> ready{0};
  *kern = BWD ? &in_bwd_plane_kernel<T, NT> : &in_fwd_plane_kernel<T, NT>;
  const cudaError_t e = prepare(*kern, ready);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(NC) * pl.cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  if (pl.route == ROUTE_CLUSTER) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return e;
}

template <typename T, bool BWD>
cudaError_t config_any(const Plan& pl, int NC, cudaStream_t s,
                       cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                       void (**kern)(Job)) {
  if (pl.threads == 512) return config<T, BWD, 512>(pl, NC, s, cfg, attr, kern);
  if (pl.threads == 256) return config<T, BWD, 256>(pl, NC, s, cfg, attr, kern);
  return config<T, BWD, 128>(pl, NC, s, cfg, attr, kern);
}

cudaError_t plane_config(const Plan& pl, int NC, int dtype, int bwd,
                         cudaStream_t s, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute* attr, void (**kern)(Job)) {
  if (dtype == 0)
    return bwd ? config_any<float, true>(pl, NC, s, cfg, attr, kern)
               : config_any<float, false>(pl, NC, s, cfg, attr, kern);
  return bwd ? config_any<__nv_bfloat16, true>(pl, NC, s, cfg, attr, kern)
             : config_any<__nv_bfloat16, false>(pl, NC, s, cfg, attr, kern);
}

cudaError_t launch_plane(const Plan& pl, const Job& job, int dtype, int bwd,
                         cudaStream_t s) {
  // 16-byte vectors: every tensor must start on a 16-byte boundary
  const unsigned long long bits = reinterpret_cast<unsigned long long>(job.x) |
                                  reinterpret_cast<unsigned long long>(job.g) |
                                  reinterpret_cast<unsigned long long>(job.y);
  if (bits & 15) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  void (*kern)(Job) = nullptr;
  const cudaError_t e = plane_config(pl, job.NC, dtype, bwd, s, cfg, attr,
                                     &kern);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kern, job);
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
      static_cast<T*>(dx), HW, chunk, splits, static_cast<float>(HW), has_act,
      slope);
}

// The row-split route's pieces (the two-pass kernels with a fold between):
// a plane's (sum x, sum x^2), its (sum g', sum g' x^) given the statistics,
// and dx given the all-reduced sums and their count.
template <typename T>
void launch_partial_stats(const void* x, float* partials, float* sums, int NC,
                          int HW, int splits, cudaStream_t stream) {
  const int chunk = (HW + splits - 1) / splits;
  float2* part = reinterpret_cast<float2*>(partials);
  in_stats_kernel<T><<<dim3(NC, splits), THREADS, 0, stream>>>(
      static_cast<const T*>(x), part, HW, chunk, splits);
  in_fold_kernel<<<NC, 32, 0, stream>>>(part, reinterpret_cast<float2*>(sums),
                                        splits);
}

template <typename T>
void launch_bwd_partial_stats(const void* x, const void* g, const float* mean,
                              const float* rstd, float* partials, float* sums,
                              int NC, int HW, int splits, int has_act,
                              float slope, cudaStream_t stream) {
  const int chunk = (HW + splits - 1) / splits;
  float2* part = reinterpret_cast<float2*>(partials);
  in_bwd_stats_kernel<T><<<dim3(NC, splits), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd, part,
      HW, chunk, splits, has_act, slope);
  in_fold_kernel<<<NC, 32, 0, stream>>>(part, reinterpret_cast<float2*>(sums),
                                        splits);
}

template <typename T>
void launch_bwd_apply(const void* x, const void* g, const float* mean,
                      const float* rstd, const float* sums, void* dx, int NC,
                      int HW, int splits, float count, int has_act,
                      float slope, cudaStream_t stream) {
  const int chunk = (HW + splits - 1) / splits;
  in_bwd_apply_kernel<T><<<dim3(NC, splits), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
      reinterpret_cast<const float2*>(sums), static_cast<T*>(dx), HW, chunk, 1,
      count, has_act, slope);
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

// The error of this call's launches, and the runtime's last error cleared.
int finish(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// The plan for NC planes of HW elements of `dtype` (0 = float32, 1 =
// bfloat16), forward (bwd = 0) or backward: out[0..4] = route (0 one block a
// plane, 1 a cluster of blocks a plane, 2 the two-pass kernels), blocks a
// plane (the two-pass route: splits), elements a block, dynamic shared
// memory bytes a block, threads a block.  Returns 0.
extern "C" int instance_norm_plan(int NC, int HW, int dtype, int bwd,
                                  int* out) {
  const Plan p = make_plan(NC, HW, dtype, bwd);
  out[0] = p.route;
  out[1] = p.cluster;
  out[2] = p.chunk;
  out[3] = p.smem;
  out[4] = p.threads;
  return 0;
}

// Clusters (blocks, on the block route) of the plan's kernel that the card
// holds at once, from cudaOccupancyMaxActiveClusters; the negated CUDA error
// if the query fails; 0 on the two-pass route.
extern "C" int instance_norm_max_active_clusters(int NC, int HW, int dtype,
                                                 int bwd) {
  const Plan p = make_plan(NC, HW, dtype, bwd);
  if (p.route == ROUTE_TWO_PASS) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  void (*kern)(Job) = nullptr;
  cudaError_t e = plane_config(p, NC, dtype, bwd, nullptr, cfg, attr, &kern);
  int n = 0;
  if (e == cudaSuccess) {
    cfg.attrs = attr;  // a block is a cluster of one on the block route
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kern), &cfg);
  }
  const int err = finish(e);
  return err != 0 ? -err : n;
}

// x, y: NC planes of HW elements each; partials: `workspace` floats of
// scratch, 2 * NC * splits on the two-pass route, else null; stats: null,
// or 2 * NC floats that receive each plane's mean and then its 1/std.
// dtype: 0 = float32, 1 = bfloat16.  has_act = 0 is identity; otherwise
// negative outputs are scaled by slope (0 = ReLU).  Returns the launch's
// error, else cudaGetLastError() after it.
extern "C" int instance_norm_act_fwd(const void* x, void* y, float* partials,
                                     long long workspace, float* stats,
                                     int NC, int HW, float eps, int has_act,
                                     float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(NC, HW, dtype, 0);
  if (p.route == ROUTE_TWO_PASS) {
    if (partials == nullptr || workspace < 2LL * NC * p.cluster)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
      launch<float>(x, y, partials, stats, NC, HW, p.cluster, eps, has_act,
                    slope, s);
    else
      launch<__nv_bfloat16>(x, y, partials, stats, NC, HW, p.cluster, eps,
                            has_act, slope, s);
    return finish(cudaSuccess);
  }
  Job job{x, nullptr, y, nullptr, nullptr, stats, NC, HW, p.chunk, p.cluster,
          has_act, eps, slope};
  return finish(launch_plane(p, job, dtype, 0, s));
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
// floats each (the forward's stats); partials: `workspace` floats of
// scratch, 2 * NC * splits on the two-pass route, else null.  Returns the
// launch's error, else cudaGetLastError() after it.
extern "C" int instance_norm_act_bwd(const void* x, const void* g,
                                     const float* mean, const float* rstd,
                                     void* dx, float* partials,
                                     long long workspace, int NC, int HW,
                                     int has_act, float slope, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(NC, HW, dtype, 1);
  if (p.route == ROUTE_TWO_PASS) {
    if (partials == nullptr || workspace < 2LL * NC * p.cluster)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
      launch_bwd<float>(x, g, mean, rstd, dx, partials, NC, HW, p.cluster,
                        has_act, slope, s);
    else
      launch_bwd<__nv_bfloat16>(x, g, mean, rstd, dx, partials, NC, HW,
                                p.cluster, has_act, slope, s);
    return finish(cudaSuccess);
  }
  Job job{x, g, dx, mean, rstd, nullptr, NC, HW, p.chunk, p.cluster, has_act,
          0.f, slope};
  return finish(launch_plane(p, job, dtype, 1, s));
}

// ---------------------------------------------- the row-split route's entries --
// Under --spatial_mesh a plane's rows lie on several ranks: each computes its
// rows' sums, the sums are all-reduced, then each applies.  These entries
// are the two-pass route's kernels (the JAX `_fwd_stats_kernel` :297,
// `_bwd_stats_kernel` :319 and `_bwd_apply_kernel` :337 of ops/pallas/
// instance_norm.py) with the fold to one pair a plane; the apply with given
// statistics is `instance_norm_apply` above.  x, g, dx: NC planes of HW
// elements of `dtype`; sums: NC float pairs (sum, sum); partials: `workspace`
// floats of scratch, at least 2 * NC * splits (splits = instance_norm_splits
// (HW)).  Each returns cudaErrorInvalidValue for a short workspace or an
// unknown dtype, else cudaGetLastError() after its launches.

// The two-pass route's splits of a plane of HW elements.
extern "C" int instance_norm_splits(int HW) { return splits_for(HW); }

// sums[p] = (sum x, sum x^2) over plane p.
extern "C" int instance_norm_partial_stats(const void* x, float* partials,
                                           long long workspace, float* sums,
                                           int NC, int HW, int dtype,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = splits_for(HW);
  if ((dtype != 0 && dtype != 1) || partials == nullptr ||
      workspace < 2LL * NC * splits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_partial_stats<float>(x, partials, sums, NC, HW, splits, s);
  else
    launch_partial_stats<__nv_bfloat16>(x, partials, sums, NC, HW, splits, s);
  return finish(cudaSuccess);
}

// sums[p] = (sum g', sum g' x^) over plane p, x^ = (x - mean) * rstd and
// g' = g * act'(x^), from the (global) mean and rstd.
extern "C" int instance_norm_bwd_partial_stats(
    const void* x, const void* g, const float* mean, const float* rstd,
    float* partials, long long workspace, float* sums, int NC, int HW,
    int has_act, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = splits_for(HW);
  if ((dtype != 0 && dtype != 1) || partials == nullptr ||
      workspace < 2LL * NC * splits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_bwd_partial_stats<float>(x, g, mean, rstd, partials, sums, NC, HW,
                                    splits, has_act, slope, s);
  else
    launch_bwd_partial_stats<__nv_bfloat16>(x, g, mean, rstd, partials, sums,
                                            NC, HW, splits, has_act, slope, s);
  return finish(cudaSuccess);
}

// dx = rstd * (g' - s1 / count - x^ * s2 / count) with (s1, s2) = sums[p]
// (all-reduced over the ranks) and count the global plane's elements.
extern "C" int instance_norm_bwd_apply(const void* x, const void* g,
                                       const float* mean, const float* rstd,
                                       const float* sums, void* dx, int NC,
                                       int HW, float count, int has_act,
                                       float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = splits_for(HW);
  if (dtype == 0)
    launch_bwd_apply<float>(x, g, mean, rstd, sums, dx, NC, HW, splits, count,
                            has_act, slope, s);
  else if (dtype == 1)
    launch_bwd_apply<__nv_bfloat16>(x, g, mean, rstd, sums, dx, NC, HW,
                                    splits, count, has_act, slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return finish(cudaSuccess);
}
