// 4x4 stride-2 pad-1 convolution plus optional bias, NCHW, for Hopper
// (sm_90a).  Weight in torch's (Co, Ci, 4, 4) layout; output
// (N, Co, Ho, Wo) with Ho = (H - 2) / 2 + 1, in x's type, f32 accumulation.
//
// Replaces: supervised_gan_tpu/ops/pallas/conv4s2.py `_kernel` (:81), reached
// through `conv4s2_same` (:183).  The Pallas kernel packs two input pixels
// into the lane dimension so that the stride-2 taps become three banded
// tuple-shift dots, and its gate refuses Ci or Co that do not fill 64 lanes
// (the 1-, 2- and 3-channel stems); that packing is a TPU layout concern and
// is not carried over.  This kernel takes any N, Ci, Co, H and W.
//
// It serves every stride-2 conv of the PatchGAN trunks and of the unet
// down path, and it is the dx of every ConvTranspose2d k4 s2 p1 (the
// adjoint of a transposed conv is the conv with the same weight tensor).
//
// What bounds it on the H100: arithmetic at the wide sites (2*16*Ci FLOPs
// an output element: 0.026 ms for 128->256 at 128^2 as 3xTF32 on the
// tensor cores, 0.0043 ms in bf16), bytes at the 1- to 3-channel stems,
// where the output dominates.
//
// Design: an implicit GEMM on mma.sync (conv3x3_mma.cuh's primitives).
//   * GEMM view: M = a TH x TW = 8 x 16 tile of output pixels (each m16
//     fragment is the 16 output columns of one output row), N = BN = 64
//     output channels, K = Ci x 16 taps, ordered channel by channel: the K
//     of one bf16 m16n8k16 is the 16 taps of one input channel, that of one
//     f32 (TF32) m16n8k8 the 8 taps of two kernel rows.  8 warps, 4 along M
//     x 2 along N; a warp owns 2 output rows x 32 channels (2 x 4 fragments).
//   * Why the taps and not the channels make K: B is then the weights as
//     OIHW holds them, each output channel's 16 taps of a channel contiguous,
//     so ldmatrix reads B straight from the staged copy (rows padded to an
//     odd count of 16-byte units: no bank conflicts) and no pass reorders
//     the weights, on the host or in shared memory; and a 1-, 2- or
//     3-channel stem runs 1-3 k-steps a tile with nothing padded, so the
//     stems take the same kernel as the wide sites.
//   * Staging: a chunk of KC = 8 input channels is copied as it lies in
//     device memory with cp.async into one of two stages, the next chunk in
//     flight while this one is multiplied: per channel the (2TH + 2) halo
//     rows of RAW_W values from column 2*ox0 - XV, whole 16-byte vectors of
//     XV values (the halo starts at the odd column 2*ox0 - 1), zero outside
//     the image; then the chunk's weights of the block's output channels.
//     Rows that are not whole vectors (W not a multiple of XV) go value by
//     value.
//   * A is read from the staged halo itself: tap (ky, kx) of output pixel
//     (r, c) is halo row 2r + ky, value 2c + kx + XV - 1.  f32 reads one
//     value a register, 18 consecutive words a warp (no conflicts).  bf16
//     packs the taps kx, kx + 1 of a register from two 16-bit reads (the
//     pair starts at an odd column, so a 32-bit read would be misaligned).
//   * f32 runs 3xTF32: each fragment is split in registers into
//     hi = rna_tf32(v) and lo = rna_tf32(v - hi), and each accumulator sums
//     lo*hi, hi*lo, hi*hi (small terms first; each round over all of the
//     warp's accumulators).  bf16 products are exact in f32.
//   * Any shape: channels past Ci are neither staged nor multiplied, output
//     channels past Co are not staged (their accumulator columns are never
//     stored), and a warp skips its m16 fragments past Ho and its n8
//     fragments past Co.
//   * Small grids (the deep 8^2-64^2 sites: 4 to 64 blocks) split the
//     input-channel chunks over up to RESIDENT / blocks blocks, which write
//     f32 partials; conv4s2_reduce_kernel adds them in split order and adds
//     the bias.  No atomics: two runs agree bitwise.
//   * wgmma, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv3x3_mma.cuh"

namespace {

using conv3x3_mma::cp_async16;
using conv3x3_mma::cp_async4;
using conv3x3_mma::cp_async_commit;
using conv3x3_mma::cp_async_wait;
using conv3x3_mma::ldmatrix_x4;
using conv3x3_mma::mma_bf16;
using conv3x3_mma::mma_tf32;
using conv3x3_mma::split_tf32;

constexpr int TH = 8;                 // output rows a block
constexpr int TW = 16;                // output columns a block (m16)
constexpr int BN = 64;                // output channels a block
constexpr int KC = 8;                 // input channels a chunk
constexpr int WARPS_M = 4;            // warps along the pixels
constexpr int WARPS_N = 2;            // warps along the output channels
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int HALO_H = 2 * TH + 2;    // input rows a tile reads
constexpr int STAGES = 2;             // chunks staged at once
constexpr int RESIDENT = 2 * 132;     // blocks a launch keeps resident

// One stage, in bytes unless named otherwise.
template <typename T>
struct Stage {
  static constexpr int ES = sizeof(T);
  static constexpr int XV = 16 / ES;              // values a 16-byte vector
  static constexpr int RAW_W = 2 * TW + 2 * XV;   // values a halo row
  static constexpr int X_BYTES = KC * HALO_H * RAW_W * ES;
  static constexpr int WP = KC * 16 * ES + 16;    // between output channels
  static constexpr int BYTES = X_BYTES + BN * WP;
  static constexpr int SMEM = STAGES * BYTES;
  static constexpr int KSTEPS = 16 * ES / 32;     // mma k-steps a channel
};
static_assert(Stage<float>::WP / 16 % 2 == 1 &&
                  Stage<__nv_bfloat16>::WP / 16 % 2 == 1,
              "weight rows an odd count of 16-byte units: ldmatrix without "
              "bank conflicts");

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Copy chunk c0 .. c0+KC-1 (input channels) of tile (oy0, ox0) into a stage:
// the halo [c][HALO_H][RAW_W] from input row 2*oy0 - 1 and column
// 2*ox0 - XV (zero outside the image), then the weights [co][c][16 taps]
// of output channels co0 .. (rows WP bytes apart).  Channels past Ci and
// output channels past Co are not copied.  xvec: rows are whole 16-byte
// vectors; wvec: w is 16-byte aligned.  Otherwise value by value: cp.async
// for f32, plain loads for bf16.
template <typename T>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ xn,
                                           const T* __restrict__ w, int c0,
                                           int Ci, int Co, int H, int W,
                                           int oy0, int ox0, int co0,
                                           char* st, bool xvec, bool wvec) {
  using S = Stage<T>;
  constexpr int ES = S::ES, XV = S::XV, RAW_W = S::RAW_W;
  const int kc = min(KC, Ci - c0);
  const size_t plane = (size_t)H * W;
  const T* xc = xn + (size_t)c0 * plane;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - XV;
  if (xvec) {
    constexpr int NV = RAW_W / XV;  // vectors a row
    for (int i = threadIdx.x; i < kc * HALO_H * NV; i += THREADS) {
      const int v = i % NV, r = i / NV, hy = r % HALO_H, c = r / HALO_H;
      const int gy = iy0 + hy, gx = ix0 + v * XV;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(st + i * 16, ok ? xc + c * plane + (size_t)gy * W + gx : xn,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kc * HALO_H * RAW_W; i += THREADS) {
      const int e = i % RAW_W, r = i / RAW_W, hy = r % HALO_H, c = r / HALO_H;
      const int gy = iy0 + hy, gx = ix0 + e;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = ok ? xc + c * plane + (size_t)gy * W + gx : xn;
      if constexpr (ES == 4) {
        cp_async4(st + i * ES, src, ok);
      } else {
        *reinterpret_cast<unsigned short*>(st + i * ES) =
            ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
      }
    }
  }
  char* sw = st + S::X_BYTES;
  const int ncol = min(BN, Co - co0);
  const T* wc = w + ((size_t)co0 * Ci + c0) * 16;
  if (wvec) {
    const int nv = kc * ES;  // 16-byte vectors of one output channel
    for (int i = threadIdx.x; i < ncol * nv; i += THREADS) {
      const int co = i / nv, v = i - co * nv;
      cp_async16(sw + co * S::WP + v * 16,
                 reinterpret_cast<const char*>(wc + (size_t)co * Ci * 16) +
                     v * 16, true);
    }
  } else {
    const int nv = kc * 16;
    for (int i = threadIdx.x; i < ncol * nv; i += THREADS) {
      const int co = i / nv, e = i - co * nv;
      const T* src = wc + (size_t)co * Ci * 16 + e;
      if constexpr (ES == 4) {
        cp_async4(sw + co * S::WP + e * ES, src, true);
      } else {
        *reinterpret_cast<unsigned short*>(sw + co * S::WP + e * ES) =
            *reinterpret_cast<const unsigned short*>(src);
      }
    }
  }
}

// A fragment of output row `orow` of the tile, channel ci, k-step s (the
// m16nXk16 / m16n8k8 row-major layout: pixel g or g + 8, k as below).
// bf16: k = 4 ky + kx over the 16 taps; f32: k = 4 (ky - 2s) + kx.
template <typename T>
__device__ __forceinline__ void load_a(const char* xs, int ci, int s,
                                       int orow, int g, int t,
                                       uint32_t (&a)[4]) {
  using S = Stage<T>;
  constexpr int XV = S::XV, RAW_W = S::RAW_W;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int px = g + 8 * (r & 1);
    if constexpr (S::ES == 2) {
      // k = 2t, 2t+1 (+8): ky = t/2 (+2), kx = 2(t%2), 2(t%2) + 1
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(xs) +
          (ci * HALO_H + 2 * orow + t / 2 + 2 * (r >> 1)) * RAW_W + 2 * px +
          2 * (t & 1) + XV - 1;
      a[r] = uint32_t(p[0]) | (uint32_t(p[1]) << 16);
    } else {
      // k = t (+4): ky = 2s (+1), kx = t
      a[r] = reinterpret_cast<const uint32_t*>(xs)
          [(ci * HALO_H + 2 * orow + 2 * s + (r >> 1)) * RAW_W + 2 * px + t +
           XV - 1];
    }
  }
}

// One warp's MMAs over the kc staged channels of one chunk.
template <typename T>
__device__ __forceinline__ void chunk_mma(const char* st, int kc, int warp_m,
                                          int warp_n, int live_m, int live_n,
                                          float (&acc)[2][4][4]) {
  using S = Stage<T>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // ldmatrix: lanes 8m .. 8m+7 address matrix m = (n8 fragment 2np + m/2,
  // 16-byte half m%2), one output channel a lane
  const int m = lane >> 3;
  const char* wl = st + S::X_BYTES +
                   (warp_n * 32 + (m >> 1) * 8 + (lane & 7)) * S::WP +
                   (m & 1) * 16;
#pragma unroll
  for (int ci = 0; ci < KC; ++ci) {
    if (ci < kc) {
#pragma unroll
      for (int s = 0; s < S::KSTEPS; ++s) {
        uint32_t b[4][2], a[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t q[4];
          ldmatrix_x4(q, wl + np * 16 * S::WP + (ci * S::KSTEPS + s) * 32);
          b[2 * np][0] = q[0];
          b[2 * np][1] = q[1];
          b[2 * np + 1][0] = q[2];
          b[2 * np + 1][1] = q[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < live_m) load_a<T>(st, ci, s, warp_m * 2 + mt, g, t, a[mt]);
        if constexpr (S::ES == 2) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              if (mt < live_m && nt < live_n)
                mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
        } else {
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) split_tf32(a[mt][j], ah[mt][j], al[mt][j]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) split_tf32(b[nt][j], bh[nt][j], bl[nt][j]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              if (mt < live_m && nt < live_n)
                mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              if (mt < live_m && nt < live_n)
                mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              if (mt < live_m && nt < live_n)
                mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
        }
      }
    }
  }
}

// grid: (pixel tiles, output-channel tiles, N x splits).  Split s sums the
// input-channel chunks [s * per, (s + 1) * per); with one split it stores y
// (plus the bias), else its f32 partial sums.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv4s2_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ part, int N, int Ci, int Co, int H,
                  int W, int Ho, int Wo, int tiles_w, int per, bool xvec,
                  bool wvec) {
  using S = Stage<T>;
  extern __shared__ __align__(16) char smem[];
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z % N, split = blockIdx.z / N;
  const int chunks = (Ci + KC - 1) / KC;
  const int k0 = split * per, k1 = min(chunks, k0 + per);
  const T* xn = x + (size_t)n * Ci * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  // this warp's m16 fragments above row Ho and n8 fragments below Co
  const int live_m = min(2, max(0, Ho - oy0 - warp_m * 2));
  const int live_n = min(4, max(0, (Co - co0 - warp_n * 32 + 7) / 8));

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int k = k0; k < k0 + STAGES - 1; ++k) {
    if (k < k1)
      copy_chunk<T>(xn, w, k * KC, Ci, Co, H, W, oy0, ox0, co0,
                    smem + (k % STAGES) * S::BYTES, xvec, wvec);
    cp_async_commit();
  }
  // Chunk k: wait for its stage, then start the copy of chunk k + 1 into
  // the stage chunk k - 1 used (the barrier keeps it from overwriting what
  // chunk k - 1's MMAs read), then the MMAs.
  for (int k = k0; k < k1; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = k + STAGES - 1;
    if (next < k1)
      copy_chunk<T>(xn, w, next * KC, Ci, Co, H, W, oy0, ox0, co0,
                    smem + (next % STAGES) * S::BYTES, xvec, wvec);
    cp_async_commit();
    if (live_m > 0 && live_n > 0)
      chunk_mma<T>(smem + (k % STAGES) * S::BYTES, min(KC, Ci - k * KC),
                   warp_m, warp_n, live_m, live_n, acc);
  }

  // accumulator element j of fragment (mt, nt): output row
  // oy0 + warp_m * 2 + mt, column ox0 + lane/4 + 8 (j/2), channel
  // co0 + warp_n * 32 + nt * 8 + 2 (lane%4) + j%2; a store instruction
  // writes 8 consecutive pixels of 4 output channels
  const size_t oplane = (size_t)Ho * Wo;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= live_m) continue;
    const int oy = oy0 + warp_m * 2 + mt;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= live_n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + warp_n * 32 + nt * 8 + 2 * (lane & 3) + (j & 1);
        const int ox = ox0 + (lane >> 2) + 8 * (j >> 1);
        if (co < Co && ox < Wo) {
          const size_t i = ((size_t)n * Co + co) * oplane + (size_t)oy * Wo + ox;
          if (part != nullptr)
            part[(size_t)split * N * Co * oplane + i] = acc[mt][nt][j];
          else
            store(y + i, acc[mt][nt][j] + (bias != nullptr ? bias[co] : 0.f));
        }
      }
    }
  }
}

// y[i] = the splits' partials added in split order from 0, plus the bias
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

// ops/kernels/conv4s2.py tc_plan describes the same split.
struct Plan {
  int Ho, Wo, tiles_w, tiles, co_tiles, per, splits;
};

Plan plan(int N, int Ci, int Co, int H, int W) {
  Plan p;
  p.Ho = (H - 2) / 2 + 1;
  p.Wo = (W - 2) / 2 + 1;
  p.tiles_w = (p.Wo + TW - 1) / TW;
  p.tiles = p.tiles_w * ((p.Ho + TH - 1) / TH);
  p.co_tiles = (Co + BN - 1) / BN;
  const int chunks = (Ci + KC - 1) / KC;
  const int blocks = p.tiles * p.co_tiles * N;
  const int want = max(1, min(chunks, RESIDENT / blocks));
  p.per = (chunks + want - 1) / want;      // chunks a split
  p.splits = (chunks + p.per - 1) / p.per;
  return p;
}

template <typename T>
int launch(const Plan& p, const void* x, const void* w, const float* bias,
           void* y, float* part, int N, int Ci, int Co, int H, int W,
           cudaStream_t stream) {
  using S = Stage<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      conv4s2_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool xvec = W % S::XV == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(p.tiles, p.co_tiles, N * p.splits);
  conv4s2_tc_kernel<T><<<grid, THREADS, S::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), p.splits > 1 ? part : nullptr, N, Ci, Co, H, W,
      p.Ho, p.Wo, p.tiles_w, p.per, xvec, wvec);
  if (p.splits > 1) {
    const int oplane = p.Ho * p.Wo;
    const int count = N * Co * oplane;
    conv4s2_reduce_kernel<T><<<(count + 255) / 256, 256, 0, stream>>>(
        part, bias, static_cast<T*>(y), count, Co, oplane, p.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that conv4s2_fwd needs for these shapes (0: none).
extern "C" long long conv4s2_workspace(int N, int Ci, int Co, int H, int W) {
  const Plan p = plan(N, Ci, Co, H, W);
  return p.splits > 1 ? (long long)p.splits * N * Co * p.Ho * p.Wo : 0;
}

// The splits of the input-channel chunks the launch takes for these shapes
// (the same for both dtypes).
extern "C" int conv4s2_splits(int N, int Ci, int Co, int H, int W) {
  return plan(N, Ci, Co, H, W).splits;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it); bias is float32 or
// null; partials: conv4s2_workspace floats (null when that is 0).  H, W >= 2.
// Returns cudaGetLastError() after the launches.
extern "C" int conv4s2_fwd(const void* x, const void* w, const float* bias,
                           void* y, float* partials, int N, int Ci, int Co,
                           int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(N, Ci, Co, H, W);
  if (dtype == 0)
    return launch<float>(p, x, w, bias, y, partials, N, Ci, Co, H, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, x, w, bias, y, partials, N, Ci, Co, H,
                                 W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
