// ConvTranspose2d k4 s2 p1 output-padding 0 plus optional bias, NCHW, for
// Hopper (sm_90a).  Weight in torch's (Ci, Co, 4, 4) layout; output
// (N, Co, 2H, 2W) in x's type, f32 accumulation.
//
// Replaces: supervised_gan_tpu/ops/pallas/convt4s2.py `_kernel` (:157),
// reached through `convt4s2` (:269).  The Pallas kernel packs T pixels into
// the 128 TPU lanes and folds the stride-2 column interleave into banded
// weights; that packing is a TPU layout concern and is not carried over.
//
// It serves G1's and F2's transposed convs, and it is the dx of every k4 s2
// conv (the adjoint of a conv is the transposed conv with the same weight
// tensor).
//
// The phase decomposition (convt4s2.py:21-28): output pixel (2m+q, 2n+r) is
// a 2x2 gather over x, 4 of the 16 taps, so each of the four phases (q, r)
// is a stride-1 2x2 conv of x.  Along one axis,
//   q = 0: tap 1 reads x row m,   tap 3 reads x row m-1;
//   q = 1: tap 0 reads x row m+1, tap 2 reads x row m.
// It is computed directly; no conv runs over a zero-dilated input.
//
// What bounds it on the H100: arithmetic at the wide sites (2*4*Ci FLOPs an
// output element: 0.026 ms for 256->128 on 64^2 as 3xTF32 on the tensor
// cores, 0.0043 ms in bf16), bytes at the 1- to 3-channel outputs (the D
// stems' dx, e.g. 32->1 on 256^2), where reading x dominates.  On mma.sync
// with shared-memory staging the kernel stays far from both: every stage of
// a chunk (copy, transposes, MMAs) is a latency chain between barriers.
//
// Design: an implicit GEMM on mma.sync over the four phases at once, on
// conv3x3_mma.cuh's staging and primitives.
//   * GEMM view: M = a TH x TW = 8 x 16 tile of INPUT positions (m, n) (an
//     m16 fragment is 16 input columns of one row), N = 16 output channels
//     a warp, K = the input channels at each of the 16 (shift, tap) pairs,
//     KC at a time (16 bf16 for m16n8k16, 8 f32 for m16n8k8 TF32).  Each
//     pair feeds its own phase's accumulators.
//   * The (TH+2) x (TW+2) halo of an input tile is conv3x3's halo, so it is
//     staged by conv3x3's copy_halo and transpose_halo (raw cp.async stages,
//     then channels-last in shared memory), and ldmatrix builds A at each of
//     the 9 shifts (dy, dx) in {0, 1, 2}^2 as at conv3x3's taps.  Along an
//     axis, shift 0 feeds tap 3 (phase 0), shift 1 taps 1 (phase 0) and 2
//     (phase 1), shift 2 tap 0 (phase 1): 16 pairs in all.
//   * Weights: a chunk's w[ci][co0 .. co0 + BN][16 taps] lies contiguous
//     for each ci, so it is copied as it lies in 16-byte vectors (rows
//     padded to an odd count of 16-byte units: the transpose reads them
//     without bank conflicts), then transposed in shared memory to
//     [co][16 taps][channel], output channels 528 bytes apart (33 units:
//     ldmatrix without bank conflicts), as conv3x3 lays out [co][9][ch].
//     No host-side op reorders the weights.
//   * Registers: four phases on one warp's tile would take 64 accumulators
//     a thread, and spill at 128 registers.  So a warp runs one phase row q
//     (both r, 6 shifts, 8 pairs) on 2 input rows x 16 channels: 32
//     accumulators; 8 warps a phase row share the block's staged chunk.
//     The copy's thread index passes through an empty asm, so that its
//     addressing is recomputed for each chunk rather than held in registers
//     across the loop: 96 registers, no spills.
//   * Two block shapes (Cfg): wide (Co > 16) 32 channels, 16 warps, one
//     block an SM, four raw stages; narrow (Co <= 16, the 1- to 3-channel
//     outputs) 16 channels, 8 warps, two stages, two blocks an SM, which
//     hide each other's latency where one block would leave half its warps
//     idle.
//   * Pipeline: raw stages run STAGES - 1 chunks ahead; two MMA layouts
//     alternate, so chunk k + 1's transpose overlaps chunk k's MMAs and a
//     chunk takes one barrier.
//   * Stores: a lane holds phases r = 0 and 1 of its positions, so it
//     stores output columns 2n and 2n + 1 as one pair; a store instruction
//     writes 16 consecutive output values of 4 output channels.
//   * f32 runs 3xTF32: each operand is split into hi and lo once, in the
//     transpose, and each pair accumulates lo*hi, hi*lo, hi*hi, each a round
//     over the shift's pairs.  bf16 products are exact in f32.
//   * Any shape: positions outside the image and channels past Ci are zero
//     when staged, output channels past Co are not staged (their
//     accumulator columns are never stored), and a warp skips its m16
//     fragments past H and its n8 fragments past Co.
//   * Small grids (the deep 4^2-32^2 sites) split the input channels, in
//     units of 16, over up to one round of resident blocks, which write f32
//     partials; convt4s2_reduce_kernel adds them in split order and adds the
//     bias.  No atomics: two runs agree bitwise.
//   * One unit of input channels over at most 16 input positions (G1's
//     first transposed conv, 8 -> 256 on 4^2) takes a CUDA-core loop
//     instead (convt4s2_cc_kernel): there the pipeline's fill outlasts that
//     loop's whole run.
//   * wgmma, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv3x3_mma.cuh"

namespace {

using conv3x3_mma::a_fragments;
using conv3x3_mma::b_fragments;
using conv3x3_mma::copy_halo;
using conv3x3_mma::cp_async16;
using conv3x3_mma::cp_async4;
using conv3x3_mma::cp_async_commit;
using conv3x3_mma::cp_async_wait;
using conv3x3_mma::Elem;
using conv3x3_mma::mma_bf16;
using conv3x3_mma::mma_tf32;
using conv3x3_mma::raw_x_bytes;
using conv3x3_mma::split_tf32;
using conv3x3_mma::transpose_halo;

using conv3x3_mma::ROW;       // bytes of one chunk row (KC values)
using conv3x3_mma::TH;        // input rows a block
using conv3x3_mma::TW;        // input columns a block (m16)
using conv3x3_mma::WARPS_M;   // warps along the input positions
using conv3x3_mma::XS_BYTES;  // the channels-last halo

constexpr int UNIT = 16;                 // input channels a unit of a split
constexpr int WT_PITCH = 16 * ROW + 16;  // bytes between output channels
constexpr int SMS = 132;                 // the H100's SMs
static_assert(WT_PITCH / 16 % 2 == 1,
              "weight rows an odd count of 16-byte units: ldmatrix without "
              "bank conflicts");

// A block's shape: WN warp columns of 16 output channels.  Wide (WN = 2,
// Co > 16): 32 channels, 16 warps, one block an SM, four raw stages.
// Narrow (WN = 1, Co <= 16, the 1- to 3-channel outputs): 16 channels, 8
// warps and two stages, so that two blocks share an SM and hide each
// other's latency.
template <typename T, int WN>
struct Cfg {
  static constexpr int BN = 16 * WN;                   // output channels
  static constexpr int THREADS = 32 * 2 * WARPS_M * WN;  // 2 phase rows
  static constexpr int BLOCKS_PER_SM = 3 - WN;
  static constexpr int STAGES = 2 * WN;
  static constexpr int MMA_BYTES = XS_BYTES + BN * WT_PITCH;  // hi or lo
  // one raw stage, in bytes: the halo (conv3x3's), then the weights [c][co]
  // rows of 16 taps, RWP bytes apart
  static constexpr int ES = sizeof(T);
  static constexpr int KC = Elem<T>::KC;
  static constexpr int RWP = 16 * ES + 16;
  static constexpr int X_BYTES = raw_x_bytes<T>();
  static constexpr int BYTES = X_BYTES + KC * BN * RWP;
  static constexpr int MMA = Elem<T>::COPIES * MMA_BYTES;  // one MMA layout
  static constexpr int SMEM = 2 * MMA + STAGES * BYTES;
  static_assert(RWP / 16 % 2 == 1,
                "raw weight rows an odd count of 16-byte units");
};

// The wide shape for Co > 16, else the narrow one (ops/kernels/convt4s2.py
// co_block).
inline int warp_cols(int Co) { return Co > 16 ? 2 : 1; }

// Along one axis, halo offset d (0, 1, 2: x index m - 1 + d) feeds
// n_pairs(d) (phase, kernel index) pairs: pair i is phase pair_phase(d, i)
// with kernel index pair_tap(d, i).
__host__ __device__ constexpr int n_pairs(int d) { return d == 1 ? 2 : 1; }
__host__ __device__ constexpr int pair_phase(int d, int i) {
  return d == 0 ? 0 : d == 2 ? 1 : i;
}
__host__ __device__ constexpr int pair_tap(int d, int i) {
  return d == 0 ? 3 : d == 2 ? 0 : 1 + i;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Copy the weights of input channels c0 .. c0 + kc - 1 and output channels
// co0 .. (at most BN, below Co) as they lie in device memory into a raw
// stage: row (c, co) of 16 taps at (c * BN + co) * RWP.  wvec: w is 16-byte
// aligned (every row then is); otherwise value by value, cp.async for f32,
// plain loads for bf16.
template <typename T, int WN>
__device__ __forceinline__ void copy_weights(const T* __restrict__ w, int c0,
                                             int kc, int Co, int co0,
                                             char* sw, bool wvec, int tid) {
  using S = Cfg<T, WN>;
  constexpr int BN = S::BN, THREADS = S::THREADS;
  constexpr int ES = S::ES;
  const int ncol = min(BN, Co - co0);
  const T* wc = w + ((size_t)c0 * Co + co0) * 16;
  if (wvec) {
    constexpr int NV = ES;  // 16-byte vectors a row
    for (int i = tid; i < kc * ncol * NV; i += THREADS) {
      const int v = i % NV, r = i / NV, co = r % ncol, c = r / ncol;
      cp_async16(sw + (c * BN + co) * S::RWP + v * 16,
                 reinterpret_cast<const char*>(wc + ((size_t)c * Co + co) * 16)
                     + v * 16, true);
    }
  } else {
    for (int i = tid; i < kc * ncol * 16; i += THREADS) {
      const int e = i % 16, r = i / 16, co = r % ncol, c = r / ncol;
      const T* src = wc + ((size_t)c * Co + co) * 16 + e;
      char* dst = sw + (c * BN + co) * S::RWP + e * ES;
      if constexpr (ES == 4) {
        cp_async4(dst, src, true);
      } else {
        *reinterpret_cast<unsigned short*>(dst) =
            *reinterpret_cast<const unsigned short*>(src);
      }
    }
  }
}

// Raw weights -> [co][tap][channel] at mma + XS_BYTES for the ncol output
// channels below Co (a thread takes one channel pair of one output channel
// over the 16 taps), zero past Ci (kc channels here).  Rows past Co are left
// as they are: they only reach accumulator columns that are never stored.
// f32 values are split here, once: hi to mma, lo to mma + MMA_BYTES.
template <typename T, int WN>
__device__ __forceinline__ void transpose_weights(const char* sw, char* mma,
                                                  int kc, int ncol) {
  using S = Cfg<T, WN>;
  constexpr int BN = S::BN, THREADS = S::THREADS, MMA_BYTES = S::MMA_BYTES;
  constexpr int ES = S::ES, PAIRS = S::KC / 2;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < ncol * PAIRS; i += THREADS) {
    const int co = i % ncol, p = i / ncol;
    const bool ok0 = 2 * p < kc, ok1 = 2 * p + 1 < kc;
    const uint4* s0 =
        reinterpret_cast<const uint4*>(sw + (2 * p * BN + co) * S::RWP);
    const uint4* s1 = reinterpret_cast<const uint4*>(
        sw + ((2 * p + 1) * BN + co) * S::RWP);
    char* d = mma + XS_BYTES + co * WT_PITCH + p * 2 * ES;
#pragma unroll
    for (int v = 0; v < ES; ++v) {  // the row's 16-byte vectors
      const uint4 u0 = ok0 ? s0[v] : zero, u1 = ok1 ? s1[v] : zero;
      const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
      const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (ES == 2) {
          // word k holds taps 8v + 2k (low half) and 8v + 2k + 1
          const int tap = 8 * v + 2 * k;
          *reinterpret_cast<uint32_t*>(d + tap * ROW) =
              __byte_perm(w0[k], w1[k], 0x5410);
          *reinterpret_cast<uint32_t*>(d + (tap + 1) * ROW) =
              __byte_perm(w0[k], w1[k], 0x7632);
        } else {
          const int tap = 4 * v + k;
          uint32_t h0, l0, h1, l1;
          split_tf32(w0[k], h0, l0);
          split_tf32(w1[k], h1, l1);
          *reinterpret_cast<uint2*>(d + tap * ROW) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(d + MMA_BYTES + tap * ROW) =
              make_uint2(l0, l1);
        }
      }
    }
  }
}

// One warp's MMAs over one staged chunk for phase row Q: for each of the 6
// shifts whose rows phase row Q reads, A once and B of each of its one or
// two (phase, tap) pairs of row Q, then the MMAs into the pairs' phase
// accumulators acc[r][mt][nt] (f32: lo*hi, hi*lo, hi*hi, each a round over
// the shift's pairs and fragments, so that a round's MMAs are
// independent).  ws: the warp's 16 output channels' weights.
template <typename T, int WN, int Q>
__device__ __forceinline__ void chunk_mma(const char* mma, const char* ws,
                                          int warp_m, int live_m, int live_n,
                                          float (&acc)[2][2][2][4]) {
  constexpr int MMA_BYTES = Cfg<T, WN>::MMA_BYTES;
#pragma unroll
  for (int dy = Q; dy < Q + 2; ++dy) {
    // the one pair of this row offset in phase row Q
    const int ky = pair_tap(dy, dy == 1 ? Q : 0);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      constexpr int NP = 2;  // at most n_pairs(dx) pairs are live
      uint32_t a[2][4], al[2][4], b[NP][2][2], bl[NP][2][2];
      a_fragments(mma, dy, dx, warp_m, a);
      if constexpr (sizeof(T) == 4)
        a_fragments(mma + MMA_BYTES, dy, dx, warp_m, al);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (j >= n_pairs(dx)) continue;
        const int tap = 4 * ky + pair_tap(dx, j);
        b_fragments(ws + tap * ROW, WT_PITCH, b[j]);
        if constexpr (sizeof(T) == 4)
          b_fragments(ws + MMA_BYTES + tap * ROW, WT_PITCH, bl[j]);
      }
      // f32: rounds lo*hi, hi*lo, hi*hi; bf16: one round of exact products
      constexpr int ROUNDS = sizeof(T) == 4 ? 3 : 1;
#pragma unroll
      for (int round = 0; round < ROUNDS; ++round) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (j >= n_pairs(dx)) continue;
          const int r = pair_phase(dx, j);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              if (mt >= live_m || nt >= live_n) continue;
              if constexpr (sizeof(T) == 2) {
                mma_bf16(acc[r][mt][nt], a[mt], b[j][nt][0], b[j][nt][1]);
              } else {
                const uint32_t(&am)[4] = round == 0 ? al[mt] : a[mt];
                const uint32_t(&bm)[2][2] = round == 1 ? bl[j] : b[j];
                mma_tf32(acc[r][mt][nt], am, bm[nt][0], bm[nt][1]);
              }
            }
        }
      }
    }
  }
}

// grid: (input tiles, output-channel tiles, N x splits).  Split s sums the
// input channels of units [s * per, (s + 1) * per); with one split it
// stores y (plus the bias), else its f32 partial sums.  The first half of
// the warps run phase row q = 0, the second half q = 1, each warp on 2
// input rows x 16 output channels.
template <typename T, int WN>
__global__ void __launch_bounds__(Cfg<T, WN>::THREADS,
                                  Cfg<T, WN>::BLOCKS_PER_SM)
convt4s2_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ part, int N, int Ci, int Co, int H,
                   int W, int tiles_w, int per, bool xvec, bool wvec) {
  using S = Cfg<T, WN>;
  constexpr int KC = S::KC, SUB = UNIT / KC;  // chunks a unit
  constexpr int BN = S::BN, STAGES = S::STAGES;
  extern __shared__ __align__(16) char smem[];
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z % N, split = blockIdx.z / N;
  const int chunks = (Ci + KC - 1) / KC;
  const int k0 = split * per * SUB, k1 = min(chunks, k0 + per * SUB);
  const T* xn = x + (size_t)n * Ci * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = warp / (WARPS_M * WN);
  const int warp_m = warp % WARPS_M, warp_n = (warp / WARPS_M) % WN;
  const int ncol = min(BN, Co - co0);
  // this warp's m16 fragments above row H and n8 fragments below Co
  const int live_m = min(2, max(0, H - oy0 - warp_m * 2));
  const int live_n = min(2, max(0, (ncol - warp_n * 16 + 7) / 8));
  char* raw = smem + 2 * S::MMA;

  float acc[2][2][2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][mt][nt][j] = 0.f;

  // Chunk k's raw stage is k % STAGES, its MMA layout (k - k0) % 2.  The
  // thread index goes through an empty asm so that the copy's addressing is
  // recomputed for each chunk instead of held in registers across the loop.
  auto copy = [&](int k) {
    if (k >= k1) return;
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    char* st = raw + (k % STAGES) * S::BYTES;
    copy_halo<T, S::THREADS>(xn, k * KC, Ci, H, W, oy0, ox0, st, xvec, tid);
    copy_weights<T, WN>(w, k * KC, min(KC, Ci - k * KC), Co, co0,
                        st + S::X_BYTES, wvec, tid);
  };
  auto transpose = [&](int k) {
    const char* st = raw + (k % STAGES) * S::BYTES;
    char* mma = smem + ((k - k0) & 1) * S::MMA;
    transpose_halo<T>(st, mma, S::MMA_BYTES);
    transpose_weights<T, WN>(st + S::X_BYTES, mma, min(KC, Ci - k * KC),
                             ncol);
  };
  for (int k = k0; k < k0 + STAGES - 1; ++k) {
    copy(k);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  transpose(k0);
  copy(k0 + STAGES - 1);
  cp_async_commit();
  // Chunk k: wait for chunk k + 1's raw stage; the barrier publishes chunk
  // k's MMA layout, and keeps chunk k + 1's transpose from overwriting the
  // layout chunk k - 1's MMAs read and chunk k + STAGES's copy from
  // overwriting the stage chunk k's transpose read.  Then that transpose
  // and copy, and chunk k's MMAs: one barrier a chunk, and one warp's
  // transposes overlap another's MMAs.
  for (int k = k0; k < k1; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (k + 1 < k1) transpose(k + 1);
    copy(k + STAGES);
    cp_async_commit();
    if (live_m > 0 && live_n > 0) {
      const char* mma = smem + ((k - k0) & 1) * S::MMA;
      const char* ws = mma + XS_BYTES + warp_n * 16 * WT_PITCH;
      if (q == 0)
        chunk_mma<T, WN, 0>(mma, ws, warp_m, live_m, live_n, acc);
      else
        chunk_mma<T, WN, 1>(mma, ws, warp_m, live_m, live_n, acc);
    }
  }

  // accumulator element j of fragment (r, mt, nt): input row
  // oy0 + warp_m * 2 + mt, column ox0 + lane/4 + 8 (j/2), output channel
  // co0 + warp_n * 16 + nt * 8 + 2 (lane%4) + j%2, output pixel
  // (2m + q, 2n + r)
  const int Wo = 2 * W;
  const size_t oplane = (size_t)2 * H * Wo;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= live_m) continue;
    const int m = oy0 + warp_m * 2 + mt;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= live_n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + warp_n * 16 + nt * 8 + 2 * (lane & 3) + (j & 1);
        const int nn = ox0 + (lane >> 2) + 8 * (j >> 1);
        if (co >= Co || nn >= W) continue;
        const size_t i = ((size_t)n * Co + co) * oplane +
                         (size_t)(2 * m + q) * Wo + 2 * nn;
        const float v0 = acc[0][mt][nt][j], v1 = acc[1][mt][nt][j];
        if (part != nullptr) {
          store2(part + (size_t)split * N * Co * oplane + i, v0, v1);
        } else {
          const float b = bias != nullptr ? bias[co] : 0.f;
          store2(y + i, v0 + b, v1 + b);
        }
      }
    }
  }
}

// y[i] = the splits' partials added in split order from 0, plus the bias
template <typename T>
__global__ void convt4s2_reduce_kernel(const float* __restrict__ part,
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

// The CUDA-core loop for problems too small for the tensor-core pipeline
// (use_cuda_cores): one input-channel unit over at most 16 input positions
// an image, G1's first transposed conv (8 -> 256 on 4^2).  There the
// pipeline's fill (copy, transposes, two barriers) and a 3xTF32 chain on
// 8 SMs outlast this loop's whole run.  A block owns a TMH x TMW tile of
// input positions for CC_COB output channels; the tile plus a 1-px halo
// and the weights of CIB input channels, laid out [ci][ky*4+kx][co], are
// staged in shared memory as f32; KS thread groups split each staged
// chunk's channels and sum their 4*CC_COB accumulators through shared
// memory.
constexpr int TMH = 8;           // input rows a block
constexpr int TMW = 8;           // input columns a block
constexpr int POS = TMH * TMW;   // positions a block
constexpr int KS = 4;            // thread groups splitting the channels
constexpr int CIB = 8;           // input channels staged a step
constexpr int CC_COB = 8;        // output channels a block

__host__ __device__ constexpr bool use_cuda_cores(int Ci, int H, int W) {
  return Ci <= UNIT && H * W <= 16;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// output phase q (0/1), tap a (0/1) -> kernel index along that axis
__device__ __forceinline__ int ktap(int q, int a) {
  return q == 0 ? (a == 0 ? 1 : 3) : (a == 0 ? 0 : 2);
}
// ... and the staged-tile offset (halo row/col 0 is x index m-1)
__device__ __forceinline__ int koff(int q, int a) {
  return q == 0 ? (a == 0 ? 1 : 0) : (a == 0 ? 2 : 1);
}

template <typename T>
__global__ void __launch_bounds__(POS * KS)
convt4s2_cc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ y,
                int Ci, int Co, int H, int W, int tiles_w) {
  __shared__ float xs[CIB][TMH + 2][TMW + 2];
  __shared__ __align__(16) float ws[CIB][16][CC_COB];
  __shared__ float red[KS][4 * CC_COB][POS];

  const int tid = threadIdx.x;
  const int pos = tid % POS;
  const int g = tid / POS;
  const int tx = pos % TMW;
  const int ty = pos / TMW;
  const int m0 = (blockIdx.x / tiles_w) * TMH;
  const int n0 = (blockIdx.x % tiles_w) * TMW;
  const int co0 = blockIdx.y * CC_COB;
  const int nb = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* xn = x + (size_t)nb * Ci * plane;

  float acc[2][2][CC_COB];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < CC_COB; ++j) acc[q][r][j] = 0.f;

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
    for (int i = tid; i < CIB * 16 * CC_COB; i += POS * KS) {
      const int c = i / (16 * CC_COB);
      const int rr = i % (16 * CC_COB);
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
              for (int j4 = 0; j4 < CC_COB / 4; ++j4) {
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
  // the 4*CC_COB outputs of its position
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < CC_COB; ++j) red[g][(q * 2 + r) * CC_COB + j][pos] = acc[q][r][j];
  __syncthreads();

  const int m = m0 + ty;
  const int n = n0 + tx;
  if (m < H && n < W) {
    const int Wo = 2 * W;
    const size_t oplane = (size_t)(2 * H) * Wo;
    T* yn = y + (size_t)nb * Co * oplane;
    for (int k = g; k < 4 * CC_COB; k += KS) {
      const int j = k % CC_COB;
      const int q = k / (2 * CC_COB);
      const int r = (k / CC_COB) % 2;
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

template <typename T>
int launch_cuda_cores(const void* x, const void* w, const float* bias,
                      void* y, int N, int Ci, int Co, int H, int W,
                      cudaStream_t stream) {
  const int tiles_w = (W + TMW - 1) / TMW;
  const int tiles_h = (H + TMH - 1) / TMH;
  const dim3 grid(tiles_w * tiles_h, (Co + CC_COB - 1) / CC_COB, N);
  convt4s2_cc_kernel<T><<<grid, POS * KS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), Ci, Co, H, W, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// ops/kernels/convt4s2.py tc_plan describes the same split: while the
// grid is below one round of resident blocks (one wide or two narrow
// blocks an SM), the input channels are split over blocks to fill it.
struct Plan {
  int wn, bn, tiles_w, tiles, co_tiles, per, splits;
};

Plan plan(int N, int Ci, int Co, int H, int W) {
  Plan p;
  p.wn = warp_cols(Co);
  p.bn = 16 * p.wn;
  p.tiles_w = (W + TW - 1) / TW;
  p.tiles = p.tiles_w * ((H + TH - 1) / TH);
  p.co_tiles = (Co + p.bn - 1) / p.bn;
  const int units = (Ci + UNIT - 1) / UNIT;
  const int blocks = p.tiles * p.co_tiles * N;
  const int resident = SMS * (3 - p.wn);  // blocks of one round
  const int want = max(1, min(units, resident / blocks));
  p.per = (units + want - 1) / want;      // units a split
  p.splits = (units + p.per - 1) / p.per;
  return p;
}

template <typename T, int WN>
int launch(const Plan& p, const void* x, const void* w, const float* bias,
           void* y, float* part, int N, int Ci, int Co, int H, int W,
           cudaStream_t stream) {
  using S = Cfg<T, WN>;
  const cudaError_t e = cudaFuncSetAttribute(
      convt4s2_tc_kernel<T, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool xvec = W % Elem<T>::XV == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(p.tiles, p.co_tiles, N * p.splits);
  convt4s2_tc_kernel<T, WN><<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), p.splits > 1 ? part : nullptr, N, Ci, Co, H, W,
      p.tiles_w, p.per, xvec, wvec);
  if (p.splits > 1) {
    const int oplane = 4 * H * W;
    const int count = N * Co * oplane;
    convt4s2_reduce_kernel<T><<<(count + 255) / 256, 256, 0, stream>>>(
        part, bias, static_cast<T*>(y), count, Co, oplane, p.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Plan& p, const void* x, const void* w, const float* bias,
           void* y, float* part, int N, int Ci, int Co, int H, int W,
           cudaStream_t stream) {
  if (use_cuda_cores(Ci, H, W))
    return launch_cuda_cores<T>(x, w, bias, y, N, Ci, Co, H, W, stream);
  return p.wn == 2
             ? launch<T, 2>(p, x, w, bias, y, part, N, Ci, Co, H, W, stream)
             : launch<T, 1>(p, x, w, bias, y, part, N, Ci, Co, H, W, stream);
}

}  // namespace

// Floats of scratch that convt4s2_fwd needs for these shapes (0: none).
extern "C" long long convt4s2_workspace(int N, int Ci, int Co, int H, int W) {
  const Plan p = plan(N, Ci, Co, H, W);
  return p.splits > 1 ? (long long)p.splits * N * Co * 4 * H * W : 0;
}

// 1 when these shapes take the tensor-core kernel, 0 when they take the
// CUDA-core loop (the same for both dtypes).
extern "C" int convt4s2_tensor_cores(int N, int Ci, int Co, int H, int W) {
  return use_cuda_cores(Ci, H, W) ? 0 : 1;
}

// The splits of the input channels the launch takes for these shapes (the
// same for both dtypes).
extern "C" int convt4s2_splits(int N, int Ci, int Co, int H, int W) {
  return plan(N, Ci, Co, H, W).splits;
}

// x (N, Ci, H, W) -> y (N, Co, 2H, 2W).  dtype: 0 = float32, 1 = bfloat16
// (x, w and y share it); bias is float32 or null; partials:
// convt4s2_workspace floats (null when that is 0).  Returns
// cudaGetLastError() after the launches.
extern "C" int convt4s2_fwd(const void* x, const void* w, const float* bias,
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
