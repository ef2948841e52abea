// Weight gradient of the 3x3 stride-1 pad-1 convolution, NCHW, for Hopper
// (sm_90a):
//
//   dW[co, ci, ky, kx] = sum over n, y, x of g[n, co, y, x] * x[n, ci, y+ky-1, x+kx-1]
//
// in float32, for any N, Ci, Co, H, W; x and g float32 or bfloat16.
//
// Replaces: supervised_gan_tpu/ops/pallas/conv3x3.py `_dw_kernel` (:226,
// through `_conv3x3_dw` :305) and `_dwT_kernel` (:339, through
// `_conv3x3_dw_v2` :420).  Both are MXU dots that contract over the pixels,
// with shifted copies of the staged x block made once per block so that
// every tap's operand is an aligned slice, and both carry the pixel sum in
// the output block from one grid step to the next (the TPU's sequential
// grid).  Hopper has no sequential grid: here the pixel sum is split over
// blocks and folded afterwards.
//
// What bounds it on the H100: arithmetic.  It does the forward's FLOPs,
// 2*9*Ci*Co per pixel (19.3 GFLOP at the 512^2 64->64 site) against one
// read of x and g: 0.117 ms at 512^2 as 3xTF32 on the tensor cores, 0.020
// ms in bf16, where the bytes (x and g, 67 MB) weigh as much.
//
// Design: an implicit GEMM on mma.sync with M = Co, N = 9 taps x Ci and
// K = the pixels.  g is [co][pixel] and each tap's shifted x is
// [ci][pixel], both K-contiguous as NCHW holds them: mma's row-major A and
// `.col` B, with no channel transpose.
//   * A block owns 64 output channels x CIB input channels x 9 taps and a
//     contiguous range of TR x TW = 4 x 32 pixel tiles (the K chunks).
//     8 warps, 2 along Co x 4 along Ci; a warp holds MT = 2 m16 fragments
//     (32 output channels) x 9 n8 fragments (its 8 input channels at the 9
//     taps), 72 accumulators a thread, so CIB = 32.  bf16 fits two blocks
//     an SM (128 registers a thread), so one block's copies overlap the
//     other's MMAs; f32, with twice the staged bytes, one.
//   * Staging: cp.async copies each tile's g rows and x halo rows (TR + 2
//     rows of TW + 2 XV values) as they lie in device memory, in 16-byte
//     vectors where rows allow (zero-fill outside the image), one tile
//     ahead of the MMAs (two stages); a thread keeps one vector position
//     and walks the channels, so a copy costs a few instructions.  The
//     kx = 1 operand is read from the staged halo as it is; kx = 0 and 2
//     move a row by one value, off ldmatrix's 16-byte rows, so a pass in
//     shared memory makes the two shifted copies of the tile once (the
//     Pallas kernels' shifted buffers); a ky shift is a row offset.  Rows
//     of input channels are padded to an odd number of 16-byte units, so
//     ldmatrix reads 8 channels' rows without bank conflicts.
//   * Arithmetic: bf16 m16n8k16 with f32 accumulators (bf16 products are
//     exact in f32).  f32 as 3xTF32 m16n8k8: each fragment is split in
//     registers into hi = rna_tf32(v) and lo = rna_tf32(v - hi) once per
//     k-step (an A fragment serves 9 taps, a B fragment MT output-channel
//     fragments), and lo*hi, hi*lo, hi*hi accumulate in that order (small
//     terms first), each round over all of the warp's accumulators so that
//     no MMA waits on the one before it.
//   * Narrow shapes: output channels past Co and input channels past Ci
//     are not staged, m16 fragments wholly past Co (a warp's count of live
//     fragments is a template constant, so no MMA sits behind a branch)
//     and warps whose input channels lie past Ci skip their MMAs; their
//     accumulators are never stored.  Where Co leaves the second row of
//     warps nothing (the 64->1 head), it takes half of each tile's
//     k-steps for the first row's channels instead.
//   * Parallelism comes from splitting K: the grid is (Co/64) x (Ci/CIB) x
//     splits, with splits chosen to fill the 132 SMs (Resident blocks
//     each), at most one split a tile.  Each block stages its sums through shared
//     memory and stores them as whole rows: into dW when it is the only
//     split, else into the workspace, where dw_reduce_kernel adds the
//     splits up in a fixed order.  No atomics: two runs agree bitwise.
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

constexpr int THREADS = 256;
constexpr int TR = 4;              // pixel rows of a tile
constexpr int TW = 32;             // pixel columns of a tile
constexpr int HALO_R = TR + 2;     // staged x rows of a tile
constexpr int BM = 64;             // output channels a block
constexpr int MT = 2;              // m16 fragments a warp
constexpr int WARPS_CO = 2;        // warps along the output channels
constexpr int WARPS_CI = 4;        // warps along the input channels
constexpr int CIB = 8 * WARPS_CI;  // input channels a block
constexpr int STAGES = 2;          // tiles staged at once
constexpr int SMS = 132;
static_assert(WARPS_CO == 2 && WARPS_CI * 64 == THREADS &&
                  WARPS_CO * MT * 16 == BM,
              "two rows of warps tile the block's output channels");

// blocks an SM holds (shared memory allows two in bf16, one in f32)
template <typename T> struct Resident;
template <> struct Resident<__nv_bfloat16> { static constexpr int BLOCKS = 2; };
template <> struct Resident<float> { static constexpr int BLOCKS = 1; };

// Sizes in bytes unless named otherwise.
template <typename T>
struct Tile {
  static constexpr int ES = sizeof(T);
  static constexpr int XV = 16 / ES;           // values a 16-byte vector
  static constexpr int KS = 32 / ES;           // pixels an mma k-step
  static constexpr int RAW_W = TW + 2 * XV;    // values a staged x row
  static constexpr int ROWB = RAW_W * ES;
  static constexpr int CIP0 = HALO_R * ROWB;
  static constexpr int CIP = CIP0 + ((CIP0 / 16) % 2 ? 0 : 16);
  static constexpr int XBYTES = CIB * CIP;     // one tile's x
  static constexpr int GP = TR * TW * ES + 16; // between output channels
  static constexpr int STAGE = XBYTES + BM * GP;
  static constexpr int SROWB = TW * ES;        // a shifted row
  static constexpr int SCIP0 = HALO_R * SROWB;
  static constexpr int SCIP = SCIP0 + ((SCIP0 / 16) % 2 ? 0 : 16);
  static constexpr int SX = CIB * SCIP;        // one shifted copy
  static constexpr int KSTEPS = TR * TW / KS;
  static constexpr int OUTP = CIB * 9 + 4;     // floats an output channel
  static constexpr int PIPE = STAGES * STAGE + 2 * SX;
  static constexpr int EPI = BM * OUTP * 4;
  static constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
};

__device__ __forceinline__ void tile_origin(int t, int tiles_img,
                                            int tiles_w, int& n, int& y0,
                                            int& x0) {
  n = t / tiles_img;
  const int r = t - n * tiles_img;
  y0 = (r / tiles_w) * TR;
  x0 = (r % tiles_w) * TW;
}

// Copy tile (n, y0, x0) as it lies in device memory into a stage: the x
// halo [ci][HALO_R][RAW_W] from column x0 - XV (zero outside the image),
// then g [co][TR * TW] (zero outside the image).  Channels past Ci or Co
// are not copied.  vec: every row is whole 16-byte vectors; a thread then
// keeps one vector position (row, column) and walks the channels, so each
// copy costs a few instructions.
template <typename T>
__device__ __forceinline__ void copy_tile(const T* __restrict__ x,
                                          const T* __restrict__ g, int n,
                                          int y0, int x0, int ci0, int co0,
                                          int Ci, int Co, int H, int W,
                                          char* st, bool vec) {
  using L = Tile<T>;
  constexpr int ES = L::ES, XV = L::XV;
  const int kc = min(CIB, Ci - ci0);
  const int ncol = min(BM, Co - co0);
  const T* xn = x + ((size_t)n * Ci + ci0) * H * W;
  const T* gn = g + ((size_t)n * Co + co0) * H * W;
  char* gs = st + L::XBYTES;
  if (vec) {
    const size_t plane = (size_t)H * W;
    constexpr int NV = L::RAW_W / XV, XR = HALO_R * NV, XG = THREADS / XR;
    if (threadIdx.x < XG * XR) {
      const int rv = threadIdx.x % XR, c0 = threadIdx.x / XR;
      const int v = rv % NV, hr = rv / NV;
      const int gy = y0 + hr - 1, gx = x0 - XV + v * XV;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = ok ? xn + c0 * plane + (size_t)gy * W + gx : x;
      const size_t step = ok ? XG * plane : 0;
      char* dst = st + c0 * L::CIP + hr * L::ROWB + v * 16;
      for (int c = c0; c < kc; c += XG) {
        cp_async16(dst, src, ok);
        src += step;
        dst += XG * L::CIP;
      }
    }
    constexpr int GV = TW / XV, GR = TR * GV, GG = THREADS / GR;
    static_assert(THREADS % GR == 0, "every thread takes g vectors");
    const int rv = threadIdx.x % GR, c0 = threadIdx.x / GR;
    const int v = rv % GV, r = rv / GV;
    const int gy = y0 + r, gx = x0 + v * XV;
    const bool ok = gy < H && gx < W;
    const T* src = ok ? gn + c0 * plane + (size_t)gy * W + gx : g;
    const size_t step = ok ? GG * plane : 0;
    char* dst = gs + c0 * L::GP + (r * TW + v * XV) * ES;
    for (int co = c0; co < ncol; co += GG) {
      cp_async16(dst, src, ok);
      src += step;
      dst += GG * L::GP;
    }
  } else {
    constexpr int NX = TW + 2;  // halo columns x0 - 1 .. x0 + TW
    for (int i = threadIdx.x; i < kc * HALO_R * NX; i += THREADS) {
      const int q = i % NX, r = i / NX, hr = r % HALO_R, c = r / HALO_R;
      const int gy = y0 + hr - 1, gx = x0 + q - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = ok ? xn + ((size_t)c * H + gy) * W + gx : x;
      char* dst = st + c * L::CIP + hr * L::ROWB + (XV - 1 + q) * ES;
      if constexpr (ES == 4) {
        cp_async4(dst, src, ok);
      } else {
        *reinterpret_cast<unsigned short*>(dst) =
            ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
      }
    }
    for (int i = threadIdx.x; i < ncol * TR * TW; i += THREADS) {
      const int q = i % TW, r = (i / TW) % TR, co = i / (TW * TR);
      const int gy = y0 + r, gx = x0 + q;
      const bool ok = gy < H && gx < W;
      const T* src = ok ? gn + ((size_t)co * H + gy) * W + gx : g;
      char* dst = gs + co * L::GP + (r * TW + q) * ES;
      if constexpr (ES == 4) {
        cp_async4(dst, src, ok);
      } else {
        *reinterpret_cast<unsigned short*>(dst) =
            ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
      }
    }
  }
}

// The kx = 0 and kx = 2 operands of a staged tile, [ci][HALO_R][TW] each:
// copy 0 at column c holds the staged row's column XV + c - 1, copy 1 its
// column XV + c + 1, so every tap's rows start 16-byte aligned.  A thread
// makes one 16-byte vector of each copy from the aligned vector at XV + c
// and the words on either side of it, at one (row, column) position of
// every SG-th channel.
template <typename T>
__device__ __forceinline__ void shift_tile(const char* st, char* shift,
                                           int kc) {
  using L = Tile<T>;
  constexpr int NV = TW / L::XV, SR = HALO_R * NV, SG = THREADS / SR;
  if (threadIdx.x >= SG * SR) return;
  const int rv = threadIdx.x % SR, c0 = threadIdx.x / SR;
  const int v = rv % NV, hr = rv / NV;
  const char* s = st + c0 * L::CIP + hr * L::ROWB + v * 16 + L::XV * L::ES;
  char* d = shift + c0 * L::SCIP + hr * L::SROWB + v * 16;
  for (int c = c0; c < kc; c += SG, s += SG * L::CIP, d += SG * L::SCIP) {
    const uint4 cur = *reinterpret_cast<const uint4*>(s);
    const uint32_t prev = *reinterpret_cast<const uint32_t*>(s - 4);
    const uint32_t next = *reinterpret_cast<const uint32_t*>(s + 16);
    uint4 lo, hi;
    if constexpr (L::ES == 2) {   // one bf16 value: half a word
      lo = make_uint4(__byte_perm(prev, cur.x, 0x5432),
                      __byte_perm(cur.x, cur.y, 0x5432),
                      __byte_perm(cur.y, cur.z, 0x5432),
                      __byte_perm(cur.z, cur.w, 0x5432));
      hi = make_uint4(__byte_perm(cur.x, cur.y, 0x5432),
                      __byte_perm(cur.y, cur.z, 0x5432),
                      __byte_perm(cur.z, cur.w, 0x5432),
                      __byte_perm(cur.w, next, 0x5432));
    } else {                      // one f32 value: a word
      lo = make_uint4(prev, cur.x, cur.y, cur.z);
      hi = make_uint4(cur.y, cur.z, cur.w, next);
    }
    *reinterpret_cast<uint4*>(d) = lo;
    *reinterpret_cast<uint4*>(d + L::SX) = hi;
  }
}

__device__ __forceinline__ void split4(const uint32_t (&v)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) split_tf32(v[j], hi[j], lo[j]);
}

// One warp's MMAs over one staged tile.  acc[mt][tap][j]: the m16n8
// accumulator layout, output channel warp_co * MT * 16 + mt * 16 + lane / 4
// + 8 * (j / 2), input channel warp_ci * 8 + 2 * (lane % 4) + j % 2 of the
// block, at tap (ky, kx), summed over the tile's k-steps ks0 .. ks0 + KN - 1.
// LM: this warp's m16 fragments that hold an output channel below Co (the
// first LM of its MT).
template <typename T, int LM, int KN>
__device__ __forceinline__ void tile_mma(const char* st, const char* shift,
                                         int warp_co, int warp_ci, int ks0,
                                         float (&acc)[MT][9][4]) {
  using L = Tile<T>;
  const int lane = threadIdx.x & 31;
  // A: matrices (channels 0-7 | 8-15) x (k-step half 0 | 1), a lane a row
  const char* ga = st + L::XBYTES +
                   (warp_co * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                       L::GP + (lane >> 4) * 16;
  // B: matrices (tap a: k half 0 | 1) then (tap b: k half 0 | 1), a lane an
  // input channel's row
  const int b_ci = warp_ci * 8 + (lane & 7), b_half = ((lane >> 3) & 1) * 16;
  const bool second = lane >> 4;
  const char* b0 = shift + b_ci * L::SCIP + b_half;
  const char* b1 = st + b_ci * L::CIP + b_half + L::XV * L::ES;
  const char* b2 = b0 + L::SX;
#pragma unroll 2
  for (int i = 0; i < KN; ++i) {
    const int ks = ks0 + i;
    const int r = ks * L::KS / TW;
    const int cb = (ks * L::KS % TW) * L::ES;
    uint32_t a[LM][4];
#pragma unroll
    for (int mt = 0; mt < LM; ++mt)
      ldmatrix_x4(a[mt], ga + mt * 16 * L::GP + ks * 32);
    uint32_t ah[LM][4], al[LM][4];
    if constexpr (L::ES == 4) {
#pragma unroll
      for (int mt = 0; mt < LM; ++mt) split4(a[mt], ah[mt], al[mt]);
    }
    // f32: the B fragments' hi and lo parts of all 9 taps, so that each
    // round of products below runs LM x 9 independent MMAs
    [[maybe_unused]] uint32_t bh[9][2], bl[9][2];
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const int ta = 2 * p, tb = p < 4 ? 2 * p + 1 : 8;
      const int t = second ? tb : ta;
      const int ky = t / 3, kx = t - 3 * ky;
      const char* row = kx == 1 ? b1 + (r + ky) * L::ROWB
                                : (kx == 0 ? b0 : b2) + (r + ky) * L::SROWB;
      uint32_t q[4];
      ldmatrix_x4(q, row + cb);
      if constexpr (L::ES == 2) {
#pragma unroll
        for (int mt = 0; mt < LM; ++mt) {
          mma_bf16(acc[mt][ta], a[mt], q[0], q[1]);
          if (p < 4) mma_bf16(acc[mt][tb], a[mt], q[2], q[3]);
        }
      } else {
        uint32_t qh[4], ql[4];
        split4(q, qh, ql);
        bh[ta][0] = qh[0]; bh[ta][1] = qh[1];
        bl[ta][0] = ql[0]; bl[ta][1] = ql[1];
        if (p < 4) {
          bh[tb][0] = qh[2]; bh[tb][1] = qh[3];
          bl[tb][0] = ql[2]; bl[tb][1] = ql[3];
        }
      }
    }
    if constexpr (L::ES == 4) {
#pragma unroll
      for (int mt = 0; mt < LM; ++mt)
#pragma unroll
        for (int k = 0; k < 9; ++k)
          mma_tf32(acc[mt][k], al[mt], bh[k][0], bh[k][1]);
#pragma unroll
      for (int mt = 0; mt < LM; ++mt)
#pragma unroll
        for (int k = 0; k < 9; ++k)
          mma_tf32(acc[mt][k], ah[mt], bl[k][0], bl[k][1]);
#pragma unroll
      for (int mt = 0; mt < LM; ++mt)
#pragma unroll
        for (int k = 0; k < 9; ++k)
          mma_tf32(acc[mt][k], ah[mt], bh[k][0], bh[k][1]);
    }
  }
}

// tile_mma with the warp's count of live m16 fragments and of k-steps as
// constants, so that no MMA sits behind a branch.
template <typename T, int KN, int LM = MT>
__device__ __forceinline__ void tile_mma_live(const char* st,
                                              const char* shift, int warp_co,
                                              int warp_ci, int live_m,
                                              int ks0,
                                              float (&acc)[MT][9][4]) {
  if constexpr (LM == 1) {
    tile_mma<T, 1, KN>(st, shift, warp_co, warp_ci, ks0, acc);
  } else if (live_m == LM) {
    tile_mma<T, LM, KN>(st, shift, warp_co, warp_ci, ks0, acc);
  } else {
    tile_mma_live<T, KN, LM - 1>(st, shift, warp_co, warp_ci, live_m, ks0,
                                 acc);
  }
}

// Pass 1.  Block (co tile, ci tile, split s) sums tiles [t_beg, t_end) of
// the N * tiles_img pixel tiles into dw when there is one split, else into
// part[s][co][ci][tap] for dw_reduce_kernel.
//
// Tile t: wait for its stage, make its shifted copies, start the copy of
// tile t + STAGES - 1 into tile t - 1's stage (whose MMAs the barrier
// before the shift has seen finish), then the MMAs.  The barrier after the
// shift publishes the copies.
template <typename T>
__global__ void __launch_bounds__(THREADS, Resident<T>::BLOCKS)
dw_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
             float* __restrict__ part, float* __restrict__ dw, int Ci,
             int Co, int H, int W, int tiles_w, int tiles_img,
             int tiles_total, int splits, bool vec) {
  using L = Tile<T>;
  extern __shared__ __align__(16) char smem[];
  const int co0 = blockIdx.x * BM, ci0 = blockIdx.y * CIB;
  const int s = blockIdx.z;
  const int t_beg = (int)((long long)tiles_total * s / splits);
  const int t_end = (int)((long long)tiles_total * (s + 1) / splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_co = warp % WARPS_CO, warp_ci = warp / WARPS_CO;
  // Where every output channel left lies in the first row of warps (the
  // 64->1 head), the second row takes the same channels and the second
  // half of each tile's k-steps; the epilogue adds the two rows' sums.
  const bool narrow = Co - co0 <= MT * 16;
  const int a_co = narrow ? 0 : warp_co;  // the warp's output channels
  const int ks0 = narrow ? warp_co * (L::KSTEPS / 2) : 0;
  const int live_m = min(MT, max(0, (Co - co0 - a_co * MT * 16 + 15) / 16));
  const bool live = live_m > 0 && ci0 + warp_ci * 8 < Ci;
  const int kc = min(CIB, Ci - ci0);
  char* shift = smem + STAGES * L::STAGE;

  float acc[MT][9][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][k][j] = 0.f;

  int n, y0, x0;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (t_beg + k < t_end) {
      tile_origin(t_beg + k, tiles_img, tiles_w, n, y0, x0);
      copy_tile<T>(x, g, n, y0, x0, ci0, co0, Ci, Co, H, W,
                   smem + k * L::STAGE, vec);
    }
    cp_async_commit();
  }
  int stage = 0;  // tile t's stage
  for (int t = t_beg; t < t_end; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const char* st = smem + stage * L::STAGE;
    shift_tile<T>(st, shift, kc);
    const int next = t + STAGES - 1;
    if (next < t_end) {
      tile_origin(next, tiles_img, tiles_w, n, y0, x0);
      copy_tile<T>(x, g, n, y0, x0, ci0, co0, Ci, Co, H, W,
                   smem + (stage == 0 ? STAGES - 1 : stage - 1) * L::STAGE,
                   vec);
    }
    cp_async_commit();
    __syncthreads();
    if (live && narrow)
      tile_mma_live<T, L::KSTEPS / 2>(st, shift, a_co, warp_ci, live_m, ks0,
                                      acc);
    else if (live)
      tile_mma_live<T, L::KSTEPS>(st, shift, a_co, warp_ci, live_m, 0, acc);
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }

  // the block's sums through shared memory, [co][ci * 9 + tap], then out as
  // whole rows
  __syncthreads();
  float* out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = warp_co * MT * 16 + mt * 16 + (lane >> 2) + 8 * (j >> 1);
        const int ci = warp_ci * 8 + 2 * (lane & 3) + (j & 1);
        out[co * L::OUTP + ci * 9 + k] = acc[mt][k][j];
      }
  __syncthreads();
  const int ncol = min(BM, Co - co0), run = kc * 9;
  const float* src = out + warp * L::OUTP;
  const int other = narrow ? MT * 16 * L::OUTP : 0;  // the second row's sums
  float* dst = (splits == 1 ? dw : part + (size_t)s * Co * Ci * 9) +
               ((size_t)(co0 + warp) * Ci + ci0) * 9;
  for (int co = warp; co < ncol; co += THREADS / 32) {
    for (int e = lane; e < run; e += 32)
      dst[e] = narrow ? src[e] + src[other + e] : src[e];
    src += (THREADS / 32) * L::OUTP;
    dst += (size_t)(THREADS / 32) * Ci * 9;
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
  int tiles_w, tiles_img, tiles_total, splits;
  dim3 grid;
};

template <typename T>
Plan plan(int N, int Ci, int Co, int H, int W) {
  Plan p;
  p.tiles_w = (W + TW - 1) / TW;
  p.tiles_img = p.tiles_w * ((H + TR - 1) / TR);
  p.tiles_total = N * p.tiles_img;
  const int co_tiles = (Co + BM - 1) / BM;
  const int ci_tiles = (Ci + CIB - 1) / CIB;
  const int base = co_tiles * ci_tiles;
  const int resident = SMS * Resident<T>::BLOCKS;
  int splits = (resident + base - 1) / base;
  p.splits = max(1, min(splits, p.tiles_total));
  p.grid = dim3(co_tiles, ci_tiles, p.splits);
  return p;
}

template <typename T>
int launch(const void* x, const void* g, float* part, float* dw, int N,
           int Ci, int Co, int H, int W, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      dw_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<T>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = plan<T>(N, Ci, Co, H, W);
  const bool vec = W % Tile<T>::XV == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  dw_tc_kernel<T><<<p.grid, THREADS, Tile<T>::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, dw, Ci, Co,
      H, W, p.tiles_w, p.tiles_img, p.tiles_total, p.splits, vec);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return static_cast<int>(le);
  if (p.splits > 1) {
    const int count = Co * Ci * 9;
    dw_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
        part, dw, count, p.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that conv3x3_dw needs for these shapes (either dtype):
// one dW a split.
extern "C" long long conv3x3_dw_workspace(int N, int Ci, int Co, int H, int W) {
  const int s32 = plan<float>(N, Ci, Co, H, W).splits;
  const int s16 = plan<__nv_bfloat16>(N, Ci, Co, H, W).splits;
  return (long long)max(s32, s16) * Co * Ci * 9;
}

// The splits of the pixel sum the launch takes for these shapes and dtype
// (0 = float32, 1 = bfloat16).
extern "C" int conv3x3_dw_splits(int N, int Ci, int Co, int H, int W,
                                 int dtype) {
  return dtype == 0 ? plan<float>(N, Ci, Co, H, W).splits
                    : plan<__nv_bfloat16>(N, Ci, Co, H, W).splits;
}

// x (N, Ci, H, W), g (N, Co, H, W), both of `dtype` (0 = float32,
// 1 = bfloat16); dw (Co, Ci, 3, 3) float32; partials: conv3x3_dw_workspace
// floats.  Returns cudaGetLastError() after both launches.
extern "C" int conv3x3_dw(const void* x, const void* g, float* partials,
                          float* dw, int N, int Ci, int Co, int H, int W,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, partials, dw, N, Ci, Co, H, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, partials, dw, N, Ci, Co, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
