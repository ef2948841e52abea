// The tensor-core main loop of the 3x3 stride-1 pad-1 convolution, NCHW, as
// an implicit GEMM with mma.sync (conv3x3.cu adds the epilogue).
//
//   * GEMM view: M = a TH x TW = 8 x 16 tile of output pixels (each m16
//     fragment is one output row), N = BN = 64 output channels, K = the 9
//     taps x Ci, taken KC input channels (one mma depth) at a time: 16 for
//     bf16 (m16n8k16), 8 for f32 (m16n8k8 TF32).  8 warps, 4 along M x 2
//     along N; a warp owns 32 pixels x 32 channels (2 x 4 fragments).
//   * Staging: a chunk is copied as it lies in device memory (NCHW halo
//     rows, OIHW weights) into one of STAGES raw stages with cp.async, in
//     16-byte vectors where rows allow (zero-fill outside the image), so
//     the next chunk is in flight while this one is multiplied; no
//     registers hold prefetched data.  Each chunk is then transposed in
//     shared memory into the MMA layout: the
//     (TH+2) x (TW+2) halo tile channels-last, [halo pixel][channel], one
//     pixel's 32-byte chunk a row with rows 48 bytes apart, so ldmatrix
//     builds the A fragment at every tap shift from 16-byte-aligned rows
//     without bank conflicts (an NCHW tile shifted by a tap puts an 8-pixel
//     row off 16-byte alignment); the weights [co][tap][channel], output
//     channels 304 bytes apart, for B.  cp.async cannot transpose, and the
//     weights keep their OIHW layout in device memory: no host-side op
//     reorders them.
//   * f32 runs 3xTF32: each operand is split into hi = rna_tf32(v) and
//     lo = rna_tf32(v - hi) once, in the transpose (hi and lo get a copy of
//     the MMA layout each), and a fragment pair accumulates lo*hi, hi*lo,
//     hi*hi (small terms first); the dropped lo*lo is ~2^-22 of a product,
//     so the result keeps f32 accuracy (plain TF32 keeps ~3 digits).  bf16
//     products are exact in f32.  Accumulation is f32 in both.
//   * Any N, Ci, Co, H, W: pixels outside the image and channels past Ci
//     are zero when staged; output channels past Co are not staged (their
//     accumulator columns are never stored) and n8 fragments wholly past Co
//     skip their MMAs.  Summation order is fixed by the shape alone, so two
//     runs agree bitwise.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace conv3x3_mma {

constexpr int TH = 8;                    // output rows per block
constexpr int TW = 16;                   // output columns per block (m16)
constexpr int BN = 64;                   // output channels per block
constexpr int WARPS_M = 4;               // warps along the pixels
constexpr int WARPS_N = 2;               // warps along the output channels
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int HALO = HALO_H * HALO_W;    // halo pixels of one tile
constexpr int ROW = 32;                  // bytes of one chunk row (KC values)
constexpr int XS_PITCH = ROW + 16;       // bytes between halo pixels
constexpr int WS_PITCH = 9 * ROW + 16;   // bytes between output channels
constexpr int XS_BYTES = HALO * XS_PITCH;
constexpr int MMA_BYTES = XS_BYTES + BN * WS_PITCH;  // the MMA layout
constexpr int RW_PITCH = 9 * ROW;        // one output channel's raw weights
constexpr int STAGES = 2;                // raw stages: one chunk in flight

// Per element type: KC channels a chunk (one mma depth of 32 bytes), the
// copies of the MMA layout (f32 keeps its TF32 hi and lo parts apart), and
// a raw halo row of RAW_W values from x = ox0 - XV, whole 16-byte vectors
// of XV values that cover the TW + 2 halo columns.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int KC = 8, COPIES = 2, XV = 4, RAW_W = TW + 2 * XV;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int KC = 16, COPIES = 1, XV = 8, RAW_W = TW + 2 * XV;
};

// one raw stage: KC channels of HALO_H halo rows, then BN output channels'
// weights
template <typename T>
__host__ __device__ constexpr int raw_x_bytes() {
  return HALO_H * Elem<T>::RAW_W * ROW;
}
template <typename T>
__host__ __device__ constexpr int raw_bytes() {
  return raw_x_bytes<T>() + BN * RW_PITCH;
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return Elem<T>::COPIES * MMA_BYTES + STAGES * raw_bytes<T>();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t rna_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = rna_tf32(v), lo = rna_tf32(v - hi), for the f32 bits in v
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(v);
  hi = rna_tf32(f);
  lo = rna_tf32(f - __uint_as_float(hi));
}

// A fragments of one warp at halo shift (ky, kx) from a channels-last halo
// tile: its two m16 fragments, output rows warp_m * 2 + mt.
__device__ __forceinline__ void a_fragments(const char* xs, int ky, int kx,
                                            int warp_m, uint32_t (&a)[2][4]) {
  const int lane = threadIdx.x & 31;
  // matrices (pixels 0-7 | 8-15) x (chunk half 0 | 1), one lane a row
  const int a_px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = warp_m * 2 + mt + ky;
    ldmatrix_x4(a[mt], xs + (r * HALO_W + a_px + kx) * XS_PITCH + a_half * 16);
  }
}

// B fragments of 16 output channels (two n8 fragments, b[0] for channels
// 0-7) from weights laid out [co][..][channel]: ws points at output
// channel 0's 32-byte chunk row, output channels `pitch` bytes apart.
__device__ __forceinline__ void b_fragments(const char* ws, int pitch,
                                            uint32_t (&b)[2][2]) {
  const int lane = threadIdx.x & 31;
  // matrices (channel half 0 | 1) x (output channels 0-7 | 8-15)
  const int b_co = (lane & 7) + (lane >> 4) * 8;
  const int b_half = (lane >> 3) & 1;
  uint32_t q[4];
  ldmatrix_x4(q, ws + b_co * pitch + b_half * 16);
  b[0][0] = q[0];
  b[0][1] = q[1];
  b[1][0] = q[2];
  b[1][1] = q[3];
}

// A and B fragments of one warp for one tap from an MMA layout.
__device__ __forceinline__ void fragments(const char* xs, const char* ws,
                                          int tap, int warp_m, int warp_n,
                                          uint32_t (&a)[2][4],
                                          uint32_t (&b)[4][2]) {
  a_fragments(xs, tap / 3, tap % 3, warp_m, a);
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t q[2][2];
    b_fragments(ws + (warp_n * 32 + np * 16) * WS_PITCH + tap * ROW,
                WS_PITCH, q);
    b[2 * np][0] = q[0][0];
    b[2 * np][1] = q[0][1];
    b[2 * np + 1][0] = q[1][0];
    b[2 * np + 1][1] = q[1][1];
  }
}

// One warp's MMAs for one tap of one staged chunk.  live: this warp's n8
// fragments that hold an output channel below Co (0 to 4).  f32: the hi
// parts at mma, the lo parts at mma + MMA_BYTES.
template <typename T>
__device__ __forceinline__ void tap_mma(const char* mma, int tap, int warp_m,
                                        int warp_n, int live,
                                        float (&acc)[2][4][4]) {
  uint32_t a[2][4], b[4][2];
  fragments(mma, mma + XS_BYTES, tap, warp_m, warp_n, a, b);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < live) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    }
  } else {
    uint32_t al[2][4], bl[4][2];
    fragments(mma + MMA_BYTES, mma + MMA_BYTES + XS_BYTES, tap, warp_m,
              warp_n, al, bl);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < live) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], al[mt], b[nt][0], b[nt][1]);
          mma_tf32(acc[mt][nt], a[mt], bl[nt][0], bl[nt][1]);
          mma_tf32(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid (src-size 0,
// src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy the halo of one chunk (input channels c0 .. c0+KC-1) as it lies in
// device memory into a raw stage: rows [c][hy][RAW_W] from x = ox0 - XV
// (zero outside the image and past Ci).  xvec: rows are whole 16-byte
// vectors (W a multiple of XV), so the halo goes in vectors; otherwise
// single values: cp.async for f32, plain loads for bf16.  tid: this
// thread's index among the block's NT threads.
template <typename T, int NT = THREADS>
__device__ __forceinline__ void copy_halo(const T* __restrict__ xn, int c0,
                                          int Ci, int H, int W, int oy0,
                                          int ox0, char* raw, bool xvec,
                                          int tid) {
  constexpr int KC = Elem<T>::KC, ES = sizeof(T);
  constexpr int XV = Elem<T>::XV, RAW_W = Elem<T>::RAW_W;
  const int kc = min(KC, Ci - c0);
  const size_t plane = (size_t)H * W;
  const T* xc = xn + (size_t)c0 * plane;
  if (xvec) {
    constexpr int NV = RAW_W / XV;  // vectors a row
    for (int i = tid; i < KC * HALO_H * NV; i += NT) {
      const int v = i % NV, r = i / NV, hy = r % HALO_H, c = r / HALO_H;
      const int gy = oy0 + hy - 1, gx = ox0 - XV + v * XV;
      const bool ok = c < kc && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(raw + ((c * HALO_H + hy) * RAW_W + v * XV) * ES,
                 ok ? xc + c * plane + (size_t)gy * W + gx : xn, ok);
    }
  } else {
    for (int i = tid; i < KC * HALO; i += NT) {
      const int r = i % HALO, c = i / HALO;
      const int hy = r / HALO_W, hx = r % HALO_W;
      const int gy = oy0 + hy - 1, gx = ox0 + hx - 1;
      const bool ok = c < kc && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = ok ? xc + c * plane + (size_t)gy * W + gx : xn;
      char* dst = raw + ((c * HALO_H + hy) * RAW_W + hx - 1 + XV) * ES;
      if constexpr (ES == 4) {
        cp_async4(dst, src, ok);
      } else {
        *reinterpret_cast<unsigned short*>(dst) =
            ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
      }
    }
  }
}

// Copy one chunk (input channels c0 .. c0+KC-1) as it lies in device memory
// into a raw stage: the halo (copy_halo), then the weights [co][KC * 9] as
// OIHW holds them (only co < Co, ci < Ci; the transpose masks the rest).
// wvec: every output channel's run of weights goes in 16-byte vectors.
template <typename T>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ xn,
                                           const T* __restrict__ w, int c0,
                                           int Ci, int Co, int H, int W,
                                           int oy0, int ox0, int co0,
                                           char* raw, bool wvec, bool xvec) {
  constexpr int KC = Elem<T>::KC, ES = sizeof(T);
  const int kc = min(KC, Ci - c0);
  copy_halo<T>(xn, c0, Ci, H, W, oy0, ox0, raw, xvec, threadIdx.x);
  char* rw = raw + raw_x_bytes<T>();
  const int ncol = min(BN, Co - co0);
  const T* wc = w + ((size_t)co0 * Ci + c0) * 9;
  if (wvec) {
    const int nv = kc * 9 * ES / 16;
    for (int i = threadIdx.x; i < ncol * nv; i += THREADS) {
      const int co = i / nv, v = i - co * nv;
      cp_async16(rw + co * RW_PITCH + v * 16,
                 reinterpret_cast<const char*>(wc + (size_t)co * Ci * 9) +
                     v * 16, true);
    }
  } else {
    const int n = kc * 9;
    for (int i = threadIdx.x; i < ncol * n; i += THREADS) {
      const int co = i / n, e = i - co * n;
      const T* src = wc + (size_t)co * Ci * 9 + e;
      if constexpr (ES == 4) {
        cp_async4(rw + co * RW_PITCH + e * ES, src, true);
      } else {
        *reinterpret_cast<unsigned short*>(rw + co * RW_PITCH + e * ES) =
            *reinterpret_cast<const unsigned short*>(src);
      }
    }
  }
}

// The halo of a raw stage -> [halo pixel][channel] at mma (thread t < HALO
// takes pixel t); f32 values are split, hi to mma, lo to mma + lo.
template <typename T>
__device__ __forceinline__ void transpose_halo(const char* raw, char* mma,
                                               int lo) {
  constexpr int ES = sizeof(T);
  constexpr int RAW_W = Elem<T>::RAW_W, XV = Elem<T>::XV;
  constexpr int CH = HALO_H * RAW_W;  // elements between raw halo channels
  if (threadIdx.x < HALO) {
    const int hy = threadIdx.x / HALO_W, hx = threadIdx.x % HALO_W;
    uint4* d = reinterpret_cast<uint4*>(mma + threadIdx.x * XS_PITCH);
    if constexpr (ES == 2) {
      const unsigned short* s =
          reinterpret_cast<const unsigned short*>(raw) + hy * RAW_W + hx - 1 +
          XV;
      uint32_t v[8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        v[p] = s[2 * p * CH] | (uint32_t(s[(2 * p + 1) * CH]) << 16);
      d[0] = make_uint4(v[0], v[1], v[2], v[3]);
      d[1] = make_uint4(v[4], v[5], v[6], v[7]);
    } else {
      const uint32_t* s =
          reinterpret_cast<const uint32_t*>(raw) + hy * RAW_W + hx - 1 + XV;
      uint4* dl = reinterpret_cast<uint4*>(mma + lo + threadIdx.x * XS_PITCH);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // four channels at a time
        uint32_t hv[4], lv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(s[(4 * h + c) * CH], hv[c], lv[c]);
        d[h] = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        dl[h] = make_uint4(lv[0], lv[1], lv[2], lv[3]);
      }
    }
  }
}

// Raw stage -> the MMA layout: each halo pixel's KC channels as one 32-byte
// row (thread t < HALO takes pixel t), and the weights of each of the
// block's ncol output channels below Co as [tap][channel] (a thread takes
// one channel pair of one output channel over the 9 taps), zero past Ci
// (kc channels here).  Rows past Co are left as they are: they only reach
// accumulator columns that are never stored.  f32 values are split here,
// once: hi to mma, lo to mma + MMA_BYTES.
template <typename T>
__device__ __forceinline__ void transpose_chunk(const char* raw, char* mma,
                                                int kc, int ncol) {
  constexpr int KC = Elem<T>::KC, ES = sizeof(T), PAIRS = KC / 2;
  transpose_halo<T>(raw, mma, MMA_BYTES);
  for (int i = threadIdx.x; i < ncol * PAIRS; i += THREADS) {
    const int co = i / PAIRS, p = i % PAIRS;
    const bool ok0 = 2 * p < kc, ok1 = 2 * p + 1 < kc;
    const char* s = raw + raw_x_bytes<T>() + co * RW_PITCH + 2 * p * 9 * ES;
    char* d = mma + XS_BYTES + co * WS_PITCH + p * 2 * ES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if constexpr (ES == 2) {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(s);
        const uint32_t lo = ok0 ? s16[tap] : 0u;
        const uint32_t hi = ok1 ? s16[9 + tap] : 0u;
        *reinterpret_cast<uint32_t*>(d + tap * ROW) = lo | (hi << 16);
      } else {
        const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
        uint32_t h0, l0, h1, l1;
        split_tf32(ok0 ? s32[tap] : 0u, h0, l0);
        split_tf32(ok1 ? s32[9 + tap] : 0u, h1, l1);
        *reinterpret_cast<uint2*>(d + tap * ROW) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(d + MMA_BYTES + tap * ROW) =
            make_uint2(l0, l1);
      }
    }
  }
}

// acc[mt][nt][j]: the f32 sum over ky, kx and the input channels of chunks
// k0 .. k1-1 of x * w for this lane's fragment elements (the m16n8
// accumulator layout: output row oy0 + warp_m * 2 + mt, column
// ox0 + lane / 4 + 8 * (j / 2), channel co0 + warp_n * 32 + nt * 8 +
// 2 * (lane % 4) + j % 2).  xn is one image (Ci, H, W); smem holds
// smem_bytes<T>().  Every thread of the block must call it (it
// synchronizes the block).
//
// Chunk k: wait for its raw stage, transpose it into the MMA buffer, start
// the copy of chunk k + STAGES - 1 into the stage chunk k - 1 used, then
// the MMAs.  The barrier before the transpose keeps it from overwriting
// the MMA buffer while chunk k - 1's MMAs read it (and the raw stage it
// refills while chunk k - 1's transpose reads it); the one after it
// publishes the buffer.
template <typename T>
__device__ __forceinline__ void accumulate(const T* __restrict__ xn,
                                           const T* __restrict__ w, int Ci,
                                           int Co, int H, int W, int oy0,
                                           int ox0, int co0, int k0, int k1,
                                           char* smem, bool wvec, bool xvec,
                                           float (&acc)[2][4][4]) {
  constexpr int KC = Elem<T>::KC;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int live = min(4, max(0, (Co - co0 - warp_n * 32 + 7) / 8));
  const int ncol = min(BN, Co - co0);
  char* raw = smem + Elem<T>::COPIES * MMA_BYTES;

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int k = k0; k < k0 + STAGES - 1; ++k) {
    if (k < k1)
      copy_chunk<T>(xn, w, k * KC, Ci, Co, H, W, oy0, ox0, co0,
                    raw + (k % STAGES) * raw_bytes<T>(), wvec, xvec);
    cp_async_commit();
  }
  for (int k = k0; k < k1; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    transpose_chunk<T>(raw + (k % STAGES) * raw_bytes<T>(), smem,
                       min(KC, Ci - k * KC), ncol);
    const int next = k + STAGES - 1;
    if (next < k1)
      copy_chunk<T>(xn, w, next * KC, Ci, Co, H, W, oy0, ox0, co0,
                    raw + (next % STAGES) * raw_bytes<T>(), wvec, xvec);
    cp_async_commit();
    __syncthreads();
    if (live > 0) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        tap_mma<T>(smem, tap, warp_m, warp_n, live, acc);
    }
  }
}

}  // namespace conv3x3_mma
