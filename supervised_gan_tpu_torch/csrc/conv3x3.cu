// 3x3 stride-1 pad-1 convolution plus optional bias, NCHW, for Hopper (sm_90a).
//
// Replaces: supervised_gan_tpu/ops/pallas/conv3x3.py `_kernel` (:143), reached
// through `conv3x3_same` (:497).  The Pallas kernel packs P = 128/C pixels into
// the 128 TPU lanes and multiplies banded block weights on the MXU; that
// packing exists to fill 128-lane vregs and is not carried over.
//
// What bounds it on the H100: at Ci = Co = 64 (the 512^2 trunk) a pixel
// does 2*9*64*64 FLOPs against 2*64 values of activation traffic.  f32 runs
// on the tensor cores as 3xTF32 (three TF32 products a MAC at 495 TFLOP/s):
// bound by operations, 0.117 ms at 512^2.  bf16 runs at 989 TFLOP/s and is
// bound by bytes there (0.020 ms).
//
// Design: the implicit GEMM of conv3x3_mma.cuh (mma.sync, m16n8k16 bf16 or
// 3xTF32 m16n8k8; cp.async copies one chunk of input channels ahead,
// transposed in shared memory into channels-last tiles for ldmatrix), then
// the bias in f32 and the output in the input's type.  It replaced a
// CUDA-core loop (f32 FMAs, bf16 widened to f32 as staged); conv3x3_in.cu
// runs the same main loop with the InstanceNorm statistics in its epilogue.
//   * The epilogue stores straight from the accumulator fragments: a store
//     instruction writes 8 consecutive pixels of 4 output channels, whole
//     32-byte sectors in f32 and half sectors in bf16.
//   * Every shape takes this kernel, narrow Ci and Co included: output
//     channels past Co are neither staged nor multiplied.
//   * Small grids (8^2 to 128^2 at the CRN's widths: 1 to 128 blocks, each
//     walking all of Ci) split the input-channel chunks over the blocks of
//     a cluster and fold the partial sums through distributed shared memory
//     in a fixed order, since the wrapper hands the kernel no scratch.
//   * wgmma, TMA, warp specialisation and persistent blocks are later work.

#include <cooperative_groups.h>

#include "conv3x3_epilogue.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace conv3x3_mma;
using namespace conv3x3_epilogue;

// The blocks a launch keeps resident (132 SMs, two blocks each) and the
// largest portable cluster.
constexpr int RESIDENT = 2 * 132;
constexpr int MAX_SPLIT = 8;

// grid: (pixel tiles x splits, output-channel tiles, N).  With splits > 1
// the blocks of one tile form a cluster, each multiplies its share of the
// input-channel chunks, and the cluster folds the partial sums through
// distributed shared memory in rank order (each rank adds up and stores a
// 1/splits share of the tile): no scratch in device memory and no atomics,
// so two runs agree bitwise.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y, int Ci,
                  int Co, int H, int W, int tiles_w, int splits, bool wvec,
                  bool xvec) {
  extern __shared__ __align__(16) char smem[];
  const int tile = blockIdx.x / splits, part = blockIdx.x % splits;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const int chunks = (Ci + Elem<T>::KC - 1) / Elem<T>::KC;
  const int per = (chunks + splits - 1) / splits;
  const int k0 = min(chunks, part * per), k1 = min(chunks, k0 + per);

  float acc[2][4][4];
  accumulate<T>(x + (size_t)n * Ci * plane, w, Ci, Co, H, W, oy0, ox0, co0,
                k0, k1, smem, wvec, xvec, acc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  T* yn = y + (size_t)n * Co * plane;
  // element f = (mt * 4 + nt) * 4 + j of this lane's accumulator fragments
  auto out = [&](int f, float v) {
    const Pos p = frag_pos(oy0, co0, ox0, warp_m, warp_n, lane, f >> 4,
                           (f >> 2) & 3, f & 3);
    if (p.oy < H && p.co < Co && p.ox < W)
      store(yn + (size_t)p.co * plane + (size_t)p.oy * W + p.ox,
            v + (bias != nullptr ? bias[p.co] : 0.f));
  };
  if (splits == 1) {
#pragma unroll
    for (int f = 0; f < 32; ++f) out(f, acc[f >> 4][(f >> 2) & 3][f & 3]);
    return;
  }
  // red[f][thread]: this block's partial sums (the main loop's buffers are
  // free once every warp has passed its last MMA)
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 32; ++f)
    red[f * THREADS + threadIdx.x] = acc[f >> 4][(f >> 2) & 3][f & 3];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int f = part; f < 32; f += splits) {
    float v = 0.f;
    for (int q = 0; q < splits; ++q)
      v += cluster.map_shared_rank(red, q)[f * THREADS + threadIdx.x];
    out(f, v);
  }
  cluster.sync();  // keep every block's partials alive until all are read
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, void* y, int N,
           int Ci, int Co, int H, int W, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int co_tiles = (Co + BN - 1) / BN;
  const int chunks = (Ci + Elem<T>::KC - 1) / Elem<T>::KC;
  // split the chunks over a cluster while the grid fills under one round of
  // resident blocks
  const int blocks = tiles_w * tiles_h * co_tiles * N;
  const int splits = max(1, min(min(MAX_SPLIT, chunks), RESIDENT / blocks));
  const bool wvec = weights_vec<T>(w, Ci), xvec = halo_vec<T>(x, W);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_w * tiles_h * splits, co_tiles, N);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<T>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, conv3x3_tc_kernel<T>, static_cast<const T*>(x),
      static_cast<const T*>(w), bias, static_cast<T*>(y), Ci, Co, H, W,
      tiles_w, splits, wvec, xvec);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it); bias is float32 or
// null.  Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_fwd(const void* x, const void* w, const float* bias,
                           void* y, int N, int Ci, int Co, int H, int W,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, bias, y, N, Ci, Co, H, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, y, N, Ci, Co, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
