// What the kernels that run conv3x3_mma.cuh's `accumulate` share after it
// (conv3x3.cu, conv3x3_in.cu): where each accumulator element lies in the
// output, the store in the output's type, and the host's tests for
// 16-byte copies.

#pragma once

#include "conv3x3_mma.cuh"

namespace conv3x3_epilogue {

struct Pos {
  int oy, co, ox;
};

// Element j of fragment (mt, nt) of a lane's accumulator (acc[mt][nt][j]):
// each m16 fragment is one output row of 16 pixels, each n8 fragment 8
// output channels, and a lane holds channels 2 (lane & 3) + (j & 1) of
// pixels lane / 4 + 8 (j / 2).
__device__ __forceinline__ Pos frag_pos(int oy0, int co0, int ox0, int warp_m,
                                        int warp_n, int lane, int mt, int nt,
                                        int j) {
  return {oy0 + warp_m * 2 + mt,
          co0 + warp_n * 32 + nt * 8 + 2 * (lane & 3) + (j & 1),
          ox0 + (lane >> 2) + 8 * (j >> 1)};
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16-byte copies: the weights when each output channel's run of Ci * 9
// values starts 16-byte aligned, the halo when every row does
template <typename T>
bool weights_vec(const void* w, int Ci) {
  return (Ci * 9 * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}
template <typename T>
bool halo_vec(const void* x, int W) {
  return W % conv3x3_mma::Elem<T>::XV == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace conv3x3_epilogue
