"""3x3 stride-1 pad-1 convolution plus bias with the InstanceNorm statistics
of its output: the hand-written CUDA kernel (csrc/conv3x3_in.cu) and its
plain PyTorch version.

Replaces supervised_gan_tpu/ops/pallas/conv3x3_in.py `_kernel` (:65),
reached through `_fwd_impl` (:114): the statistics come from the float32
accumulator with the bias added, before y is cast to x's dtype, and are
folded as :157-162 there do: mean = sum / HW, var = max(E[y^2] - mean^2, 0),
rstd = 1 / sqrt(var + eps).  The kernel takes any N, C_in, C_out, H and W;
where the port uses it is decided by ops.conv.conv3x3_in_supported.

Design: conv3x3's tensor-core implicit GEMM (csrc/conv3x3_mma.cuh, one block
an 8 x 16 pixel tile of 64 output channels, over every input channel), with
the statistics in its epilogue: each block writes one (sum, sum of squares)
a channel of its tile into a float32 workspace of ``workspace_floats``
floats, laid out [n][tile][channel], and a second kernel folds each plane's
tiles in a fixed order, every quotient, product and difference rounded
apart.  Bound on the H100: the convolution's operations in float32 (3xTF32
on the tensor cores), its bytes in bfloat16 (see the source note).

Layout: x (N, Ci, H, W), w (Co, Ci, 3, 3) as torch.nn.Conv2d, b (Co,) or
None; y (N, Co, H, W) in x's dtype (float32 or bfloat16); mean and rstd
(N, Co) float32.
"""

import ctypes

import torch

from . import build
from .common import (DTYPE_CODES, bias_arg, check_cuda_inputs, on_cpu,
                     raise_on_error, stream_arg)
from .conv3x3 import conv3x3_plain_f32

_SIGNATURES = {
    'conv3x3_in_workspace': ([ctypes.c_int] * 4, ctypes.c_longlong),
    'conv3x3_in_fwd': ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                       ctypes.c_int),
}


# the kernel's pixel tile (TH x TW of csrc/conv3x3_mma.cuh)
TILE_H, TILE_W = 8, 16


def pixel_tiles(h, w):
    """The kernel's pixel tiles of one image: its first grid dimension."""
    return -(-h // TILE_H) * -(-w // TILE_W)


def workspace_floats(n, co, h, w):
    """conv3x3_in_workspace: a (sum, sum of squares) for each image, pixel
    tile and output channel."""
    return 2 * n * co * pixel_tiles(h, w)


def conv3x3_in_stats_plain(x, w, b=None, eps=1e-5):
    """The same function as the kernel: conv3x3_plain's float32 accumulator
    (bias added), its per-(n, c) statistics, then the cast to x's dtype."""
    y = conv3x3_plain_f32(x, w, b)
    hw = y.shape[2] * y.shape[3]
    mean = y.sum(dim=(2, 3)) / hw
    var = ((y * y).sum(dim=(2, 3)) / hw - mean * mean).clamp_min(0.0)
    return y.to(x.dtype), mean, torch.rsqrt(var + eps)


def conv3x3_in_stats(x, w, b=None, eps=1e-5):
    """(y, mean, rstd).  CPU tensors take conv3x3_in_stats_plain; CUDA
    tensors launch the kernel or raise."""
    if on_cpu(x, w, b):
        return conv3x3_in_stats_plain(x, w, b, eps)
    check_cuda_inputs('conv3x3_in_stats', x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) \
            or w.shape[1] != x.shape[1] or x.numel() == 0:
        raise ValueError('conv3x3_in_stats: x %s and w %s are not a non-empty '
                         '(N, Ci, H, W) and (Co, Ci, 3, 3)'
                         % (tuple(x.shape), tuple(w.shape)))
    n, ci, h, wd = x.shape
    co = w.shape[0]
    bf, bptr = bias_arg('conv3x3_in_stats', b, co, x.device)
    lib = build.load('conv3x3_in', _SIGNATURES)
    partials = torch.empty((lib.conv3x3_in_workspace(n, co, h, wd),),
                           dtype=torch.float32, device=x.device)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, n, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_in_fwd(x.data_ptr(), w.data_ptr(), bptr,
                                 y.data_ptr(), partials.data_ptr(),
                                 stats.data_ptr(), n, ci, co, h, wd,
                                 float(eps), DTYPE_CODES[x.dtype],
                                 stream_arg(x))
        conv3x3_in_stats.launches += 1
    raise_on_error('conv3x3_in_stats', err)
    return y, stats[0], stats[1]


conv3x3_in_stats.launches = 0
