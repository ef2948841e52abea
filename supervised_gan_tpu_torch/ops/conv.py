"""Convolution dispatch (NCHW, torch weight layouts).

Counterpart of supervised_gan_tpu/ops/conv.py `conv2d` (:66) and
`conv_transpose2d` (:142).  The shapes a hand-written kernel serves go to
its autograd Function (ops/kernels/functions.py), whose backward runs on
kernels too; every other shape (the PatchGAN heads' k4 s1 p1 convs) goes to
torch.nn.functional, where the JAX package used plain XLA.  With the
kernels switched off (``--no_pallas``, ops/kernels `set_kernels_enabled`)
every shape goes to torch.nn.functional, as the JAX package's --no_pallas
sends every conv to XLA.  The convolution runs in x's dtype (the caller
casts for --compute_dtype) with float32 accumulation; the weight is cast to
x's dtype on the way in, so its gradient lands in the parameter's float32.

`conv3x3_in_act` is the fused conv3x3 + InstanceNorm (+ activation) region
of supervised_gan_tpu/ops/pallas/conv3x3_in.py, and `conv3x3_in_supported`
the gate the JAX package puts in front of it (ops/pallas/conv3x3.py:76-104
`supported`, in NCHW terms).  The CUDA kernel takes any shape, but the port
fuses exactly where the JAX package does and no wider: at a fused site the
conv bias is an input of the region and gets a gradient, so the set of
parameters Adam moves depends on where the region runs.  The region's only
switch is SGAN_TPU_CONV3_IN (nn/core.py); the JAX package's SGAN_TPU_CONV3=0,
which turns off its conv3x3 kernel and the region with it, has no
counterpart here.

Under --spatial_mesh (parallel/spatial.py) a convolution whose output is
row-sharded runs on the rank's halo'd rows: it fetches the input rows its
output rows read (``need``: their window from the global shapes, so
consecutive partitions need not nest), runs the same dispatch on them and
crops; the kernels run unchanged, each padding the fetched window as it
pads a whole image, and the crop drops the rows that padding touched.  A
k4 s1 p1 head or any shape no kernel serves runs torch.nn.functional on the
window with no row padding.  Every gate reads the global shape.  A
replicated output is the whole-image dispatch on the replicated input.
The fused region's gate reads the global height too, so every rank takes
the region where one process does; over split rows it runs on the rank's
window [lo - 1, hi + 1) through Conv3x3InActRows: the row-range entry's
statistics of the rank's own rows, summed over the sp group, mean and rstd
over the global H x W.
"""

import os

import torch.nn.functional as F

from ..parallel import spatial
from .kernels import (Conv3x3, Conv3x3InAct, Conv3x3InActRows, Conv4s2,
                      ConvT4s2, kernels_enabled)

# the JAX package's pixel minimum, read as it reads it: below it the region
# does not run
CONV3_MIN_PIXELS = int(os.environ.get('SGAN_TPU_CONV3_MIN_PIXELS', 512 * 512))


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


def _conv2d_kernel(x, w, stride, padding, h):
    """The kernel a conv of global height ``h`` takes: 'conv3x3', 'conv4s2'
    or None (torch.nn.functional)."""
    k = tuple(w.shape[2:])
    if kernels_enabled():
        if k == (3, 3) and stride == 1 and padding == 1:
            return 'conv3x3'
        if (k == (4, 4) and stride == 2 and padding == 1
                and h % 2 == 0 and x.shape[3] % 2 == 0):
            return 'conv4s2'
    return None


def _conv2d_whole(x, w, b, stride, padding, kernel):
    if kernel == 'conv3x3':
        return Conv3x3.apply(x, w, _bias(b, x))
    if kernel == 'conv4s2':
        return Conv4s2.apply(x, w, _bias(b, x))
    return F.conv2d(x, w, _bias(b, x), stride, padding)


def conv2d(x, w, b=None, stride=1, padding=0):
    """x (N, Ci, H, W), w (Co, Ci, kh, kw): torch.nn.Conv2d semantics."""
    w = w.to(x.dtype)
    h = spatial.height(x)
    kernel = _conv2d_kernel(x, w, stride, padding, h)
    if not spatial.active():
        return _conv2d_whole(x, w, b, stride, padding, kernel)
    k = w.shape[2]
    h_out = (h + 2 * padding - k) // stride + 1
    if kernel is None:
        # the window [lo s - p, (hi - 1) s - p + k), no row padding
        def need(lo, hi):
            return lo * stride - padding, (hi - 1) * stride - padding + k

        def run(rows, a, lo, hi):
            return F.conv2d(rows, w, _bias(b, x), stride, (0, padding))
    else:
        # the kernel pads the window by one row: output row j of the window
        # [a, b) is global row a + j (conv3x3) or a / 2 + j (conv4s2)
        s_ = 1 if kernel == 'conv3x3' else 2

        def need(lo, hi):
            return (lo - 1, hi + 1) if s_ == 1 else (2 * lo - 2, 2 * hi + 2)

        def run(rows, a, lo, hi):
            y = _conv2d_whole(rows, w, b, stride, padding, kernel)
            return y.narrow(-2, lo - a // s_, hi - lo)
    return spatial.map_rows(
        x, h_out, need, run,
        lambda xw: _conv2d_whole(xw, w, b, stride, padding, kernel))


def _convt_whole(x, w, b, stride, padding, output_padding, kernel):
    if kernel:
        return ConvT4s2.apply(x, w, _bias(b, x))
    return F.conv_transpose2d(x, w, _bias(b, x), stride, padding,
                              output_padding)


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=0):
    """x (N, Ci, H, W), w (Ci, Co, kh, kw): torch.nn.ConvTranspose2d
    semantics."""
    w = w.to(x.dtype)
    kernel = (kernels_enabled() and tuple(w.shape[2:]) == (4, 4)
              and stride == 2 and padding == 1 and output_padding == 0)
    if not spatial.active():
        return _convt_whole(x, w, b, stride, padding, output_padding, kernel)
    k = w.shape[2]
    h = spatial.height(x)
    h_out = (h - 1) * stride - 2 * padding + k + output_padding
    if kernel:
        # output row j of the window [a, b) is global row 2 a + j
        def need(lo, hi):
            return (lo - 1) // 2, hi // 2 + 1

        def run(rows, a, lo, hi):
            y = ConvT4s2.apply(rows, w, _bias(b, x))
            return y.narrow(-2, lo - 2 * a, hi - lo)
    else:
        # output row o reads input rows (o + p - k + 1) / s .. (o + p) / s;
        # with no row padding output row j of the window is a s - p + j
        def need(lo, hi):
            return (-((k - 1 - lo - padding) // stride),
                    (hi - 1 + padding) // stride + 1)

        def run(rows, a, lo, hi):
            y = F.conv_transpose2d(rows, w, _bias(b, x), stride,
                                   (0, padding), (0, output_padding))
            return y.narrow(-2, lo - (a * stride - padding), hi - lo)
    return spatial.map_rows(
        x, h_out, need, run,
        lambda xw: _convt_whole(xw, w, b, stride, padding, output_padding,
                                kernel))


def conv3x3_in_supported(x, w):
    """True where the JAX package runs the fused region: batch 1, a 3x3
    weight with C_in == C_out == C, C a divisor of 128 (P = 128 / C pixels
    packed per 128 lanes there) or a multiple of 128 (P = 1), W divisible by
    P with W / P and H multiples of 8, H >= 16, and H * W at least
    CONV3_MIN_PIXELS, H the global height (--spatial_mesh: every rank
    decides as one process does).  x (N, C, H, W), w (Co, Ci, kh, kw)."""
    if x.dim() != 4 or w.dim() != 4:
        return False
    n, c, _, wd = x.shape
    h = spatial.height(x)
    co, ci, kh, kw = w.shape
    if (kh, kw) != (3, 3) or ci != c or co != c or n != 1:
        return False
    if c % 128 == 0:
        p = 1
    elif 128 % c == 0:
        p = 128 // c
    else:
        return False
    if wd % p or h % 8 or (wd // p) % 8 or h < 16:
        return False
    return h * wd >= CONV3_MIN_PIXELS


def conv3x3_in_act(x, w, b=None, eps=1e-5, slope=None):
    """act(InstanceNorm(conv3x3(x, w, b))), differentiable, in x's dtype
    (slope None: no activation; 0.0: ReLU; else LeakyReLU(slope))."""
    w = w.to(x.dtype)
    if not spatial.active():
        return Conv3x3InAct.apply(x, w, _bias(b, x), eps, slope)
    h = spatial.height(x)
    count = h * x.shape[3]

    def run(rows, a, lo, hi):
        return Conv3x3InActRows.apply(rows, w, _bias(b, x), eps, slope,
                                      count, spatial.sp_sum_)

    return spatial.map_rows(
        x, h, lambda lo, hi: (lo - 1, hi + 1), run,
        lambda xw: Conv3x3InAct.apply(xw, w, _bias(b, x), eps, slope))
