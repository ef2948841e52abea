"""Convolution dispatch (NCHW, torch weight layouts).

Counterpart of supervised_gan_tpu/ops/conv.py `conv2d` (:66) and
`conv_transpose2d` (:142).  The shapes a hand-written kernel serves go to
its autograd Function (ops/kernels/functions.py), whose backward runs on
kernels too; every other shape (the PatchGAN heads' k4 s1 p1 convs) goes to
torch.nn.functional, where the JAX package used plain XLA.  The convolution
runs in x's dtype (the caller casts for --compute_dtype) with float32
accumulation; the weight is cast to x's dtype on the way in, so its
gradient lands in the parameter's float32.

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
"""

import os

import torch.nn.functional as F

from .kernels import Conv3x3, Conv3x3InAct, Conv4s2, ConvT4s2

# the JAX package's pixel minimum, read as it reads it: below it the region
# does not run
CONV3_MIN_PIXELS = int(os.environ.get('SGAN_TPU_CONV3_MIN_PIXELS', 512 * 512))


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


def conv2d(x, w, b=None, stride=1, padding=0):
    """x (N, Ci, H, W), w (Co, Ci, kh, kw): torch.nn.Conv2d semantics."""
    w = w.to(x.dtype)
    k = tuple(w.shape[2:])
    if k == (3, 3) and stride == 1 and padding == 1:
        return Conv3x3.apply(x, w, _bias(b, x))
    if (k == (4, 4) and stride == 2 and padding == 1
            and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
        return Conv4s2.apply(x, w, _bias(b, x))
    return F.conv2d(x, w, _bias(b, x), stride, padding)


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=0):
    """x (N, Ci, H, W), w (Ci, Co, kh, kw): torch.nn.ConvTranspose2d
    semantics."""
    w = w.to(x.dtype)
    if (tuple(w.shape[2:]) == (4, 4) and stride == 2 and padding == 1
            and output_padding == 0):
        return ConvT4s2.apply(x, w, _bias(b, x))
    return F.conv_transpose2d(x, w, _bias(b, x), stride, padding,
                              output_padding)


def conv3x3_in_supported(x, w):
    """True where the JAX package runs the fused region: batch 1, a 3x3
    weight with C_in == C_out == C, C a divisor of 128 (P = 128 / C pixels
    packed per 128 lanes there) or a multiple of 128 (P = 1), W divisible by
    P with W / P and H multiples of 8, H >= 16, and H * W at least
    CONV3_MIN_PIXELS.  x (N, C, H, W), w (Co, Ci, kh, kw)."""
    if x.dim() != 4 or w.dim() != 4:
        return False
    n, c, h, wd = x.shape
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
    return Conv3x3InAct.apply(x, w.to(x.dtype), _bias(b, x), eps, slope)
