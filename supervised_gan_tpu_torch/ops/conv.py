"""Convolution dispatch (NCHW, torch weight layouts).

Counterpart of supervised_gan_tpu/ops/conv.py `conv2d` (:66) and
`conv_transpose2d` (:142).  The shapes a hand-written kernel serves go to
its autograd Function (ops/kernels/functions.py), whose backward runs on
kernels too; every other shape (the PatchGAN heads' k4 s1 p1 convs) goes to
torch.nn.functional, where the JAX package used plain XLA.  The convolution
runs in x's dtype (the caller casts for --compute_dtype) with float32
accumulation; the weight is cast to x's dtype on the way in, so its
gradient lands in the parameter's float32.
"""

import torch.nn.functional as F

from .kernels import Conv3x3, Conv4s2, ConvT4s2


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
