"""Convolution dispatch (NCHW, torch weight layouts).

Counterpart of supervised_gan_tpu/ops/conv.py `conv2d` (:66) and
`conv_transpose2d` (:142).  The shapes a hand-written kernel serves go to it;
every other shape goes to torch.nn.functional, where the JAX package used
plain XLA.  The convolution runs in x's dtype (the caller casts for
--compute_dtype) with float32 accumulation.
"""

import torch.nn.functional as F

from .kernels import conv3x3, convt4s2


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


def conv2d(x, w, b=None, stride=1, padding=0):
    """x (N, Ci, H, W), w (Co, Ci, kh, kw): torch.nn.Conv2d semantics."""
    w = w.to(x.dtype)
    if tuple(w.shape[2:]) == (3, 3) and stride == 1 and padding == 1:
        return conv3x3(x, w, _bias(b, x))
    return F.conv2d(x, w, _bias(b, x), stride, padding)


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=0):
    """x (N, Ci, H, W), w (Ci, Co, kh, kw): torch.nn.ConvTranspose2d
    semantics."""
    w = w.to(x.dtype)
    if (tuple(w.shape[2:]) == (4, 4) and stride == 2 and padding == 1
            and output_padding == 0):
        return convt4s2(x, w, _bias(b, x))
    return F.conv_transpose2d(x, w, _bias(b, x), stride, padding,
                              output_padding)
