"""3x3 stride-1 pad-1 convolution plus bias: the hand-written CUDA kernel
(csrc/conv3x3.cu) and its plain PyTorch version.

Replaces supervised_gan_tpu/ops/pallas/conv3x3.py `_kernel` (:143) through
`conv3x3_same` (:497).  The Pallas kernel only takes batch 1, C_in == C_out
and 512^2 pixels; those are TPU layout limits, not the function, so this
kernel takes any N, C_in, C_out, H and W and every k3 s1 p1 conv of the CRN
goes through it.  Bound on the H100: arithmetic (see the source note).

Layout: x (N, Ci, H, W), w (Co, Ci, 3, 3) as torch.nn.Conv2d, b (Co,) or
None; y (N, Co, H, W) in x's dtype (float32 or bfloat16, f32 accumulation).
"""

import torch
import torch.nn.functional as F

from . import build
from .common import (CONV_SIGNATURE, DTYPE_CODES, bias_arg, check_cuda_inputs,
                     on_cpu, raise_on_error, stream_arg)


def conv3x3_plain(x, w, b=None):
    """The same function as the kernel: nine shifted channel contractions
    over the zero-padded input, accumulated in float32."""
    return conv3x3_plain_f32(x, w, b).to(x.dtype)


def conv3x3_plain_f32(x, w, b=None):
    """conv3x3_plain before its cast to x's dtype: the float32 accumulator,
    bias added."""
    h, wd = x.shape[2], x.shape[3]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w.float()
    y = None
    for ky in range(3):
        for kx in range(3):
            t = torch.einsum('oi,nihw->nohw', wf[:, :, ky, kx],
                             xp[:, :, ky:ky + h, kx:kx + wd])
            y = t if y is None else y + t
    if b is not None:
        y = y + b.float().view(1, -1, 1, 1)
    return y


def conv3x3(x, w, b=None):
    """CPU tensors take conv3x3_plain; CUDA tensors launch the kernel or
    raise."""
    if on_cpu(x, w, b):
        return conv3x3_plain(x, w, b)
    check_cuda_inputs('conv3x3', x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) \
            or w.shape[1] != x.shape[1]:
        raise ValueError('conv3x3: x %s and w %s are not (N, Ci, H, W) and '
                         '(Co, Ci, 3, 3)' % (tuple(x.shape), tuple(w.shape)))
    n, ci, h, wd = x.shape
    co = w.shape[0]
    bf, bptr = bias_arg('conv3x3', b, co, x.device)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    lib = build.load('conv3x3', {'conv3x3_fwd': CONV_SIGNATURE})
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd(x.data_ptr(), w.data_ptr(), bptr, y.data_ptr(),
                              n, ci, co, h, wd, DTYPE_CODES[x.dtype],
                              stream_arg(x))
        conv3x3.launches += 1
    raise_on_error('conv3x3', err)
    return y


conv3x3.launches = 0
