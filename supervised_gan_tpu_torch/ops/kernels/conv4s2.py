"""4x4 stride-2 pad-1 convolution plus bias: the hand-written CUDA kernel
(csrc/conv4s2.cu) and its plain PyTorch version.

Replaces supervised_gan_tpu/ops/pallas/conv4s2.py `_kernel` (:81) through
`conv4s2_same` (:183).  The Pallas kernel's lane gate (Ci and Co multiples
of 64) refuses the 1-, 2- and 3-channel stems; this kernel takes every
shape, so every stride-2 conv of the PatchGAN trunks and the unet down path
goes through it, and so does the dx of every k4 s2 transposed conv.  Bound
on the H100: arithmetic at the wide sites (see the source note).

Layout: x (N, Ci, H, W), w (Co, Ci, 4, 4) as torch.nn.Conv2d, b (Co,) or
None; y (N, Co, (H-2)//2+1, (W-2)//2+1) in x's dtype (float32 or bfloat16,
f32 accumulation).
"""

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .common import (DTYPE_CODES, bias_arg, check_cuda_inputs, on_cpu,
                     raise_on_error, stream_arg)

_SIGNATURES = {
    'conv4s2_workspace': ([ctypes.c_int] * 5, ctypes.c_longlong),
    'conv4s2_fwd': ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p], ctypes.c_int),
}


def conv4s2_plain(x, w, b=None):
    """The same function as the kernel: sixteen stride-2 tap slices of the
    1-padded input, each contracted over the input channels, accumulated in
    float32."""
    ho, wo = (x.shape[2] - 2) // 2 + 1, (x.shape[3] - 2) // 2 + 1
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w.float()
    y = None
    for ky in range(4):
        for kx in range(4):
            t = torch.einsum('oi,nihw->nohw', wf[:, :, ky, kx],
                             xp[:, :, ky:ky + 2 * ho - 1:2,
                                kx:kx + 2 * wo - 1:2])
            y = t if y is None else y + t
    if b is not None:
        y = y + b.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def conv4s2(x, w, b=None):
    """CPU tensors take conv4s2_plain; CUDA tensors launch the kernel or
    raise."""
    if on_cpu(x, w, b):
        return conv4s2_plain(x, w, b)
    check_cuda_inputs('conv4s2', x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (4, 4) \
            or w.shape[1] != x.shape[1] or min(x.shape[2:]) < 2:
        raise ValueError('conv4s2: x %s and w %s are not (N, Ci, H, W) with '
                         'H, W >= 2 and (Co, Ci, 4, 4)'
                         % (tuple(x.shape), tuple(w.shape)))
    n, ci, h, wd = x.shape
    co = w.shape[0]
    bf, bptr = bias_arg('conv4s2', b, co, x.device)
    y = torch.empty((n, co, (h - 2) // 2 + 1, (wd - 2) // 2 + 1),
                    dtype=x.dtype, device=x.device)
    lib = build.load('conv4s2', _SIGNATURES)
    # f32 partials of the input-channel splits at the deep, small sites
    nws = lib.conv4s2_workspace(n, ci, co, h, wd)
    partials = (torch.empty((nws,), dtype=torch.float32, device=x.device)
                if nws else None)
    with torch.cuda.device(x.device):
        err = lib.conv4s2_fwd(x.data_ptr(), w.data_ptr(), bptr, y.data_ptr(),
                              None if partials is None
                              else partials.data_ptr(),
                              n, ci, co, h, wd, DTYPE_CODES[x.dtype],
                              stream_arg(x))
        conv4s2.launches += 1
    raise_on_error('conv4s2', err)
    return y


conv4s2.launches = 0
