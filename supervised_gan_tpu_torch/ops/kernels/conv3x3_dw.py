"""Weight gradient of the 3x3 stride-1 pad-1 convolution: the hand-written
CUDA kernel (csrc/conv3x3_dw.cu) and its plain PyTorch version.

Replaces supervised_gan_tpu/ops/pallas/conv3x3.py `_dw_kernel` (:226,
through `_conv3x3_dw` :305) and `_dwT_kernel` (:339, through
`_conv3x3_dw_v2` :420), which compute one function for the TPU's banded
128-lane layout.  This kernel takes any N, Ci, Co, H and W.  Bound on the
H100: arithmetic (see the source note).

Layout: x (N, Ci, H, W) and g (N, Co, H, W) of one dtype (float32 or
bfloat16); dW (Co, Ci, 3, 3) float32, the layout of torch.nn.Conv2d's
weight:  dW[co, ci, ky, kx] = sum_{n,y,x} g[n,co,y,x] * x[n,ci,y+ky-1,x+kx-1].
"""

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .common import DTYPE_CODES, check_cuda_inputs, on_cpu, raise_on_error, \
    stream_arg

_SIGNATURES = {
    'conv3x3_dw_workspace': ([ctypes.c_int] * 5, ctypes.c_longlong),
    'conv3x3_dw': ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p], ctypes.c_int),
}


def conv3x3_dw_plain(x, g):
    """The same function as the kernel: for each of the nine taps, the
    cotangent contracted with the shifted zero-padded input over every
    pixel, in float32."""
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    gf = g.float()
    taps = [torch.einsum('nohw,nihw->oi', gf, xp[:, :, ky:ky + h, kx:kx + w])
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=-1).reshape(g.shape[1], x.shape[1], 3, 3)


def conv3x3_dw(x, g):
    """CPU tensors take conv3x3_dw_plain; CUDA tensors launch the kernel or
    raise.  Returns float32 (Co, Ci, 3, 3)."""
    if on_cpu(x, g):
        return conv3x3_dw_plain(x, g)
    check_cuda_inputs('conv3x3_dw', x, g)
    if (x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]
            or x.shape[2:] != g.shape[2:]):
        raise ValueError('conv3x3_dw: x %s and g %s are not (N, Ci, H, W) '
                         'and (N, Co, H, W)' % (tuple(x.shape),
                                                tuple(g.shape)))
    n, ci, h, w = x.shape
    co = g.shape[1]
    lib = build.load('conv3x3_dw', _SIGNATURES)
    partials = torch.empty((lib.conv3x3_dw_workspace(n, ci, co, h, w),),
                           dtype=torch.float32, device=x.device)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_dw(x.data_ptr(), g.data_ptr(), partials.data_ptr(),
                             dw.data_ptr(), n, ci, co, h, w,
                             DTYPE_CODES[x.dtype], stream_arg(x))
        conv3x3_dw.launches += 1
    raise_on_error('conv3x3_dw', err)
    return dw


conv3x3_dw.launches = 0
