"""InstanceNorm(affine=False) + activation: the hand-written CUDA kernel
(csrc/instance_norm.cu, a statistics pass and an apply pass) and its plain
PyTorch version.

Replaces the forward of supervised_gan_tpu/ops/pallas/instance_norm.py
`fused_instance_norm_act` (:148): the whole-plane `_kernel` (:109) and the
streaming `_fwd_stats_kernel` (:297) / `_fwd_apply_kernel` (:312), which
compute one function.  Bound on the H100: bytes (see the source note).

Layout: x (N, C, H, W), float32 or bfloat16; statistics per (n, c) over
H x W in float32; output in x's dtype.  ``slope`` None is identity, 0.0 is
ReLU, anything else LeakyReLU(slope).
"""

import ctypes

import torch

from . import build
from .common import (DTYPE_CODES, check_cuda_inputs, on_cpu, raise_on_error,
                     stream_arg)

_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
              + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p], ctypes.c_int)

# elements of a plane per block: 512^2 planes split 32 ways, so the 64-plane
# sites launch 2048 blocks per pass
_CHUNK = 8192
_MAX_SPLITS = 1024


def instance_norm_act_plain(x, eps=1e-5, slope=None):
    """The same function as the kernel, as the JAX forward computes it
    (instance_norm.py:119-131): var = max(E[x^2] - mean^2, 0), f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    msq = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = (msq - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if slope is not None:
        y = torch.where(y >= 0, y, y * slope)
    return y.to(x.dtype)


def splits_for(hw):
    return max(1, min(_MAX_SPLITS, -(-hw // _CHUNK)))


def instance_norm_act(x, eps=1e-5, slope=None):
    """CPU tensors take instance_norm_act_plain; CUDA tensors launch the
    kernel or raise."""
    if on_cpu(x):
        return instance_norm_act_plain(x, eps, slope)
    check_cuda_inputs('instance_norm_act', x)
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError('instance_norm_act: x must be a non-empty (N, C, H, '
                         'W) tensor, got %s' % (tuple(x.shape),))
    n, c, h, w = x.shape
    nc, hw = n * c, h * w
    splits = splits_for(hw)
    partials = torch.empty((nc * splits * 2,), dtype=torch.float32,
                           device=x.device)
    y = torch.empty_like(x)
    lib = build.load('instance_norm', {'instance_norm_act_fwd': _SIGNATURE})
    with torch.cuda.device(x.device):
        err = lib.instance_norm_act_fwd(
            x.data_ptr(), y.data_ptr(), partials.data_ptr(), nc, hw, splits,
            float(eps), int(slope is not None),
            float(slope if slope is not None else 0.0),
            DTYPE_CODES[x.dtype], stream_arg(x))
        instance_norm_act.launches += 1
    raise_on_error('instance_norm_act', err)
    return y


instance_norm_act.launches = 0
