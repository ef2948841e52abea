"""InstanceNorm(affine=False) + activation and its backward: the
hand-written CUDA kernels (csrc/instance_norm.cu, a statistics pass and an
apply pass each way) and their plain PyTorch versions.

`instance_norm_act` replaces the forward of supervised_gan_tpu/ops/pallas/
instance_norm.py `fused_instance_norm_act` (:148): the whole-plane `_kernel`
(:109) and the streaming `_fwd_stats_kernel` (:297) / `_fwd_apply_kernel`
(:312), which compute one function.  `instance_norm_bwd` replaces
`_bwd_stats_kernel` (:319) and `_bwd_apply_kernel` (:337), reached through
`_stream_bwd` (:416).  `instance_norm_apply` is the apply pass alone with
given statistics: the normalize of the fused conv3x3 + IN region
(conv3x3_in.py `_norm_act` :166 there, which runs `stream_apply`,
instance_norm.py:389, the `_fwd_apply_kernel` :312).  Bound on the H100:
bytes (see the source note).

Layout: x, g (N, C, H, W), float32 or bfloat16; statistics per (n, c) over
H x W in float32, as (N, C) mean and rstd = 1/sqrt(var + eps); outputs in
x's dtype.  ``slope`` None is identity, 0.0 is ReLU, anything else
LeakyReLU(slope).
"""

import ctypes

import torch

from . import build
from .common import (DTYPE_CODES, check_cuda_inputs, on_cpu, raise_on_error,
                     stream_arg)

_SIGNATURES = {
    'instance_norm_act_fwd': (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p], ctypes.c_int),
    'instance_norm_apply': (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    'instance_norm_act_bwd': (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}

# elements of a plane per block: 512^2 planes split 32 ways, so the 64-plane
# sites launch 2048 blocks per pass
_CHUNK = 8192
_MAX_SPLITS = 1024


def instance_norm_act_plain(x, eps=1e-5, slope=None, return_stats=False):
    """The same function as the kernel, as the JAX forward computes it
    (instance_norm.py:119-131): var = max(E[x^2] - mean^2, 0), f32.  With
    ``return_stats`` also the (N, C) mean and rstd."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    msq = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = (msq - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if slope is not None:
        y = torch.where(y >= 0, y, y * slope)
    y = y.to(x.dtype)
    if return_stats:
        return y, mean[:, :, 0, 0], rstd[:, :, 0, 0]
    return y


def instance_norm_apply_plain(y, mean, rstd, slope=None):
    """The same function as the apply kernel, as the JAX region's
    `_norm_act` computes it: act((y - mean) * rstd) in float32, output in
    y's dtype."""
    n, c = mean.shape
    z = ((y.float() - mean.float().view(n, c, 1, 1))
         * rstd.float().view(n, c, 1, 1))
    if slope is not None:
        z = torch.where(z >= 0, z, z * slope)
    return z.to(y.dtype)


def instance_norm_bwd_plain(x, g, mean, rstd, slope=None):
    """The same function as the backward kernel, as the JAX stream kernels
    compute it (instance_norm.py:319-344): x^ = (x - mean) * rstd,
    g' = g * act'(x^), dx = rstd * (g' - mean(g') - x^ * mean(g' x^)), f32."""
    n, c = mean.shape
    m = mean.float().view(n, c, 1, 1)
    r = rstd.float().view(n, c, 1, 1)
    xh = (x.float() - m) * r
    gp = g.float()
    if slope is not None:
        gp = torch.where(xh >= 0, gp, gp * slope)
    gm = gp.mean(dim=(2, 3), keepdim=True)
    gz = (gp * xh).mean(dim=(2, 3), keepdim=True)
    return ((gp - gm - xh * gz) * r).to(x.dtype)


def splits_for(hw):
    return max(1, min(_MAX_SPLITS, -(-hw // _CHUNK)))


def _act_args(slope):
    return int(slope is not None), float(slope if slope is not None else 0.0)


def instance_norm_act(x, eps=1e-5, slope=None, return_stats=False):
    """CPU tensors take instance_norm_act_plain; CUDA tensors launch the
    kernel or raise.  With ``return_stats`` returns (y, mean, rstd), the
    statistics as (N, C) float32."""
    if on_cpu(x):
        return instance_norm_act_plain(x, eps, slope, return_stats)
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
    stats = (torch.empty((2, n, c), dtype=torch.float32, device=x.device)
             if return_stats else None)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_act_fwd(
            x.data_ptr(), y.data_ptr(), partials.data_ptr(),
            None if stats is None else stats.data_ptr(), nc, hw, splits,
            float(eps), *_act_args(slope), DTYPE_CODES[x.dtype],
            stream_arg(x))
        instance_norm_act.launches += 1
    raise_on_error('instance_norm_act', err)
    if return_stats:
        return y, stats[0], stats[1]
    return y


instance_norm_act.launches = 0


def _check_stats(name, x, mean, rstd):
    n, c = x.shape[:2]
    for t in (mean, rstd):
        if (t.shape != (n, c) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError('%s: statistics must be contiguous float32 '
                             '(%d, %d) on %s' % (name, n, c, x.device))


def instance_norm_apply(y, mean, rstd, slope=None):
    """act((y - mean) * rstd) per (n, c) plane, from (N, C) float32 mean and
    rstd.  CPU tensors take instance_norm_apply_plain; CUDA tensors launch
    the kernel or raise."""
    if on_cpu(y, mean, rstd):
        return instance_norm_apply_plain(y, mean, rstd, slope)
    check_cuda_inputs('instance_norm_apply', y)
    if y.dim() != 4 or y.numel() == 0:
        raise ValueError('instance_norm_apply: y must be a non-empty (N, C, '
                         'H, W) tensor, got %s' % (tuple(y.shape),))
    _check_stats('instance_norm_apply', y, mean, rstd)
    n, c, h, w = y.shape
    out = torch.empty_like(y)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.instance_norm_apply(
            y.data_ptr(), out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            n * c, h * w, splits_for(h * w), *_act_args(slope),
            DTYPE_CODES[y.dtype], stream_arg(y))
        instance_norm_apply.launches += 1
    raise_on_error('instance_norm_apply', err)
    return out


instance_norm_apply.launches = 0


def instance_norm_bwd(x, g, mean, rstd, slope=None):
    """dx of instance_norm_act at x for the cotangent g, from the
    forward's (N, C) float32 mean and rstd.  CPU tensors take
    instance_norm_bwd_plain; CUDA tensors launch the kernel or raise."""
    if on_cpu(x, g, mean, rstd):
        return instance_norm_bwd_plain(x, g, mean, rstd, slope)
    check_cuda_inputs('instance_norm_bwd', x, g)
    if x.dim() != 4 or x.numel() == 0 or g.shape != x.shape:
        raise ValueError('instance_norm_bwd: x %s and g %s must be one '
                         'non-empty (N, C, H, W) shape'
                         % (tuple(x.shape), tuple(g.shape)))
    _check_stats('instance_norm_bwd', x, mean, rstd)
    n, c, h, w = x.shape
    nc, hw = n * c, h * w
    splits = splits_for(hw)
    partials = torch.empty((nc * splits * 2,), dtype=torch.float32,
                           device=x.device)
    dx = torch.empty_like(x)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_act_bwd(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), partials.data_ptr(), nc, hw, splits,
            *_act_args(slope), DTYPE_CODES[x.dtype], stream_arg(x))
        instance_norm_bwd.launches += 1
    raise_on_error('instance_norm_bwd', err)
    return dx


instance_norm_bwd.launches = 0
