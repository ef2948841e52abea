"""InstanceNorm(affine=False) + activation and its backward: the
hand-written CUDA kernels (csrc/instance_norm.cu: one launch each way, each
plane held in the shared memory of one block or of a thread-block cluster;
two passes for planes too large for that) and their plain PyTorch versions.

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

import collections
import ctypes
import functools

import torch

from . import build
from .common import (DTYPE_CODES, check_cuda_inputs, on_cpu, raise_on_error,
                     stream_arg)

_SIGNATURES = {
    'instance_norm_plan': ([ctypes.c_int] * 4 + [ctypes.c_void_p],
                           ctypes.c_int),
    'instance_norm_max_active_clusters': ([ctypes.c_int] * 4, ctypes.c_int),
    'instance_norm_act_fwd': (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p], ctypes.c_int),
    'instance_norm_apply': (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    'instance_norm_act_bwd': (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    'instance_norm_splits': ([ctypes.c_int], ctypes.c_int),
    'instance_norm_partial_stats': (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    'instance_norm_bwd_partial_stats': (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p], ctypes.c_int),
    'instance_norm_bwd_apply': (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p], ctypes.c_int),
}

# csrc/instance_norm.cu's plan: a block holds about TARGET_BYTES of its plane
# in shared memory; planes of MIN_BYTES or more are cut further until the
# grid has FILL_BLOCKS blocks (two on each of the H100's 132 SMs); a plane
# takes a cluster of up to MAX_CLUSTER blocks (a power of two); a chunk that
# would need more than MAX_SMEM bytes at MAX_CLUSTER blocks takes the
# two-pass kernels, which split a plane into chunks of _CHUNK elements.
TARGET_BYTES, MIN_BYTES, FILL_BLOCKS = 64 * 1024, 16 * 1024, 264
MAX_CLUSTER, MAX_SMEM = 16, 200 * 1024
_CHUNK = 8192
_MAX_SPLITS = 1024
ROUTES = ('block', 'cluster', 'two_pass')

# route: one of ROUTES; cluster: blocks a plane (two_pass: its splits);
# chunk: elements a block; smem: dynamic shared memory bytes a block;
# threads: a block's
InPlan = collections.namedtuple('InPlan', 'route cluster chunk smem threads')


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


def instance_norm_partial_stats_plain(x):
    """Each plane's (sum x, sum x^2) in float32, (N, C, 2)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], -1)


def _xhat_gp(x, g, mean, rstd, slope):
    n, c = mean.shape
    xh = ((x.float() - mean.float().view(n, c, 1, 1))
          * rstd.float().view(n, c, 1, 1))
    gp = g.float()
    if slope is not None:
        gp = torch.where(xh >= 0, gp, gp * slope)
    return xh, gp


def instance_norm_bwd_partial_stats_plain(x, g, mean, rstd, slope=None):
    """Each plane's (sum g', sum g' x^) in float32, (N, C, 2), x^ and g' as
    instance_norm_bwd_plain forms them from the given statistics."""
    xh, gp = _xhat_gp(x, g, mean, rstd, slope)
    return torch.stack([gp.sum(dim=(2, 3)), (gp * xh).sum(dim=(2, 3))], -1)


def instance_norm_bwd_apply_plain(x, g, mean, rstd, sums, count, slope=None):
    """dx = rstd (g' - s1 / count - x^ s2 / count), (s1, s2) = ``sums``
    (N, C, 2) over ``count`` elements a plane, in float32; x's dtype out."""
    n, c = mean.shape
    xh, gp = _xhat_gp(x, g, mean, rstd, slope)
    gm = (sums[..., 0].float() / count).view(n, c, 1, 1)
    gz = (sums[..., 1].float() / count).view(n, c, 1, 1)
    r = rstd.float().view(n, c, 1, 1)
    return ((gp - gm - xh * gz) * r).to(x.dtype)


def _cdiv(a, b):
    return -(-a // b)


def splits_for(hw):
    return max(1, min(_MAX_SPLITS, _cdiv(hw, _CHUNK)))


@functools.lru_cache(maxsize=None)
def in_plan(n, c, h, w, dtype, direction):
    """How the kernel takes N*C planes of H*W elements of ``dtype``
    (torch.float32 or torch.bfloat16), ``direction`` 'forward' or
    'backward' (csrc/instance_norm.cu make_plan, which chip_smoke.py holds
    equal to this).  One plane is cut into ``cluster`` contiguous chunks of
    ``chunk`` elements (a multiple of one 16-byte vector), one a block; the
    blocks of a plane form one thread-block cluster, each holding its chunk
    (x, and g backward) in ``smem`` bytes of shared memory.  Forward and
    backward are one launch each on the 'block' and 'cluster' routes, two on
    'two_pass'."""
    if direction not in ('forward', 'backward'):
        raise ValueError('in_plan: direction must be forward or backward, '
                         'got %r' % (direction,))
    esize = 4 if dtype == torch.float32 else 2
    vec = 16 // esize
    bpe = esize * (2 if direction == 'backward' else 1)
    pbytes = h * w * bpe
    want = max(_cdiv(pbytes, TARGET_BYTES),
               min(_cdiv(FILL_BLOCKS, n * c), pbytes // MIN_BYTES))
    r = 1
    while r < want and r < MAX_CLUSTER:
        r *= 2
    chunk = _cdiv(_cdiv(h * w, r), vec) * vec
    smem = (chunk + vec) * bpe
    if smem > MAX_SMEM:
        splits = splits_for(h * w)
        return InPlan('two_pass', splits, _cdiv(h * w, splits), 0, 256)
    nbytes = chunk * bpe
    threads = (512 if nbytes >= 128 * 1024 else 256 if nbytes >= 64 * 1024
               else 128)
    return InPlan('cluster' if r > 1 else 'block', r, chunk, smem, threads)


def _aligned(t):
    """t, or a copy of it where it does not start on a 16-byte boundary (a
    view into a larger tensor): the kernels move 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _workspace(plan, nc, device):
    """(kept tensor, pointer, floats) of the two-pass route's partials."""
    if plan.route != 'two_pass':
        return None, None, 0
    part = torch.empty((2 * nc * plan.cluster,), dtype=torch.float32,
                       device=device)
    return part, part.data_ptr(), part.numel()


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
    x = _aligned(x)
    part, pptr, nws = _workspace(in_plan(n, c, h, w, x.dtype, 'forward'),
                                 n * c, x.device)
    y = torch.empty_like(x)
    stats = (torch.empty((2, n, c), dtype=torch.float32, device=x.device)
             if return_stats else None)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_act_fwd(
            x.data_ptr(), y.data_ptr(), pptr, nws,
            None if stats is None else stats.data_ptr(), n * c, h * w,
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
    x, g = _aligned(x), _aligned(g)
    part, pptr, nws = _workspace(in_plan(n, c, h, w, x.dtype, 'backward'),
                                 n * c, x.device)
    dx = torch.empty_like(x)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_act_bwd(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), pptr, nws, n * c, h * w, *_act_args(slope),
            DTYPE_CODES[x.dtype], stream_arg(x))
        instance_norm_bwd.launches += 1
    raise_on_error('instance_norm_bwd', err)
    return dx


instance_norm_bwd.launches = 0


def _partials(x):
    """(kept tensor, pointer, floats) of the row-split entries' scratch."""
    n, c, h, w = x.shape
    part = torch.empty((2 * n * c * splits_for(h * w),), dtype=torch.float32,
                       device=x.device)
    return part, part.data_ptr(), part.numel()


def _check_plane(name, x, *others):
    check_cuda_inputs(name, x, *others)
    if x.dim() != 4 or x.numel() == 0 or any(t.shape != x.shape
                                             for t in others):
        raise ValueError('%s: x%s must be non-empty (N, C, H, W) tensors of '
                         'one shape, got %s' % (
                             name, ' and g' if others else '',
                             [tuple(t.shape) for t in (x,) + others]))


def instance_norm_partial_stats(x):
    """Each plane's (sum x, sum x^2) over this tensor's rows, (N, C, 2)
    float32.  CPU tensors take instance_norm_partial_stats_plain; CUDA
    tensors launch the kernels or raise."""
    if on_cpu(x):
        return instance_norm_partial_stats_plain(x)
    _check_plane('instance_norm_partial_stats', x)
    n, c, h, w = x.shape
    part, pptr, nws = _partials(x)
    sums = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_partial_stats(
            x.data_ptr(), pptr, nws, sums.data_ptr(), n * c, h * w,
            DTYPE_CODES[x.dtype], stream_arg(x))
        instance_norm_partial_stats.launches += 1
    raise_on_error('instance_norm_partial_stats', err)
    return sums


instance_norm_partial_stats.launches = 0


def instance_norm_bwd_partial_stats(x, g, mean, rstd, slope=None):
    """Each plane's (sum g', sum g' x^) over this tensor's rows from the
    (global) (N, C) float32 mean and rstd, (N, C, 2) float32.  CPU tensors
    take instance_norm_bwd_partial_stats_plain; CUDA tensors launch the
    kernels or raise."""
    if on_cpu(x, g, mean, rstd):
        return instance_norm_bwd_partial_stats_plain(x, g, mean, rstd, slope)
    _check_plane('instance_norm_bwd_partial_stats', x, g)
    _check_stats('instance_norm_bwd_partial_stats', x, mean, rstd)
    n, c, h, w = x.shape
    part, pptr, nws = _partials(x)
    sums = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_bwd_partial_stats(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            pptr, nws, sums.data_ptr(), n * c, h * w, *_act_args(slope),
            DTYPE_CODES[x.dtype], stream_arg(x))
        instance_norm_bwd_partial_stats.launches += 1
    raise_on_error('instance_norm_bwd_partial_stats', err)
    return sums


instance_norm_bwd_partial_stats.launches = 0


def instance_norm_bwd_apply(x, g, mean, rstd, sums, count, slope=None):
    """dx of instance_norm_act from the (global) (N, C) float32 mean and
    rstd and the (N, C, 2) float32 sums of g' and g' x^ over ``count``
    elements a plane.  CPU tensors take instance_norm_bwd_apply_plain; CUDA
    tensors launch the kernel or raise."""
    if on_cpu(x, g, mean, rstd, sums):
        return instance_norm_bwd_apply_plain(x, g, mean, rstd, sums, count,
                                             slope)
    _check_plane('instance_norm_bwd_apply', x, g)
    _check_stats('instance_norm_bwd_apply', x, mean, rstd)
    n, c, h, w = x.shape
    if (sums.shape != (n, c, 2) or sums.dtype != torch.float32
            or sums.device != x.device or not sums.is_contiguous()):
        raise ValueError('instance_norm_bwd_apply: sums must be contiguous '
                         'float32 (%d, %d, 2) on %s' % (n, c, x.device))
    dx = torch.empty_like(x)
    lib = build.load('instance_norm', _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.instance_norm_bwd_apply(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            sums.data_ptr(), dx.data_ptr(), n * c, h * w, float(count),
            *_act_args(slope), DTYPE_CODES[x.dtype], stream_arg(x))
        instance_norm_bwd_apply.launches += 1
    raise_on_error('instance_norm_bwd_apply', err)
    return dx


instance_norm_bwd_apply.launches = 0
