"""Autograd Functions over the kernels: each forward is a kernel wrapper and
each backward runs on kernels too (the JAX package's custom VJPs,
ops/pallas/conv3x3.py:506-563, instance_norm.py:154-227, conv4s2.py:190-199
and conv3x3_in.py:187-213 there).  The wrappers take their plain versions
for CPU tensors, so the same Functions run, differentiably, on the CPU.

The weight gradients of the two k4 s2 convolutions are left to PyTorch's
own ``torch.nn.grad.conv2d_weight``, as the JAX package left them to XLA.
"""

import torch
from torch.nn.grad import conv2d_weight

from .conv3x3 import conv3x3
from .conv3x3_dw import conv3x3_dw
from .conv3x3_in import conv3x3_in_stats
from .conv4s2 import conv4s2
from .convt4s2 import convt4s2
from . import instance_norm as _in
from .instance_norm import (instance_norm_act, instance_norm_apply,
                            instance_norm_bwd)


def _bias_grad(g):
    return g.float().sum(dim=(0, 2, 3)).to(g.dtype)


def _conv3x3_dx(g, w):
    """dx of conv3x3 for the cotangent g: the same kernel on g with w
    flipped in (ky, kx) and in/out swapped."""
    return conv3x3(g, w.flip((2, 3)).transpose(0, 1).contiguous())


class Conv3x3(torch.autograd.Function):
    """y = conv3x3(x, w, b).  dx is the same kernel on g with w flipped in
    (ky, kx) and in/out swapped; dW is the conv3x3_dw kernel; db = sum g."""

    @staticmethod
    def forward(ctx, x, w, b):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return conv3x3(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv3x3_dx(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, g).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = _bias_grad(g)
        return dx, dw, db


class Conv3x3InAct(torch.autograd.Function):
    """act(InstanceNorm(conv3x3(x, w, b))): the conv3x3_in_stats kernel, then
    instance_norm_apply with its statistics.  The backward follows the JAX
    region's (conv3x3_in.py:193-213 there): dconv = instance_norm_bwd(y, g,
    mean, rstd, slope); dx = conv3x3 of dconv with the flipped weight; dW =
    conv3x3_dw(x, dconv); db = sum dconv when the conv has a bias (rounding
    noise, since the norm removes a constant, but not zero)."""

    @staticmethod
    def forward(ctx, x, w, b, eps, slope):
        x, w = x.contiguous(), w.contiguous()
        y, mean, rstd = conv3x3_in_stats(x, w, b, eps)
        ctx.save_for_backward(x, w, y, mean, rstd)
        ctx.has_bias = b is not None
        ctx.slope = slope
        return instance_norm_apply(y, mean, rstd, slope)

    @staticmethod
    def backward(ctx, g):
        x, w, y, mean, rstd = ctx.saved_tensors
        dconv = instance_norm_bwd(y, g.contiguous(), mean, rstd, ctx.slope)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv3x3_dx(dconv, w)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, dconv).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = _bias_grad(dconv)
        return dx, dw, db, None, None


class ConvT4s2(torch.autograd.Function):
    """y = convt4s2(x, w, b), w (Ci, Co, 4, 4).  dx is the conv4s2 kernel on
    g with the same weight tensor read as a conv weight (out = Ci,
    in = Co)."""

    @staticmethod
    def forward(ctx, x, w, b):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return convt4s2(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv4s2(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight(g, w.shape, x, stride=2, padding=1)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = _bias_grad(g)
        return dx, dw, db


class Conv4s2(torch.autograd.Function):
    """y = conv4s2(x, w, b) for even H and W.  dx is the convt4s2 kernel on
    g with the same weight tensor read as a transposed-conv weight
    (in = Co, out = Ci)."""

    @staticmethod
    def forward(ctx, x, w, b):
        if x.shape[2] % 2 or x.shape[3] % 2:
            raise ValueError('Conv4s2 needs an even H and W, got %s'
                             % (tuple(x.shape),))
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return conv4s2(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = convt4s2(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight(x, w.shape, g, stride=2, padding=1)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = _bias_grad(g)
        return dx, dw, db


class InstanceNormAct(torch.autograd.Function):
    """y = instance_norm_act(x, eps, slope); the forward keeps its (N, C)
    mean and rstd for the instance_norm_bwd kernel."""

    @staticmethod
    def forward(ctx, x, eps, slope):
        x = x.contiguous()
        y, mean, rstd = instance_norm_act(x, eps, slope, return_stats=True)
        ctx.save_for_backward(x, mean, rstd)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        return (instance_norm_bwd(x, g.contiguous(), mean, rstd, ctx.slope),
                None, None)


# the row-split route's pieces: the kernel wrappers, or their plain versions
# (--no_pallas)
_ROWS_KERNELS = (_in.instance_norm_partial_stats, _in.instance_norm_apply,
                 _in.instance_norm_bwd_partial_stats,
                 _in.instance_norm_bwd_apply)
_ROWS_PLAIN = (_in.instance_norm_partial_stats_plain,
               _in.instance_norm_apply_plain,
               _in.instance_norm_bwd_partial_stats_plain,
               _in.instance_norm_bwd_apply_plain)


class InstanceNormActRows(torch.autograd.Function):
    """y = instance_norm_act of planes whose rows are split over ranks
    (--spatial_mesh): x holds this rank's rows, ``count`` is the global
    plane's H x W and ``reduce_`` sums a tensor in place over the ranks.
    Forward: each plane's (sum x, sum x^2) of these rows, all-reduced; mean
    and rstd = 1 / sqrt(E[x^2] - mean^2 + eps) in float32, as the JAX
    streaming route forms them (instance_norm.py:371-386 there); apply.
    Backward: each plane's (sum g', sum g' x^), all-reduced; dx.  ``plain``
    takes the plain versions (the kernels switched off)."""

    @staticmethod
    def forward(ctx, x, eps, slope, count, reduce_, plain=False):
        stats, apply, bwd_stats, bwd_apply = (_ROWS_PLAIN if plain
                                              else _ROWS_KERNELS)
        x = x.contiguous()
        sums = reduce_(stats(x))
        mean = sums[..., 0] / count
        var = (sums[..., 1] / count - mean * mean).clamp_min(0.0)
        rstd = torch.rsqrt(var + eps).contiguous()
        mean = mean.contiguous()
        ctx.save_for_backward(x, mean, rstd)
        ctx.slope, ctx.count, ctx.reduce_ = slope, count, reduce_
        ctx.bwd = (bwd_stats, bwd_apply)
        return apply(x, mean, rstd, slope)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        bwd_stats, bwd_apply = ctx.bwd
        g = g.contiguous()
        sums = ctx.reduce_(bwd_stats(x, g, mean, rstd, ctx.slope))
        return (bwd_apply(x, g, mean, rstd, sums, ctx.count, ctx.slope),
                None, None, None, None, None)
