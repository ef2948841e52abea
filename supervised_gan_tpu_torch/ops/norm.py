"""Normalization (NCHW).

Counterpart of supervised_gan_tpu/ops/norm.py (`instance_norm` :23,
`batch_norm` :36).  InstanceNorm goes to the fused IN+activation kernel
through its autograd Function, whose backward is the IN backward kernel
(``instance_norm_act`` with slope None is the plain norm).
BatchNorm always normalizes with batch statistics, because the reference
never calls ``.eval()``; it is plain torch, as the JAX package has no kernel
for it.  Statistics are float32; outputs keep x's dtype.
"""

import torch

from .kernels import InstanceNormAct


def instance_norm_act(x, eps=1e-5, slope=None):
    """InstanceNorm(affine=False) of x (N, C, H, W), then LeakyReLU(slope)
    (0.0: ReLU; None: no activation), differentiable."""
    return InstanceNormAct.apply(x, eps, slope)


def batch_norm(x, weight, bias, eps=1e-5):
    """x (N, C, H, W), weight/bias (C,): train-mode batch statistics."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3), keepdim=True)
    msq = (xf * xf).mean(dim=(0, 2, 3), keepdim=True)
    var = (msq - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


__all__ = ["instance_norm_act", "batch_norm"]
