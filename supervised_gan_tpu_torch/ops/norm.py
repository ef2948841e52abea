"""Normalization (NCHW).

Counterpart of supervised_gan_tpu/ops/norm.py (`instance_norm` :23,
`batch_norm` :36).  InstanceNorm goes to the fused IN+activation kernel
through its autograd Function, whose backward is the IN backward kernel
(``instance_norm_act`` with slope None is the plain norm).  With the kernels
switched off (``--no_pallas``) it is aten's instance norm, then the
activation as its own op, as the JAX package's --no_pallas runs its XLA
norm and activation apart.
BatchNorm always normalizes with batch statistics, because the reference
never calls ``.eval()``; it is plain torch, as the JAX package has no kernel
for it.  Statistics are float32; outputs keep x's dtype.
"""

import torch
import torch.nn.functional as F

from .kernels import InstanceNormAct, kernels_enabled


def instance_norm_act(x, eps=1e-5, slope=None):
    """InstanceNorm(affine=False) of x (N, C, H, W), then LeakyReLU(slope)
    (0.0: ReLU; None: no activation), differentiable."""
    if kernels_enabled():
        return InstanceNormAct.apply(x, eps, slope)
    # aten accumulates a bf16 input's statistics in float32 and returns x's
    # dtype, as the JAX norm does
    y = F.instance_norm(x, eps=eps)
    if slope is None:
        return y
    return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)


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
