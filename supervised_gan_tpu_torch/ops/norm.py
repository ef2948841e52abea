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
for it.  Statistics are float32; outputs keep x's dtype.  In a data-parallel
run they are the global batch's: each rank's sums of x and x^2 summed over
the ranks over the global count, differentiably, as GSPMD's psum in JAX.

Under --spatial_mesh (parallel/spatial.py) a plane whose rows are split
over the sp group takes the row-split route of the IN kernels
(InstanceNormActRows: partial sums, an all-reduce, apply; the same in the
backward) whether or not its plane would fit one launch; replicated planes
keep the one-launch kernels.  BatchNorm's sums are all-reduced over the
whole grid for a row-sharded tensor, over the data group for a replicated
one (its sp ranks hold the same rows), never a mean of means, since the
ranks' rows differ in number.
"""

import torch
import torch.nn.functional as F

from .. import parallel
from ..parallel import spatial
from .kernels import InstanceNormAct, InstanceNormActRows, kernels_enabled


def instance_norm_act(x, eps=1e-5, slope=None):
    """InstanceNorm(affine=False) of x (N, C, H, W), then LeakyReLU(slope)
    (0.0: ReLU; None: no activation), differentiable."""
    if spatial.sharded(x):
        h = x._sp_h
        y = InstanceNormActRows.apply(x, eps, slope, h * x.shape[3],
                                      spatial.sp_sum_, not kernels_enabled())
        return spatial.mark(y, h)
    if kernels_enabled():
        return InstanceNormAct.apply(x, eps, slope)
    # aten accumulates a bf16 input's statistics in float32 and returns x's
    # dtype, as the JAX norm does
    y = F.instance_norm(x, eps=eps)
    if slope is None:
        return y
    return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)


def batch_norm(x, weight, bias, eps=1e-5):
    """x (N, C, H, W), weight/bias (C,): train-mode batch statistics, the
    sums of x and x^2 over the grid (spatial.sum_over) over the global
    count."""
    xf = x.float()
    c = x.shape[1]
    sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
    sums = spatial.sum_over(sums, spatial.sharded(x))
    count = parallel.world() * x.shape[0] * spatial.height(x) * x.shape[3]
    mean = (sums[:c] / count).view(1, c, 1, 1)
    msq = (sums[c:] / count).view(1, c, 1, 1)
    var = (msq - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


__all__ = ["instance_norm_act", "batch_norm"]
