"""Spatial resampling (NCHW).

Counterpart of supervised_gan_tpu/ops/resample.py `bilinear_upsample` (:46)
and the exact-tiling branch of `avg_pool` (:65).  The JAX package computes
both outside Pallas, so they are plain torch here.
"""

import torch.nn.functional as F


def bilinear_upsample(x, scale, align_corners=True):
    """x (N, C, H, W) -> (N, C, H*scale, W*scale), torch-0.3 bilinear
    (align_corners=True)."""
    return F.interpolate(x, scale_factor=scale, mode='bilinear',
                         align_corners=align_corners)


def avg_pool(x, kernel):
    """AvgPool2d(kernel, stride=kernel) on a spatial extent it tiles
    exactly (the CRN label pyramid)."""
    h, w = x.shape[2], x.shape[3]
    if h % kernel or w % kernel:
        raise ValueError('avg_pool: %dx%d does not tile by %d' % (h, w, kernel))
    return F.avg_pool2d(x, kernel, kernel)
