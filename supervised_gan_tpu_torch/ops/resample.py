"""Spatial resampling (NCHW).

Counterpart of supervised_gan_tpu/ops/resample.py: `bilinear_upsample`
(:46), the exact-tiling branch of `avg_pool` (:65) and the multi-scale
discriminator front end (`matlab_gauss2d` :129, `gauss_blur_kernel` :141,
`blur_downsample` :177).  The JAX package computes all of them outside
Pallas, so they are plain torch here.  Traps kept: bilinear uses
align_corners=True, and the blur's sigma is scale // 2 (the reference is
Python 2).
"""

import numpy as np
import torch
import torch.nn.functional as F


def _interp_taps(in_size, out_size, align_corners=True):
    """For each output position along one axis: the two source indices and
    their weights, computed in float64 as the JAX package's interpolation
    matrix (_interp_matrix, resample.py:27 there) is."""
    if out_size == 1 or in_size == 1:
        zeros = np.zeros(out_size, np.int64)
        return zeros, zeros, np.ones(out_size), np.zeros(out_size)
    if align_corners:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = np.clip((np.arange(out_size) + 0.5) * in_size / out_size - 0.5,
                      0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = src - i0
    return i0, i1, 1.0 - w, w


def _lerp_axis(x, dim, out_size, align_corners):
    i0, i1, w0, w1 = _interp_taps(x.shape[dim], out_size, align_corners)
    shape = [1] * x.dim()
    shape[dim] = out_size

    def weight(w):
        # the weights round to x's dtype, the sum runs in float32
        return torch.from_numpy(w).to(x.device, x.dtype).float().view(shape)

    def take(i):
        return x.index_select(dim, torch.from_numpy(i).to(x.device)).float()

    return (take(i0) * weight(w0) + take(i1) * weight(w1)).to(x.dtype)


def bilinear_upsample(x, scale, align_corners=True):
    """x (N, C, H, W) -> (N, C, H*scale, W*scale), torch-0.3 bilinear
    (align_corners=True): height then width, each output a two-tap blend
    whose weights come from float64 positions.  (F.interpolate computes its
    source positions in the input's precision; in float32 that moves them
    by ~1e-6 at 512 px, enough to flip ReLU masks downstream against the
    JAX package.)"""
    h, w = x.shape[2], x.shape[3]
    y = _lerp_axis(x, 2, h * scale, align_corners)
    return _lerp_axis(y, 3, w * scale, align_corners)


def avg_pool(x, kernel):
    """AvgPool2d(kernel, stride=kernel) on a spatial extent it tiles
    exactly (the CRN label pyramid and the bilinear transform's inverse)."""
    h, w = x.shape[2], x.shape[3]
    if h % kernel or w % kernel:
        raise ValueError('avg_pool: %dx%d does not tile by %d' % (h, w, kernel))
    return F.avg_pool2d(x, kernel, kernel)


def matlab_gauss2d(shape=(3, 3), sigma=0.5):
    """MATLAB fspecial('gaussian') (reference models/networks.py:22-33)."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h.astype(np.float32)


def gauss_blur_kernel(scale_factor):
    """The (kw, kw) blur of a multi-scale D front end: sigma = scale // 2,
    kw = 4 * sigma + 1 (reference models/networks.py:125-129)."""
    sigma = scale_factor // 2
    kw = 4 * sigma + 1
    return matlab_gauss2d((kw, kw), sigma)


def _blur_matrix(size, scale_factor):
    """(ceil(size / s), size) matrix whose rows are the 1-D Gaussian centred
    at the stride-s sample positions, zero padding 2*sigma: fspecial is
    separable, so two of these reproduce the depthwise blur + subsample."""
    sigma = scale_factor // 2
    kw = 4 * sigma + 1
    g = matlab_gauss2d((kw, 1), sigma)[:, 0]
    half = kw // 2
    out_size = -(-size // scale_factor)
    a = np.zeros((out_size, size), np.float32)
    for o in range(out_size):
        for t in range(kw):
            src = o * scale_factor + t - half
            if 0 <= src < size:
                a[o, src] = g[t]
    return a


def blur_downsample(x, scale_factor):
    """Gaussian blur (padding 2*sigma) + stride-``scale`` subsample of x
    (N, C, H, W), as two separable matrix contractions in float32; output
    in x's dtype (the reference's frozen ``gauss_filter``, models/
    networks.py:807-813)."""
    if scale_factor <= 1:
        return x
    h, w = x.shape[2], x.shape[3]
    ah = torch.from_numpy(_blur_matrix(h, scale_factor)).to(x.device)
    aw = torch.from_numpy(_blur_matrix(w, scale_factor)).to(x.device)
    y = torch.einsum('oh,nchw->ncow', ah, x.float())
    y = torch.einsum('pw,ncow->ncop', aw, y)
    return y.to(x.dtype)
