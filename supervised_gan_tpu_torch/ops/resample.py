"""Spatial resampling (NCHW).

Counterpart of supervised_gan_tpu/ops/resample.py: `bilinear_upsample`
(:46), the exact-tiling branch of `avg_pool` (:65) and the multi-scale
discriminator front end (`matlab_gauss2d` :129, `gauss_blur_kernel` :141,
`blur_downsample` :177).  The JAX package computes all of them outside
Pallas, so they are plain torch here.  Traps kept: bilinear uses
align_corners=True, and the blur's sigma is scale // 2 (the reference is
Python 2).

The interpolation taps and blur matrices are made on the host once per
size and device and kept there (``_device_constant``): a host-to-device
copy from pageable memory synchronizes the host with the device, and a
captured CUDA graph cannot hold one.  So the first call at a size fills the
cache, and a miss during a graph capture raises.

Under --spatial_mesh (parallel/spatial.py) each takes global indices: a
rank's output rows read the input rows their taps name in the global
image (the bilinear taps' float64 positions of the global height, the
pool's tiles, the rank's rows of the global banded blur matrix), fetched
with their halo.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial


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


# (kind, sizes..., device, dtype) -> the tensors made for it on the device
_DEVICE_CONSTANTS = {}


def _device_constant(key, device, make):
    """The tensors ``make()`` puts on ``device``, made once per key.  A miss
    while a CUDA graph is being captured raises: the copy would synchronize,
    which a capture cannot hold."""
    key = key + (str(device),)
    out = _DEVICE_CONSTANTS.get(key)
    if out is None:
        if device.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            raise RuntimeError('ops.resample: %r is not on the device yet; run '
                               'one eager step before capturing' % (key,))
        out = _DEVICE_CONSTANTS[key] = make()
    return out


def _lerp_axis(x, dim, out_size, align_corners, window=None):
    """The two-tap blend along ``dim``; ``window`` (in_size, lo, hi, a):
    output rows [lo, hi) of a global input of in_size rows, x holding its
    rows from a on."""
    in_size, lo, hi, a = window or (x.shape[dim], 0, out_size, 0)

    def make():
        i0, i1, w0, w1 = [t[lo:hi] for t in _interp_taps(
            in_size, out_size, align_corners)]
        # the weights round to x's dtype, the sum runs in float32
        return tuple([torch.from_numpy(i - a).to(x.device) for i in (i0, i1)]
                     + [torch.from_numpy(w).to(x.device, x.dtype).float()
                        for w in (w0, w1)])

    i0, i1, w0, w1 = _device_constant(
        ('lerp', in_size, out_size, align_corners, x.dtype, lo, hi, a),
        x.device, make)
    shape = [1] * x.dim()
    shape[dim] = hi - lo

    def take(i):
        return x.index_select(dim, i).float()

    return (take(i0) * w0.view(shape) + take(i1) * w1.view(shape)).to(x.dtype)


def bilinear_upsample(x, scale, align_corners=True):
    """x (N, C, H, W) -> (N, C, H*scale, W*scale), torch-0.3 bilinear
    (align_corners=True): height then width, each output a two-tap blend
    whose weights come from float64 positions.  (F.interpolate computes its
    source positions in the input's precision; in float32 that moves them
    by ~1e-6 at 512 px, enough to flip ReLU masks downstream against the
    JAX package.)"""
    h, w = spatial.height(x), x.shape[3]

    def whole(xw):
        return _lerp_axis(xw, 2, h * scale, align_corners)

    def need(lo, hi):
        i0, i1, _, _ = _interp_taps(h, h * scale, align_corners)
        return int(i0[lo:hi].min()), int(i1[lo:hi].max()) + 1

    def run(rows, a, lo, hi):
        return _lerp_axis(rows, 2, h * scale, align_corners, (h, lo, hi, a))

    y = (spatial.map_rows(x, h * scale, need, run, whole) if spatial.active()
         else whole(x))
    return _lerp_axis(y, 3, w * scale, align_corners)


def avg_pool(x, kernel):
    """AvgPool2d(kernel, stride=kernel) on a spatial extent it tiles
    exactly (the CRN label pyramid and the bilinear transform's inverse)."""
    h, w = spatial.height(x), x.shape[3]
    if h % kernel or w % kernel:
        raise ValueError('avg_pool: %dx%d does not tile by %d' % (h, w, kernel))
    if not spatial.active():
        return F.avg_pool2d(x, kernel, kernel)
    return spatial.map_rows(
        x, h // kernel, lambda lo, hi: (lo * kernel, hi * kernel),
        lambda rows, a, lo, hi: F.avg_pool2d(rows, kernel, kernel),
        lambda xw: F.avg_pool2d(xw, kernel, kernel))


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
    h, w = spatial.height(x), x.shape[3]

    def blur(rows, lo, hi, a):
        # rows [lo, hi) of the global matrix, its columns a .. a + len(rows)
        def make():
            full = _blur_matrix(h, scale_factor)[lo:hi]
            win = np.zeros((hi - lo, rows.shape[2]), np.float32)
            c0, c1 = max(a, 0), min(a + rows.shape[2], h)
            win[:, c0 - a:c1 - a] = full[:, c0:c1]
            return tuple(torch.from_numpy(m).to(x.device)
                         for m in (win, _blur_matrix(w, scale_factor)))

        ah, aw = _device_constant(
            ('blur', h, w, scale_factor, lo, hi, a, rows.shape[2]), x.device,
            make)
        y = torch.einsum('oh,nchw->ncow', ah, rows.float())
        y = torch.einsum('pw,ncow->ncop', aw, y)
        return y.to(x.dtype)

    h_out = -(-h // scale_factor)
    if not spatial.active():
        return blur(x, 0, h_out, 0)
    half = 2 * (scale_factor // 2)
    kw = 2 * half + 1
    return spatial.map_rows(
        x, h_out,
        lambda lo, hi: (lo * scale_factor - half,
                        (hi - 1) * scale_factor - half + kw),
        lambda rows, a, lo, hi: blur(rows, lo, hi, a),
        lambda xw: blur(xw, 0, h_out, 0))
