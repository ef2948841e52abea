"""The hand kernels' rooflines: the peaks of one H100 SXM, each kernel call's
operations and bytes from its shapes, and the recorder that collects the
calls of one eager step at the kernel entry points.

Peaks and ``bound_s`` are copied from chip_smoke.py (PEAK_*, bound_ms): the
NVIDIA data sheet's dense rates at 700 W; an f32 convolution on the tensor
cores runs as 3xTF32, a third of the TF32 rate; bytes count each input read
once and each output written once.  The recorder wraps the module-level
names through which the autograd Functions of
``supervised_gan_tpu_torch.ops.kernels.functions`` call the kernel
wrappers (chip_smoke.py record_train_sites' pattern) and unwraps them when
the step is done; it changes no result.
"""

import contextlib

import torch

PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
CONV_KERNELS = ('conv3x3', 'conv3x3_dw', 'conv4s2', 'convt4s2',
                'conv3x3_in_stats', 'conv3x3_in_partial_stats')


def bound_s(flops, nbytes, peak_flops):
    """The least time the chip needs: operations at ``peak_flops`` or bytes
    at the HBM rate, whichever is longer."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def _n(t):
    return 0 if t is None else t.numel() * t.element_size()


def _conv_cost(kernel, args):
    x, w = args[0], args[1]
    b = args[2] if len(args) > 2 else None
    n, ci, h, wd = x.shape
    if kernel in ('conv3x3', 'conv3x3_in_stats', 'conv3x3_in_partial_stats'):
        co = w.shape[0]
        out = n * co * h * wd
        flops = 2.0 * out * ci * 9
    elif kernel == 'conv4s2':
        co = w.shape[0]
        out = n * co * (h // 2) * (wd // 2)
        flops = 2.0 * out * ci * 16
    else:                                   # convt4s2: w (ci, co, 4, 4)
        co = w.shape[1]
        out = n * co * 4 * h * wd
        flops = 2.0 * out * ci * 4
    nbytes = _n(x) + _n(w) + _n(b) + out * x.element_size()
    if kernel != 'conv3x3' and kernel != 'conv4s2' and kernel != 'convt4s2':
        nbytes += 8.0 * n * co           # the statistics
    return flops, nbytes


def cost(kernel, args):
    """(flops, bytes) of one call of ``kernel`` on ``args``."""
    if kernel in ('conv3x3', 'conv4s2', 'convt4s2', 'conv3x3_in_stats',
                  'conv3x3_in_partial_stats'):
        return _conv_cost(kernel, args)
    x = args[0]
    nc = x.shape[0] * x.shape[1]
    if kernel == 'conv3x3_dw':             # (x, g) -> f32 (co, ci, 3, 3)
        g = args[1]
        n, ci, h, w = x.shape
        co = g.shape[1]
        return (2.0 * co * ci * 9 * n * h * w,
                _n(x) + _n(g) + 4.0 * co * ci * 9)
    if kernel == 'instance_norm_act':      # read x, write y, the statistics
        return 6.0 * x.numel(), 2.0 * _n(x) + 8.0 * nc
    if kernel == 'instance_norm_apply':    # (y, mean, rstd) -> act(norm(y))
        return 4.0 * x.numel(), 2.0 * _n(x) + 8.0 * nc
    if kernel == 'instance_norm_bwd':      # read x and g, write dx
        return 10.0 * x.numel(), 3.0 * _n(x) + 8.0 * nc
    raise KeyError(kernel)


def peak(kernel, args):
    if args[0].dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16_FLOPS
    return PEAK_TF32X3_FLOPS if kernel in CONV_KERNELS else PEAK_F32_FLOPS


RECORDED = ('conv3x3', 'conv3x3_dw', 'conv4s2', 'convt4s2',
            'instance_norm_act', 'instance_norm_apply', 'instance_norm_bwd',
            'conv3x3_in_stats', 'conv3x3_in_partial_stats')


@contextlib.contextmanager
def recording(functions):
    """Inside it, every kernel wrapper that ``functions`` (the program's
    ops.kernels.functions module) calls is recorded: yields the list of
    (kernel, flops, bytes, bound seconds) it fills."""
    calls, saved = [], []

    def wrap(name, fn):
        def wrapped(*args, **kw):
            flops, nbytes = cost(name, args)
            calls.append((name, flops, nbytes,
                          bound_s(flops, nbytes, peak(name, args))))
            return fn(*args, **kw)
        return wrapped

    for name in RECORDED:
        fn = getattr(functions, name, None)
        if fn is not None:
            saved.append((name, fn))
            setattr(functions, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved:
            setattr(functions, name, fn)
