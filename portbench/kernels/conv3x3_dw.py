"""conv3x3_dw (csrc/conv3x3_dw.cu): the 3x3 convolution's weight gradient,
a tensor-core GEMM over the pixels split over blocks, then a reduce."""

from ..roofline import conv_peak, nbytes

ENTRIES = ('conv3x3_dw',)
DEVICE_NAMES = ('dw_tc_kernel', 'dw_reduce_kernel')


def cost(entry, args):
    """(x, g) -> f32 (co, ci, 3, 3)."""
    x, g = args[0], args[1]
    n, ci, h, w = x.shape
    co = g.shape[1]
    return (2.0 * co * ci * 9 * n * h * w,
            nbytes(x) + nbytes(g) + 4.0 * co * ci * 9)


def peak(entry, args):
    return conv_peak(args)
