"""conv4s2 (csrc/conv4s2.cu): the 4x4 stride-2 pad-1 convolution, an
implicit GEMM on the tensor cores, split over blocks at small grids."""

from ..roofline import conv_cost, conv_peak

ENTRIES = ('conv4s2',)
DEVICE_NAMES = ('conv4s2_tc_kernel', 'conv4s2_reduce_kernel')


def cost(entry, args):
    """(x, w (co, ci, 4, 4), b) -> y (n, co, h / 2, w / 2)."""
    x, w = args[0], args[1]
    return conv_cost(args, w.shape[0], (x.shape[2] // 2) * (x.shape[3] // 2),
                     16)


def peak(entry, args):
    return conv_peak(args)
