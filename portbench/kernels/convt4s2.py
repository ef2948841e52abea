"""convt4s2 (csrc/convt4s2.cu): the 4x4 stride-2 pad-1 transposed
convolution, an implicit GEMM over the four output phases (a CUDA-core
loop for the smallest inputs), split over blocks at small grids."""

from ..roofline import conv_cost, conv_peak

ENTRIES = ('convt4s2',)
DEVICE_NAMES = ('convt4s2_tc_kernel', 'convt4s2_cc_kernel',
                'convt4s2_reduce_kernel')


def cost(entry, args):
    """(x, w (ci, co, 4, 4), b) -> y (n, co, 2 h, 2 w); each output sums 4
    of the 16 taps."""
    x, w = args[0], args[1]
    return conv_cost(args, w.shape[1], 4 * x.shape[2] * x.shape[3], 4)


def peak(entry, args):
    return conv_peak(args)
