"""conv3x3 (csrc/conv3x3.cu): the tensor-core 3x3 stride-1 pad-1
convolution, forward and dx."""

from ..roofline import conv_cost, conv_peak

ENTRIES = ('conv3x3',)
DEVICE_NAMES = ('conv3x3_tc_kernel',)


def cost(entry, args):
    """(x, w (co, ci, 3, 3), b) -> y (n, co, h, w)."""
    x, w = args[0], args[1]
    return conv_cost(args, w.shape[0], x.shape[2] * x.shape[3], 9)


def peak(entry, args):
    return conv_peak(args)
