"""conv3x3_in (csrc/conv3x3_in.cu): conv3x3's tensor-core loop with the
instance-norm statistics in its epilogue, then a fold kernel; the whole
plane, or a row range of it."""

from ..roofline import conv_cost, conv_peak

ENTRIES = ('conv3x3_in_stats', 'conv3x3_in_partial_stats')
DEVICE_NAMES = ('conv3x3_in_tc_kernel', 'conv3x3_in_fold_kernel')


def cost(entry, args):
    """(x, w (co, ci, 3, 3), b, ...) -> y (n, co, h, w) and (n, co)
    statistics."""
    x, w = args[0], args[1]
    return conv_cost(args, w.shape[0], x.shape[2] * x.shape[3], 9, True)


def peak(entry, args):
    return conv_peak(args)
