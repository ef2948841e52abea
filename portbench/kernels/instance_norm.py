"""instance_norm (csrc/instance_norm.cu): instance norm and its activation,
forward, apply with given statistics and backward, each plane in one block
or a cluster of blocks (two passes for planes past that)."""

import torch

from ..roofline import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, nbytes

ENTRIES = ('instance_norm_act', 'instance_norm_apply', 'instance_norm_bwd')
DEVICE_NAMES = ('in_stats_kernel', 'in_fold_kernel', 'in_norm_kernel',
                'in_apply_kernel', 'in_fwd_plane_kernel',
                'in_bwd_plane_kernel', 'in_bwd_stats_kernel',
                'in_bwd_apply_kernel')


def cost(entry, args):
    x = args[0]
    nc = x.shape[0] * x.shape[1]
    if entry == 'instance_norm_act':       # read x, write y, the statistics
        return 6.0 * x.numel(), 2.0 * nbytes(x) + 8.0 * nc
    if entry == 'instance_norm_apply':     # (y, mean, rstd) -> act(norm(y))
        return 4.0 * x.numel(), 2.0 * nbytes(x) + 8.0 * nc
    if entry == 'instance_norm_bwd':       # read x and g, write dx
        return 10.0 * x.numel(), 3.0 * nbytes(x) + 8.0 * nc
    raise KeyError(entry)


def peak(entry, args):
    """bf16 at the tensor cores' rate, f32 at the CUDA cores' (the bytes
    bound these calls either way)."""
    if args[0].dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16_FLOPS
    return PEAK_F32_FLOPS
