"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel (counting the launch in ``<wrapper>.launches``)
or raises.  ``functions`` holds the autograd Functions built on them.

Whether the ops reach them at all is one switch, ``set_kernels_enabled``:
on (the default), ``ops.conv`` and ``ops.norm`` dispatch to the Functions;
off (``--no_pallas``), every site takes its PyTorch library call instead.
"""

from .conv3x3 import conv3x3, conv3x3_plain
from .conv3x3_dw import conv3x3_dw, conv3x3_dw_plain
from .conv3x3_in import conv3x3_in_stats, conv3x3_in_stats_plain
from .conv4s2 import conv4s2, conv4s2_plain
from .convt4s2 import convt4s2, convt4s2_plain
from .instance_norm import (
    instance_norm_act, instance_norm_act_plain, instance_norm_apply,
    instance_norm_apply_plain, instance_norm_bwd, instance_norm_bwd_plain,
    instance_norm_partial_stats, instance_norm_partial_stats_plain,
    instance_norm_bwd_partial_stats, instance_norm_bwd_partial_stats_plain,
    instance_norm_bwd_apply, instance_norm_bwd_apply_plain)
from .functions import (Conv3x3, Conv3x3InAct, Conv4s2, ConvT4s2,
                        InstanceNormAct, InstanceNormActRows)

# The dispatch switch: the counterpart of the JAX package's PALLAS_ENABLED
# and set_pallas_enabled (nn/core.py:85-120 there), which its model init sets
# from --no_pallas (models/base.py:236-242 there), as models/base.py does
# here.  Read at every call, so a model built later switches the route.
_KERNELS_ENABLED = True


def set_kernels_enabled(flag):
    global _KERNELS_ENABLED
    _KERNELS_ENABLED = bool(flag)


def kernels_enabled():
    return _KERNELS_ENABLED


KERNELS = (conv3x3, convt4s2, instance_norm_act, conv3x3_dw,
           instance_norm_bwd, conv4s2, conv3x3_in_stats, instance_norm_apply,
           instance_norm_partial_stats, instance_norm_bwd_partial_stats,
           instance_norm_bwd_apply)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_dw", "conv3x3_dw_plain",
           "conv3x3_in_stats", "conv3x3_in_stats_plain",
           "conv4s2", "conv4s2_plain", "convt4s2", "convt4s2_plain",
           "instance_norm_act", "instance_norm_act_plain",
           "instance_norm_apply", "instance_norm_apply_plain",
           "instance_norm_bwd", "instance_norm_bwd_plain",
           "instance_norm_partial_stats", "instance_norm_partial_stats_plain",
           "instance_norm_bwd_partial_stats",
           "instance_norm_bwd_partial_stats_plain",
           "instance_norm_bwd_apply", "instance_norm_bwd_apply_plain",
           "Conv3x3", "Conv3x3InAct", "Conv4s2", "ConvT4s2",
           "InstanceNormAct", "InstanceNormActRows", "KERNELS", "reset_launch_counts",
           "launch_counts", "set_kernels_enabled", "kernels_enabled"]
