"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel (counting the launch in ``<wrapper>.launches``)
or raises.  ``functions`` holds the autograd Functions built on them."""

from .conv3x3 import conv3x3, conv3x3_plain
from .conv3x3_dw import conv3x3_dw, conv3x3_dw_plain
from .conv3x3_in import conv3x3_in_stats, conv3x3_in_stats_plain
from .conv4s2 import conv4s2, conv4s2_plain
from .convt4s2 import convt4s2, convt4s2_plain
from .instance_norm import (instance_norm_act, instance_norm_act_plain,
                            instance_norm_apply, instance_norm_apply_plain,
                            instance_norm_bwd, instance_norm_bwd_plain)
from .functions import (Conv3x3, Conv3x3InAct, Conv4s2, ConvT4s2,
                        InstanceNormAct)

KERNELS = (conv3x3, convt4s2, instance_norm_act, conv3x3_dw,
           instance_norm_bwd, conv4s2, conv3x3_in_stats, instance_norm_apply)


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
           "Conv3x3", "Conv3x3InAct", "Conv4s2", "ConvT4s2",
           "InstanceNormAct", "KERNELS", "reset_launch_counts",
           "launch_counts"]
