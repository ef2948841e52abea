"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel (counting the launch in ``<wrapper>.launches``)
or raises."""

from .conv3x3 import conv3x3, conv3x3_plain
from .convt4s2 import convt4s2, convt4s2_plain
from .instance_norm import instance_norm_act, instance_norm_act_plain

KERNELS = (conv3x3, convt4s2, instance_norm_act)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["conv3x3", "conv3x3_plain", "convt4s2", "convt4s2_plain",
           "instance_norm_act", "instance_norm_act_plain", "KERNELS",
           "reset_launch_counts", "launch_counts"]
