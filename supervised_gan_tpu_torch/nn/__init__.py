from .core import (Sequential, Conv2d, ConvTranspose2d, BatchNorm2d,
                   InstanceNorm2d, ReLU, LeakyReLU, Tanh, Upsample,
                   count_params, init_weights)
from .factory import define_G, get_norm_layer, print_network

__all__ = [
    "Sequential", "Conv2d", "ConvTranspose2d", "BatchNorm2d",
    "InstanceNorm2d", "ReLU", "LeakyReLU", "Tanh", "Upsample",
    "count_params", "init_weights", "define_G", "get_norm_layer",
    "print_network",
]
