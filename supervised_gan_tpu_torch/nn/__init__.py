from .core import (Sequential, Conv2d, ConvTranspose2d, BatchNorm2d,
                   InstanceNorm2d, ReLU, LeakyReLU, Tanh, Sigmoid, Dropout,
                   ReflectionPad2d, Upsample, GaussianNoise, count_params,
                   init_weights, set_noise_generator)
from .factory import define_D, define_G, get_norm_layer, print_network

__all__ = [
    "Sequential", "Conv2d", "ConvTranspose2d", "BatchNorm2d",
    "InstanceNorm2d", "ReLU", "LeakyReLU", "Tanh", "Sigmoid", "Dropout",
    "ReflectionPad2d", "Upsample", "GaussianNoise", "count_params",
    "init_weights", "set_noise_generator",
    "define_D", "define_G", "get_norm_layer", "print_network",
]
