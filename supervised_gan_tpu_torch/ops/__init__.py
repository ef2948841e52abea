from .conv import (conv2d, conv3x3_in_act, conv3x3_in_supported,
                   conv_transpose2d)
from .norm import instance_norm_act, batch_norm
from .pad import reflection_pad
from .resample import avg_pool, bilinear_upsample, blur_downsample

__all__ = [
    "conv2d", "conv_transpose2d", "conv3x3_in_act", "conv3x3_in_supported",
    "instance_norm_act", "batch_norm", "reflection_pad",
    "avg_pool", "bilinear_upsample", "blur_downsample",
]
