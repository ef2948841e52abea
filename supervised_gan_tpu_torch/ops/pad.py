"""ReflectionPad2d (counterpart of supervised_gan_tpu/ops/pad.py): the
resnet generator's pads and the factorized D2's centred product."""

import torch


def reflection_pad(x, left, right, top, bottom):
    """ReflectionPad2d of NCHW x by (left, right, top, bottom), each less
    than the side it pads: F.pad(mode='reflect')'s values, built from
    slices, flips and one concatenation an axis, so its backward adds no
    atomics (the library's reflection-pad backward on CUDA does, and is not
    deterministic)."""
    def pad(x, dim, lo, hi):
        parts = [x]
        if lo:
            parts.insert(0, x.narrow(dim, 1, lo).flip(dim))
        if hi:
            parts.append(x.narrow(dim, x.shape[dim] - 1 - hi, hi).flip(dim))
        return torch.cat(parts, dim) if len(parts) > 1 else x
    return pad(pad(x, 3, left, right), 2, top, bottom)
