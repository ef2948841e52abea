"""Image conversion (counterpart of supervised_gan_tpu/utils/images.py).

``tensor2im`` gives output-file parity with the reference (util/util.py:
15-24): batch element 0, [-1, 1] -> [0, 255] uint8; 1-channel images are
repeated to RGB, 2-channel images get a zero blue channel.  The input here
is an NCHW torch tensor.
"""

import os

import numpy as np
from PIL import Image


def tensor2im(image, imtype=np.uint8):
    """image: (N, C, H, W) tensor in [-1, 1] -> (H, W, 3) uint8."""
    arr = image[0].detach().float().cpu().numpy().transpose(1, 2, 0)
    arr = (arr + 1) / 2.0 * 255.0
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif arr.shape[-1] == 2:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (1,), dtype=arr.dtype)], axis=-1)
    return arr.astype(imtype)


def save_image(image_numpy, image_path):
    Image.fromarray(image_numpy).save(image_path)


def mkdirs(paths):
    for p in (paths if isinstance(paths, (list, tuple)) else [paths]):
        os.makedirs(p, exist_ok=True)
