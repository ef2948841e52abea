"""Image load + augmentation transforms: a copy of supervised_gan_tpu/data/
transforms.py.  PNGs are decoded by the native decoder (data/native_io.py
with csrc/dataio.cpp), other files and PNGs outside its scope by PIL.

Replicates the reference augmentation semantics (data/base_dataset.py:17-55):
bilinear resize to loadSize, random crop to fineSize, random horizontal
flip, random k*90-degree rotation, then [-1,1] normalization — but driven by
an explicit seeded numpy Generator instead of the global ``random`` module,
so the pipeline is deterministic under --manualSeed regardless of worker
scheduling.

Images are HWC float32 throughout; the model moves them to NCHW.
"""

import os

import numpy as np
from PIL import Image


_NATIVE_IO = os.environ.get('SGAN_TPU_NO_NATIVE_IO', '') == ''


def load_rgb(path):
    """Load an image as PIL RGB. PNGs go through the native (GIL-free)
    decoder -- bit-exact with PIL since PNG is lossless -- so the loader's
    threads decode side by side; a PNG outside its scope goes to PIL.  Set
    SGAN_TPU_NO_NATIVE_IO=1 (or pass --no_native_io) to force PIL."""
    if _NATIVE_IO and path.endswith(('.png', '.PNG')):
        from . import native_io
        arr = native_io.decode_png(path)
        if arr is not None:
            return Image.fromarray(arr)
    return Image.open(path).convert('RGB')


def resize_bilinear(img, size):
    """PIL bilinear resize to (size, size) (transforms.Scale semantics)."""
    if img.size == (size, size):
        return img
    return img.resize((size, size), Image.BILINEAR)


def scale_width(img, target_width):
    ow, oh = img.size
    if ow == target_width:
        return img
    return img.resize((target_width, int(target_width * oh / ow)),
                      Image.BILINEAR)


def to_array(img):
    """PIL -> HWC float32 in [-1, 1] (ToTensor + Normalize(0.5, 0.5))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr * 2.0 - 1.0


def random_crop(arr, size, rng):
    h, w = arr.shape[:2]
    if h == size and w == size:
        return arr
    top = rng.integers(0, h - size + 1)
    left = rng.integers(0, w - size + 1)
    return arr[top:top + size, left:left + size]


def random_hflip(arr, rng):
    if rng.random() < 0.5:
        return arr[:, ::-1]
    return arr


def random_rot90(arr, rng):
    """k*90-degree rotation, k ~ U{0..3} (reference base_dataset.py:52-55;
    90-degree multiples are exact, so bilinear resample is a no-op)."""
    k = int(rng.integers(0, 4))
    if k:
        return np.rot90(arr, k)
    return arr


def build_transform_parts(opt, train):
    """The pipeline split at its deterministic/random boundary:

      prefix(PIL_image) -> HWC uint8   (decode-side: resize only — the
                                        expensive, path-deterministic part,
                                        cacheable across epochs)
      finish(uint8, rng) -> HWC f32    (crop/flip/rot views + [-1,1]
                                        normalize of just the crop)

    Cropping the uint8 array BEFORE float conversion is bit-identical to
    converting first (normalize is per-pixel) and matches the reference's
    own op order (torchvision RandomCrop on the PIL image, then
    ToTensor+Normalize) while converting fineSize^2 instead of
    loadSize^2 pixels."""
    mode = opt.resize_or_crop

    def prefix(img):
        if mode == 'resize_and_crop':
            img = resize_bilinear(img, opt.loadSize)
        elif mode == 'scale_width':
            img = scale_width(img, opt.fineSize)
        elif mode == 'scale_width_and_crop':
            img = scale_width(img, opt.loadSize)
        elif mode == 'crop':
            pass
        else:
            raise NotImplementedError('resize_or_crop [%s]' % mode)
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    def finish(arr, rng):
        if mode in ('resize_and_crop', 'crop', 'scale_width_and_crop'):
            arr = random_crop(arr, opt.fineSize, rng)
        if train and not opt.no_flip:
            arr = random_hflip(arr, rng)
        if train and not opt.no_rotate:
            arr = random_rot90(arr, rng)
        return np.ascontiguousarray(
            arr.astype(np.float32) / 255.0 * 2.0 - 1.0)

    return prefix, finish


def build_transform(opt, train):
    """Returns f(PIL_image, rng) -> HWC float32 in [-1,1]."""
    prefix, finish = build_transform_parts(opt, train)

    def transform(img, rng):
        return finish(prefix(img), rng)

    return transform


IMG_EXTENSIONS = ('.jpg', '.JPG', '.jpeg', '.JPEG',
                  '.png', '.PNG', '.ppm', '.PPM', '.bmp', '.BMP')


def make_dataset(directory):
    """Recursive sorted scan for image files (reference data/image_folder.py:14-34)."""
    assert os.path.isdir(directory), '%s is not a valid directory' % directory
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in fnames:
            if fname.endswith(IMG_EXTENSIONS):
                images.append(os.path.join(root, fname))
    return images
