"""The port's dependency-free PNG encoder (supervised_gan_tpu_torch/utils/
png.py) against the JAX package's: the same bytes, the reference's
bottom-up rows as PIL reads them, and the port's native decoder reading
its files."""

import numpy as np
import pytest
from PIL import Image

from supervised_gan_tpu.utils import png as jpng
from supervised_gan_tpu_torch.data import native_io
from supervised_gan_tpu_torch.utils import png

SHAPES = [(1, 1), (16, 24), (7, 33), (64, 48), (129, 5)]


@pytest.mark.parametrize('h,w', SHAPES)
def test_write_png_bytes_equal_jax(h, w):
    a = np.random.RandomState(h * 1000 + w).randint(
        0, 256, (h, w, 3)).astype(np.uint8)
    assert png.write_png(a.tobytes(), w, h) == jpng.write_png(a.tobytes(),
                                                              w, h)


@pytest.mark.parametrize('h,w', SHAPES)
def test_save_png_reads_back_flipped(tmp_path, h, w):
    """The reference writes rows bottom-up: PIL and the port's decoder read
    the image flipped top to bottom, and the file equals JAX's."""
    a = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    p, q = str(tmp_path / 'ours.png'), str(tmp_path / 'jax.png')
    png.save_png(a, p)
    jpng.save_png(a, q)
    assert open(p, 'rb').read() == open(q, 'rb').read()
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert('RGB')),
                                  a[::-1])
    np.testing.assert_array_equal(native_io.decode_png(p), a[::-1])
