"""Dependency-free RGB PNG encoder (reference util/png.py:9-33): a copy of
supervised_gan_tpu/utils/png.py.

Writes rows bottom-up like the reference (its quirk, kept for output
parity); only needs struct+zlib.  Not on the main path — PIL handles IO —
but part of the capability surface for PIL-less environments.
"""

import struct
import zlib


def _chunk(tag, data):
    out = struct.pack('!I', len(data)) + tag + data
    return out + struct.pack('!I', zlib.crc32(tag + data) & 0xffffffff)


def write_png(buf, width, height):
    """buf: raw RGB bytes (width*height*3), rows ordered top-down in memory;
    emitted bottom-up (reference behavior)."""
    width_byte_3 = width * 3
    raw = b''.join(
        b'\x00' + buf[span:span + width_byte_3]
        for span in range((height - 1) * width_byte_3, -1, -width_byte_3))
    return b''.join([
        b'\x89PNG\r\n\x1a\n',
        _chunk(b'IHDR', struct.pack('!2I5B', width, height, 8, 2, 0, 0, 0)),
        _chunk(b'IDAT', zlib.compress(raw, 9)),
        _chunk(b'IEND', b'')])


def save_png(array, path):
    """array: (H, W, 3) uint8."""
    h, w = array.shape[:2]
    with open(path, 'wb') as f:
        f.write(write_png(array.tobytes(), w, h))
