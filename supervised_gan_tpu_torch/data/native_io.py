"""ctypes binding of the native PNG decoder (csrc/dataio.cpp): the
counterpart of the JAX package's data/native_io.py.

The library is built at first use, never at import, with

    g++ -O3 -shared -fPIC csrc/dataio.cpp -lz

into ``build/libdataio-<hash>.so``, the hash covering the source, the
compiler and its flags (as ops/kernels/build.py names the CUDA libraries):
an edited source rebuilds, and a warm checkout reuses the library.  The
compiler writes a file of its own and renames it into place, so processes
and threads that build at once never load a half-written library.  It is
loaded with ``ctypes.CDLL``, which releases the GIL for each call, so the
loader's threads decode side by side.

A failed build raises, with the compiler's message: the decoder is the
port's own path and is never dropped silently.  ``--no_native_io`` or
``SGAN_TPU_NO_NATIVE_IO=1`` switch it off for the process (data/
transforms.py).  A file outside the decoder's scope (16-bit, interlaced,
not a PNG) gives ``None`` and the caller decodes it with PIL; PNG is
lossless, so the pixels are the same either way.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / 'csrc' / 'dataio.cpp'
BUILD_DIR = PKG_DIR / 'build'
CXX = 'g++'
CXX_FLAGS = ('-O3', '-shared', '-fPIC')
LIBS = ('-lz',)

_lock = threading.Lock()
_lib = None


def library_path():
    key = SOURCE.read_bytes() + ' '.join((CXX,) + CXX_FLAGS + LIBS).encode()
    return BUILD_DIR / ('libdataio-%s.so'
                        % hashlib.sha256(key).hexdigest()[:16])


def build():
    """The decoder's library, compiled if it is missing.  Raises
    RuntimeError with the compiler's message if it cannot be built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name('%s.tmp%d-%d' % (out.name, os.getpid(),
                                         threading.get_ident()))
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), *LIBS, '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError('the PNG decoder could not be built (%s): %s'
                           % (' '.join(cmd), e)) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError('the PNG decoder could not be built (%s, exit '
                           '%d):\n%s' % (' '.join(cmd), proc.returncode,
                                         proc.stdout + proc.stderr))
    os.replace(tmp, out)
    return out


def load():
    """The decoder's ctypes library, built and loaded once a process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.png_dims.restype = ctypes.c_int
            lib.png_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.decode_png_rgb.restype = ctypes.c_int
            lib.decode_png_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
            _lib = lib
        return _lib


def decode_png(path):
    """Decode a PNG file to an (H, W, 3) uint8 array, or None where the
    file cannot be read or lies outside the decoder's scope (the caller
    falls back to PIL)."""
    lib = load()
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.png_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.decode_png_rgb(data, len(data),
                          out.ctypes.data_as(ctypes.c_char_p)) != 0:
        return None
    return out
