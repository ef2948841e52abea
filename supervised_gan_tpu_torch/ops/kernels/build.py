"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` of the package compiles on its own into
``build/lib<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and is loaded with ``ctypes`` (plain C entry points: pointers, ints and the
CUDA stream as integers; each returns ``cudaGetLastError()``).  The hash
covers the source, the shared headers (``csrc/*.cuh``) and the flags, so a
warm run reuses the library and an edited source or header rebuilds.  ``build_all`` starts one ``nvcc`` per source, all at
once, and waits for every one of them.  Builds happen at first use, never at
import: the CPU tests import every module on a machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
SOURCES = ('conv3x3', 'conv3x3_dw', 'conv3x3_in', 'conv4s2', 'convt4s2',
           'instance_norm')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_libs = {}
_lock = threading.Lock()


def nvcc_path():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                           'cannot be built on this machine')
    return found


def library_path(name):
    src = (CSRC_DIR / ('%s.cu' % name)).read_bytes()
    src += b''.join(p.read_bytes() for p in sorted(CSRC_DIR.glob('*.cuh')))
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ('lib%s-%s.so' % (name, digest[:16]))


def build_all(names=SOURCES):
    """Compile every named source whose library is missing, one nvcc per
    source, all in parallel.  Returns {name: ptxas report} for the sources
    built now (the report is also kept beside the library as ``.log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_suffix('.so.tmp%d' % os.getpid())
            cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
                   str(CSRC_DIR / ('%s.cu' % name))]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append('%s (exit %d):\n%s' % (name, proc.returncode,
                                                     log))
                continue
            os.replace(tmp, out)
            out.with_suffix('.log').write_text(log)
            reports[name] = log
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return reports


def load(name, signatures):
    """The ctypes library of csrc/<name>.cu, built if needed.  ``signatures``
    maps each C entry point to (argtypes, restype)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
