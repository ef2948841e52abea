"""Checks and arguments shared by the kernel wrappers."""

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors):
    """True when every tensor lies on the CPU (the wrappers then take their
    plain version).  A CUDA tensor must go to the kernel; anything else is
    refused."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {'cpu'}:
        return True
    if devs != {'cuda'}:
        raise ValueError('kernel inputs must all lie on the CPU or all on one '
                         'CUDA device, got %s' % sorted(devs))
    return False


def check_cuda_inputs(name, x, *others):
    """Raise unless x and every other tensor share one CUDA device, one of
    the kernel dtypes, and are contiguous."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError('%s: dtype %s not supported (float32 | bfloat16)'
                        % (name, x.dtype))
    for t in (x,) + others:
        if t.device != x.device:
            raise ValueError('%s: inputs on %s and %s' % (name, x.device,
                                                          t.device))
        if t.dtype != x.dtype:
            raise TypeError('%s: mixed dtypes %s and %s' % (name, x.dtype,
                                                           t.dtype))
        if not t.is_contiguous():
            raise ValueError('%s: inputs must be contiguous' % name)


def bias_arg(name, b, co, device):
    """(kept tensor, pointer) for an optional bias of shape (co,), passed to
    the kernels in float32."""
    if b is None:
        return None, None
    if b.shape != (co,) or b.device != device:
        raise ValueError('%s: bias must have shape (%d,) on %s, got %s on %s'
                         % (name, co, device, tuple(b.shape), b.device))
    bf = b.to(torch.float32).contiguous()
    return bf, bf.data_ptr()


def stream_arg(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(name, err):
    if err != 0:
        raise RuntimeError('%s: CUDA kernel launch failed with cudaError %d'
                           % (name, err))


# ctypes signature of the conv entry points: x, w, bias, y, N, Ci, Co, H, W,
# dtype, stream
CONV_SIGNATURE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p], ctypes.c_int)
