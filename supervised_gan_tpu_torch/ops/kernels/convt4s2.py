"""ConvTranspose2d k4 s2 p1 (output padding 0) plus bias: the hand-written
CUDA kernel (csrc/convt4s2.cu) and its plain PyTorch version.

Replaces supervised_gan_tpu/ops/pallas/convt4s2.py `_kernel` (:157) through
`convt4s2` (:269).  The Pallas kernel's lane gate (T*Ci % 128 == 0) leaves
the G1 sites with Ci = 8 and Co = 2 to XLA; this kernel takes every shape,
so all six G1 transposed convs go through it, and so does the dx of every
k4 s2 conv.  It is an implicit GEMM on the tensor cores (bf16 mma.sync; f32
as 3xTF32) over the four output phases at once: a tile of input positions
with a 1-px halo, 9 shifts of it, 16 (shift, tap) pairs, K = the input
channels at each pair, split over blocks where the grid is small
(`tc_plan` says how).  One unit of input channels over at most 16 input
positions (G1's first transposed conv) takes the kernel's CUDA-core loop
instead (`tensor_cores` says which).  Bound on the H100: arithmetic at the
wide sites, bytes at the 1- to 3-channel outputs (see the source note).

Layout: x (N, Ci, H, W), w (Ci, Co, 4, 4) as torch.nn.ConvTranspose2d, b
(Co,) or None; y (N, Co, 2H, 2W) in x's dtype (float32 or bfloat16, f32
accumulation).
"""

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .common import (DTYPE_CODES, bias_arg, check_cuda_inputs, on_cpu,
                     raise_on_error, stream_arg)

_SIGNATURES = {
    'convt4s2_workspace': ([ctypes.c_int] * 5, ctypes.c_longlong),
    'convt4s2_splits': ([ctypes.c_int] * 5, ctypes.c_int),
    'convt4s2_tensor_cores': ([ctypes.c_int] * 5, ctypes.c_int),
    'convt4s2_fwd': ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p], ctypes.c_int),
}

# csrc/convt4s2.cu's tiling: TILE_ROWS x TILE_COLS input positions by
# co_block(Co) output channels a block (32, or 16 for Co <= 16), the input
# channels split over blocks in units of CI_UNIT (one bf16 chunk, two f32
# chunks) while the grid is below resident(Co) blocks: one round of the
# blocks the H100's SMS SMs hold, one wide or two narrow blocks each.
TILE_ROWS, TILE_COLS, CI_UNIT, SMS = 8, 16, 16, 132


def co_block(co):
    return 32 if co > 16 else 16


def resident(co):
    return SMS if co > 16 else 2 * SMS


def tensor_cores(ci, h, w):
    """False for the problems the kernel leaves to its CUDA-core loop: one
    unit of input channels over at most 16 input positions an image (G1's
    first transposed conv, 8 -> 256 on 4^2), where the tensor-core
    pipeline's fill outlasts that loop's whole run."""
    return not (ci <= CI_UNIT and h * w <= 16)


# Output phase q of an axis reads (kernel tap, input offset) pairs: out index
# 2m+q gathers x[m + offset] with weight tap k (convt4s2.py:21-28).
_PHASE_TAPS = (((1, 0), (3, -1)), ((0, 1), (2, 0)))


def tc_plan(n, ci, co, h, w):
    """The kernel's split of the input-channel sum for these shapes (both
    dtypes): [(first, end) unit of CI_UNIT channels of each split].  Each
    split sums its units in order, chunk by chunk; with one split that sum
    plus the bias is y, else the splits' sums are added in order s = 0, 1,
    ... starting from 0, then the bias."""
    blocks = (-(-h // TILE_ROWS) * -(-w // TILE_COLS)
              * -(-co // co_block(co)) * n)
    units = -(-ci // CI_UNIT)
    per = -(-units // max(1, min(units, resident(co) // blocks)))
    return [(k, min(units, k + per)) for k in range(0, units, per)]


def convt4s2_plain(x, w, b=None):
    """The same function as the kernel: each of the four output phases is a
    2x2 gather over the 1-padded input, accumulated in float32, then the
    phases are interleaved."""
    n, ci, h, wd = x.shape
    co = w.shape[1]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w.float()
    rows = []
    for q in range(2):
        cols = []
        for r in range(2):
            acc = None
            for ky, dy in _PHASE_TAPS[q]:
                for kx, dx in _PHASE_TAPS[r]:
                    t = torch.einsum('io,nihw->nohw', wf[:, :, ky, kx],
                                     xp[:, :, 1 + dy:1 + dy + h,
                                        1 + dx:1 + dx + wd])
                    acc = t if acc is None else acc + t
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-1))          # (n, co, h, w, r)
    y = torch.stack(rows, dim=3)                        # (n, co, h, q, w, r)
    y = y.reshape(n, co, 2 * h, 2 * wd)
    if b is not None:
        y = y + b.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def convt4s2(x, w, b=None):
    """CPU tensors take convt4s2_plain; CUDA tensors launch the kernel or
    raise."""
    if on_cpu(x, w, b):
        return convt4s2_plain(x, w, b)
    check_cuda_inputs('convt4s2', x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (4, 4) \
            or w.shape[0] != x.shape[1]:
        raise ValueError('convt4s2: x %s and w %s are not (N, Ci, H, W) and '
                         '(Ci, Co, 4, 4)' % (tuple(x.shape), tuple(w.shape)))
    n, ci, h, wd = x.shape
    co = w.shape[1]
    bf, bptr = bias_arg('convt4s2', b, co, x.device)
    y = torch.empty((n, co, 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
    lib = build.load('convt4s2', _SIGNATURES)
    # f32 partials of the input-channel splits at the deep, small sites
    nws = lib.convt4s2_workspace(n, ci, co, h, wd)
    partials = (torch.empty((nws,), dtype=torch.float32, device=x.device)
                if nws else None)
    with torch.cuda.device(x.device):
        err = lib.convt4s2_fwd(x.data_ptr(), w.data_ptr(), bptr, y.data_ptr(),
                               None if partials is None
                               else partials.data_ptr(),
                               n, ci, co, h, wd, DTYPE_CODES[x.dtype],
                               stream_arg(x))
        convt4s2.launches += 1
    raise_on_error('convt4s2', err)
    return y


convt4s2.launches = 0
