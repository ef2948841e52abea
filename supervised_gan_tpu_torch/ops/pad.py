"""ReflectionPad2d (counterpart of supervised_gan_tpu/ops/pad.py): the
resnet generator's pads and the factorized D2's centred product.

Under --spatial_mesh (parallel/spatial.py) the width is padded on the
rank's own rows and the height through ``map_rows``: each output row of
the padded global height reads the one input row it reflects, so a rank
fetches the span of input rows its output rows reflect and builds its rows
from runs of that window, forward or flipped."""

import torch

from ..parallel import spatial


def _pad(x, dim, lo, hi):
    parts = [x]
    if lo:
        parts.insert(0, x.narrow(dim, 1, lo).flip(dim))
    if hi:
        parts.append(x.narrow(dim, x.shape[dim] - 1 - hi, hi).flip(dim))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _reflect(o, top, h):
    """The input row that output row ``o`` of a pad by ``top`` reflects."""
    r = abs(o - top)
    return 2 * (h - 1) - r if r > h - 1 else r


def _take_rows(t, idx):
    """Rows ``idx`` of t (rows at -2), from runs of consecutive indices,
    each a slice, flipped where it descends."""
    parts, i = [], 0
    while i < len(idx):
        j = i + 1
        step = idx[j] - idx[i] if j < len(idx) else 1
        step = step if step in (1, -1) else 1
        while j < len(idx) and idx[j] - idx[j - 1] == step:
            j += 1
        part = t.narrow(-2, min(idx[i], idx[j - 1]), j - i)
        parts.append(part.flip(-2) if step == -1 and j - i > 1 else part)
        i = j
    return torch.cat(parts, -2) if len(parts) > 1 else parts[0]


def reflection_pad(x, left, right, top, bottom):
    """ReflectionPad2d of NCHW x by (left, right, top, bottom), each less
    than the side it pads: F.pad(mode='reflect')'s values, built from
    slices, flips and one concatenation an axis, so its backward adds no
    atomics (the library's reflection-pad backward on CUDA does, and is not
    deterministic)."""
    x = _pad(x, 3, left, right)
    if not spatial.active():
        return _pad(x, 2, top, bottom)
    h = spatial.height(x)

    def need(lo, hi):
        rows = [_reflect(o, top, h) for o in range(lo, hi)]
        return min(rows), max(rows) + 1

    def run(rows, a, lo, hi):
        return _take_rows(rows, [_reflect(o, top, h) - a
                                 for o in range(lo, hi)])

    return spatial.map_rows(x, h + top + bottom, need, run,
                            lambda xw: _pad(xw, 2, top, bottom))
