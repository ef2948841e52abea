"""The hand kernels' rooflines: the peaks of one H100 SXM, the bound of a
call, and the recorder that collects the calls of one eager step at the
kernel entry points, each costed by its family.

Peaks and ``bound_s`` are copied from chip_smoke.py (PEAK_*, bound_ms): the
NVIDIA data sheet's dense rates at 700 W; an f32 convolution on the tensor
cores runs as 3xTF32, a third of the TF32 rate; bytes count each input read
once and each output written once.  What a call costs is its family's
(kernels/<family>.py, found by ``families()``: its entries, its device
operations' names, ``cost`` and ``peak``); ``conv_cost`` and ``conv_peak``
are what the convolution families share.  The recorder wraps the
module-level names through which the autograd Functions of
``supervised_gan_tpu_torch.ops.kernels.functions`` call the kernel
wrappers (chip_smoke.py record_train_sites' pattern) and unwraps them when
the step is done; it changes no result.
"""

import collections
import contextlib
import importlib
from pathlib import Path

import torch

PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

KERNELS = Path(__file__).resolve().parent / 'kernels'

# one recorded call: its entry point, (flops, bytes) from its family's
# cost, the least seconds the chip needs for it, and the family's name
Site = collections.namedtuple('Site', 'entry flops bytes bound_s family')


def bound_s(flops, nbytes, peak_flops):
    """The least time the chip needs: operations at ``peak_flops`` or bytes
    at the HBM rate, whichever is longer."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def nbytes(t):
    """Bytes of tensor ``t``; 0 for None."""
    return 0 if t is None else t.numel() * t.element_size()


def conv_cost(args, co, out_hw, taps, stats=False):
    """(flops, bytes) of a convolution call on ``args`` (x (n, ci, h, w),
    w, b, ...) that writes ``co`` channels of ``out_hw`` pixels each, every
    output a sum over ``taps`` taps of all ci input channels; with
    ``stats`` also the (n, co) mean and rstd, 4 bytes each."""
    x, w = args[0], args[1]
    b = args[2] if len(args) > 2 else None
    n, ci = x.shape[0], x.shape[1]
    out = n * co * out_hw
    nb = nbytes(x) + nbytes(w) + nbytes(b) + out * x.element_size()
    if stats:
        nb += 8.0 * n * co
    return 2.0 * out * ci * taps, nb


def conv_peak(args):
    """A convolution's rate: bf16 on the tensor cores; f32 as 3xTF32."""
    if args[0].dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16_FLOPS
    return PEAK_TF32X3_FLOPS


def families():
    """{family name: module} of every kernels/<family>.py."""
    return {p.stem: importlib.import_module('%s.kernels.%s'
                                            % (__package__, p.stem))
            for p in sorted(KERNELS.glob('[!_]*.py'))}


@contextlib.contextmanager
def recording(functions, fams):
    """Inside it, every entry point of the families ``fams`` ({name:
    module}, as ``families()`` gives them) that ``functions`` (the
    program's ops.kernels.functions module) holds is recorded: yields the
    list of ``Site`` it fills."""
    calls, saved, owner = [], [], {}
    for family, fam in fams.items():
        for entry in fam.ENTRIES:
            if entry in owner:
                raise ValueError('entry %r is in families %r and %r'
                                 % (entry, owner[entry], family))
            owner[entry] = family

    def wrap(entry, family, fn):
        fam = fams[family]

        def wrapped(*args, **kw):
            flops, nb = fam.cost(entry, args)
            calls.append(Site(entry, flops, nb,
                              bound_s(flops, nb, fam.peak(entry, args)),
                              family))
            return fn(*args, **kw)
        return wrapped

    for entry, family in owner.items():
        fn = getattr(functions, entry, None)
        if fn is not None:
            saved.append((entry, fn))
            setattr(functions, entry, wrap(entry, family, fn))
    try:
        yield calls
    finally:
        for entry, fn in saved:
            setattr(functions, entry, fn)
