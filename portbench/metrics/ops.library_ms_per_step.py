"""ops.library_ms_per_step: device ms a step of every operation of the
traced stretch that is not one of the port's hand kernels (cuDNN, cuBLAS,
aten's elementwise and reduction kernels, copies and sets)."""


def read(r):
    s = sum(i.end - i.start for i in r.trace.device if not r.is_hand(i.name))
    return s / r.trace.steps * 1e3
