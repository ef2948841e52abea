"""kernels.ms_per_step: device ms a step of the port's hand kernels (the
device operations that any kernels/<family>.py names in DEVICE_NAMES) in
the traced stretch; nothing where none ran."""


def read(r):
    s = sum(i.end - i.start for i in r.trace.device if r.is_hand(i.name))
    return s / r.trace.steps * 1e3 if s > 0 else None
