"""device.idle_share: the share of the traced window, in %, in which no
operation ran on the device (1 - the union of the device intervals over
the window)."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
