"""dispatch.host_ms_per_step: host ms from a dispatch's start to the return
of its call, before its synchronize, per step, over the run's window."""


def read(r):
    return sum(w[1] - w[0] for w in r.window) / r.window_steps() * 1e3
