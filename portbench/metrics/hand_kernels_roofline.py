"""hand_kernels_roofline: the hand kernels' share of their roofline, in %:
the sum of each call's bound (roofline.py, from the shapes recorded at
every family's entry points in one eager set-up step, costed by its
kernels/<family>.py, times the traced steps) over the device time of every
family's kernels in the traced stretch.  Nothing where no call was
recorded or no hand kernel ran."""


def read(r):
    bound = sum(s.bound_s for s in r.sites) * r.trace.steps
    spent = sum(i.end - i.start for i in r.trace.device if r.is_hand(i.name))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
