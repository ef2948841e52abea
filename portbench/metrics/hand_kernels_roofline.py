"""hand_kernels_roofline: the hand kernels' share of their roofline, in %:
the sum of each call's bound (roofline.py, from the shapes recorded at the
kernel entry points in one eager set-up step, times the traced steps) over
the hand kernels' device time in the traced stretch.  Nothing where no
call was recorded or no hand kernel ran."""


def read(r):
    bound = sum(c[3] for c in r.sites) * r.trace.steps
    spent = sum(i.end - i.start for i in r.trace.device if r.is_hand(i.name))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
