"""What decides ``correct``: three readings of the checked train steps
(the program's eager steps, then one dispatch of the window's size; see
harness.py), taken from the program in set-up and from the plain
reference after the window, and the gap between the two sides' readings.

Readings:
  losses   the losses of each checked dispatch's last step by the recipe's
           names (a chunk reports its last step's);
  moments  each parameter's Adam first moment after the first step, as a
           norm (the first gradient times 1 - beta1 where one optimizer
           step is one train step; where a recipe steps G twice a train
           step, its moment mixes both gradients alike on both sides);
  change   each parameter's change over all the checked steps, as a norm.

Gaps (each number is compared with its limit, from the workload file):
  lossN   max over step N's losses of |p - r| / |r|, N the step that ends
          each checked dispatch (1, 2 and 12 for two eager steps and a
          chunk of 10);
  grad    max over parameters of |p - r| / max(r, median r) of the
          moments' norms (a parameter the program never stepped reads 0);
  <subset> a workload file's "subsets" name numbers of their own:
          {"of": "lossN", "losses": [names]} is lossN over those losses
          alone (the terms that stay steady from seed to seed where the
          others swing, see PERF.md);
  change  the same of the changes' norms, over the parameters whose
          reference moment is at least a thousandth of the median one: a
          bias that a norm cancels has a moment of rounding size, which
          Adam turns into a step of +-lr on the reference side alone.
"""

import statistics

EXCLUDE_BELOW = 1e-3


def norms(tensors):
    """{key: float L2 norm} of {key: tensor}, in float64."""
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def change(params, start):
    """{key: norm of params[key] - start[key]}."""
    return {k: float((p.detach().double() - start[k].double()).norm())
            for k, p in params.items()}


def _leaf_gaps(prog, ref, keys):
    """{key: |p - r| / max(r, median r)} over ``keys``."""
    floor = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30)
            for k in keys}


def _worst(leaf):
    at = max(leaf, key=leaf.get)
    return leaf[at], at


def _loss_gap(lp, lr, names):
    """(max over ``names`` of |p - r| / |r|, its loss); a loss the program
    lacks reads NaN."""
    worst, at = 0.0, None
    for k in names:
        r = lr[k]
        g = abs(lp.get(k, float('nan')) - r) / max(abs(r), 1e-30)
        if g > worst or g != g:
            worst, at = g, k
    return worst, at


def gaps(prog, ref, subsets=None):
    """{number: (gap, where)} of a program's readings against the
    reference's: lossN for each checked dispatch, each of ``subsets``,
    grad, change."""
    out = {}
    by_number = {}
    for i, (lr, step) in enumerate(zip(ref['losses'], ref['steps'])):
        lp = prog['losses'][i] if i < len(prog['losses']) else {}
        by_number['loss%d' % step] = (lp, lr)
        out['loss%d' % step] = _loss_gap(lp, lr, list(lr))
    for name, sub in (subsets or {}).items():
        lp, lr = by_number[sub['of']]
        out[name] = _loss_gap(lp, lr, sub['losses'])
    moments = ref['moments']
    leaf = _leaf_gaps(prog['moments'], moments, list(moments))
    out['grad'] = _worst(leaf)
    floor = statistics.median(moments.values()) * EXCLUDE_BELOW
    kept = [k for k in ref['change'] if moments.get(k, 0.0) >= floor]
    out['change'] = _worst(_leaf_gaps(prog['change'], ref['change'], kept))
    return out


def verdict(found, limits):
    """(correct, {number: {'value', 'limit'}}): every number within its
    limit, a NaN never."""
    checks = {k: {'value': found[k][0], 'limit': limits[k]} for k in limits}
    ok = all(v['value'] <= v['limit'] for v in checks.values())
    return ok, checks
