#!/usr/bin/env python3
"""How far one train step under the default (nondeterministic) algorithms
moves apart runs that start from one state, on one CUDA card: the spread
that chip_smoke.py's default-algorithm chunk check is built on.

    python3 scripts/chunk_spread.py [--rounds N] [--eager M] [--dtypes ...]

Each round is chip_smoke.py's _chunk_runs_default with M eager runs: the
bench DSGAN configuration at 512 px, CAPTURE_AFTER steps under deterministic
algorithms (all runs then bitwise equal), then one default-algorithm step,
eager in A0..A(M-1) and the first replay of the captured step in B.  For
each round it prints every pair's relative L2 distance (whole state, worst
tensor, by net) and two verdicts of the check's rule (within twice the
largest eager pair, at least SPREAD_FLOOR): B against the eager runs, as
chip_smoke.py holds it, and each eager run held in B's place against the
others' pairs (the rule's false alarms on runs that have no graph); the
same without the floor under ``unfloored_``.  The summary counts the rounds
with a case over its limits.  One JSON line at the end, and
chiprun_out/chunk_spread.json (rewritten after every round).
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _short(d):
    return dict(whole=d['whole'], worst=d['worst'], name=d['name'],
                groups=d['groups'], losses={k: v for k, v in
                                            d['losses'].items() if v})


def one_round(dtype):
    r = cs._chunk_runs_default(dtype)
    pairs, chunked = r['eager_spread'], r['chunked']
    out = dict(pairs={n: _short(p) for n, p in pairs.items()},
               chunked={n: _short(c) for n, c in chunked.items()})
    eager = sorted({a for n in pairs for a in n.split('-')})
    for rule, floor in (('', cs.SPREAD_FLOOR), ('unfloored_', {})):
        limits = cs._default_limits(pairs, r['losses'], floor)
        loo = {}
        for a in eager:
            rest = {n: p for n, p in pairs.items() if a not in n.split('-')}
            mine = {n: p for n, p in pairs.items() if a in n.split('-')}
            if not rest:
                continue
            lim = cs._default_limits(rest, r['losses'], floor)
            loo[a] = sorted({m for p in mine.values()
                             for m in cs._over_limits(p, lim)})
        out[rule + 'limits'] = limits
        out[rule + 'chunked_over'] = {n: cs._over_limits(c, limits)
                                      for n, c in chunked.items()}
        out[rule + 'eager_held_over'] = loo
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--rounds', type=int, default=8)
    ap.add_argument('--eager', type=int, default=4)
    ap.add_argument('--dtypes', nargs='+', default=['float32'])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('chunk_spread: needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.time()
    cs.build.build_all()
    print('built in %.1f s' % (time.time() - t0))
    cs.EAGER_RUNS = args.eager
    out = dict(card=card, torch=torch.__version__, eager=args.eager,
               rounds={})
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    path = os.path.join(cs.OUT_DIR, 'chunk_spread.json')
    for dtype in args.dtypes:
        rounds = []
        for i in range(args.rounds):
            t = time.time()
            r = one_round(dtype)
            rounds.append(r)
            print('%s round %d (%.1f s): eager pairs whole %s; chunked %s; '
                  'chunked over %s; eager held over %s' % (
                      dtype, i, time.time() - t,
                      ['%.3g' % p['whole'] for p in r['pairs'].values()],
                      ['%.3g' % c['whole'] for c in r['chunked'].values()],
                      {n: v for n, v in r['chunked_over'].items() if v},
                      {n: v for n, v in r['eager_held_over'].items() if v}))
            for n, p in list(r['pairs'].items()) + list(r['chunked'].items()):
                print('    %s whole %.4g worst %.4g (%s) losses %s groups %s'
                      % (n, p['whole'], p['worst'], p['name'], p['losses'],
                         {g: '%.3g' % v for g, v in p['groups'].items()}))
            sys.stdout.flush()
            out['rounds'][dtype] = rounds
            with open(path, 'w') as f:
                json.dump(out, f)
    summary = {dt: dict(
        rounds=len(rs),
        **{rule + k: sum(any(r[rule + k].values()) for r in rs)
           for rule in ('', 'unfloored_')
           for k in ('chunked_over', 'eager_held_over')},
        eager_whole=sorted(p['whole'] for r in rs
                           for p in r['pairs'].values()),
        chunked_whole=sorted(c['whole'] for r in rs
                             for c in r['chunked'].values()))
        for dt, rs in out['rounds'].items()}
    print(json.dumps(dict(card=card, summary=summary)))


if __name__ == '__main__':
    main()
