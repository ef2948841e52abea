#!/usr/bin/env python3
"""How far a data-parallel run lands from one-process runs of the same
steps, and one-process runs from each other, on one CUDA card: the spread
that chip_smoke.py's data-mesh check (phase_data_mesh) is floored by.

    python3 scripts/data_mesh_spread.py [--rounds N]

Each round is chip_smoke.py's dm_compare: the bench DSGAN configuration in
f32 at the global batch DM_BATCH, DM_STEPS steps under the default
algorithms, DM_RUNS one-process runs and one run of DM_BATCH gloo ranks on
cuda:0 (one row each).  For each round it prints the relative L2 distances
(whole state, worst tensor) and each loss's relative difference, of the
one-process pairs and of the sharded run against each one-process run, and
whether the check's rule (dm_limits with DM_SPREAD_FLOOR) passes it; the
summary holds the largest of each.  One JSON line at the end, and
chiprun_out/data_mesh_spread.json (rewritten after every round).
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


def _short(d, losses):
    return dict(whole=d['whole'], worst=d['worst'], name=d['name'],
                loss_rel={k: v / max(abs(losses[k]), 1e-30)
                          for k, v in d['losses'].items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=4)
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build_all()
    os.makedirs(cs.RESULTS_DIR, exist_ok=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    rounds = []
    for r in range(args.rounds):
        t0 = time.time()
        ones, ranks, pairs, sharded = cs.dm_compare()
        losses = ones[0]['losses']
        limits = cs.dm_limits(pairs, losses)
        rnd = dict(pairs={n: _short(p, losses) for n, p in pairs.items()},
                   sharded={n: _short(d, losses) for n, d in sharded.items()},
                   over={n: cs._over_limits(d, limits)
                         for n, d in sharded.items()},
                   rank_ms=[x['ms'] for x in ranks],
                   one_ms=[x['ms'] for x in ones],
                   seconds=time.time() - t0)
        rounds.append(rnd)
        print('round %d: %s' % (r, json.dumps(rnd)))
        summary = {}
        for kind in ('pairs', 'sharded'):
            ds = [d for x in rounds for d in x[kind].values()]
            summary[kind] = dict(
                whole=max(d['whole'] for d in ds),
                worst=max(d['worst'] for d in ds),
                loss_rel=max([v for d in ds for v in d['loss_rel'].values()]
                             + [0.0]))
        out = dict(card=cs.card_line(), floor=cs.DM_SPREAD_FLOOR,
                   rounds=rounds, summary=summary,
                   rounds_over=sum(any(x['over'].values()) for x in rounds))
        with open(os.path.join(cs.OUT_DIR, 'data_mesh_spread.json'),
                  'w') as f:
            json.dump(out, f, indent=1)
    print(json.dumps(dict(card=out['card'], summary=out['summary'],
                          rounds=len(rounds),
                          rounds_over=out['rounds_over'])))


if __name__ == '__main__':
    main()
