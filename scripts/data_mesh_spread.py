#!/usr/bin/env python3
"""How far a data-parallel run lands from one-process runs of the same
steps, and one-process runs from each other, on one CUDA card: the spread
that chip_smoke.py's data-mesh check (phase_data_mesh) is floored by; with
--spatial_mesh, the same for the height split over two ranks
(phase_spatial_mesh: sp_compare, SP_SPREAD_FLOOR; its JSON is
spatial_mesh_spread.json, beside this one's).

    python3 scripts/data_mesh_spread.py [--rounds N] [--spatial_mesh
                                         [--plants NAME ...]]

Each round is chip_smoke.py's dm_compare: the bench DSGAN configuration in
f32 at the global batch DM_BATCH, DM_STEPS steps under the default
algorithms, DM_RUNS one-process runs and one run of DM_BATCH gloo ranks on
cuda:0 (one row each).  For each round it prints the relative L2 distances
(whole state, worst tensor) and each loss's relative difference, of the
one-process pairs and of the sharded run against each one-process run, and
whether the check's rule (dm_limits with DM_SPREAD_FLOOR) passes it; the
summary holds the largest of each.  One JSON line at the end, and
chiprun_out/data_mesh_spread.json (rewritten after every round).

--plants (with --spatial_mesh) runs, after the rounds, one sharded run
with each named fault of chip_smoke.py SP_PLANTS planted, held against the
last round's one-process runs and limits: how far beyond the check's
limits such a fault lands (``plants`` in the JSON).
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
    ap.add_argument('--spatial_mesh', action='store_true',
                    help='the --spatial_mesh 2 check instead')
    ap.add_argument('--plants', nargs='*', default=[],
                    choices=sorted(cs.SP_PLANTS),
                    help='faults to plant in one sharded run each')
    args = ap.parse_args()
    if args.plants and not args.spatial_mesh:
        raise SystemExit('--plants needs --spatial_mesh')
    compare, floor, out_name = (
        (cs.sp_compare, cs.SP_SPREAD_FLOOR, 'spatial_mesh_spread.json')
        if args.spatial_mesh else
        (cs.dm_compare, cs.DM_SPREAD_FLOOR, 'data_mesh_spread.json'))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build_all()
    os.makedirs(cs.RESULTS_DIR, exist_ok=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    rounds = []
    for r in range(args.rounds):
        t0 = time.time()
        ones, ranks, pairs, sharded = compare()
        losses = ones[0]['losses']
        limits = cs.dm_limits(pairs, losses, floor=floor)
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
        out = dict(card=cs.card_line(), floor=floor,
                   rounds=rounds, summary=summary,
                   rounds_over=sum(any(x['over'].values()) for x in rounds))
        with open(os.path.join(cs.OUT_DIR, out_name), 'w') as f:
            json.dump(out, f, indent=1)
    planted = {}
    for name in args.plants:
        ranks = cs.sp_sharded_run(plant=name)
        ds = {'rank0-one%d' % i: cs._state_diff(
            (o['state'], o['losses']), (ranks[0]['state'],
                                        ranks[0]['losses']))
              for i, o in enumerate(ones)}
        planted[name] = dict(
            sharded={n: _short(d, losses) for n, d in ds.items()},
            over={n: cs._over_limits(d, limits) for n, d in ds.items()},
            limits=limits)
        print('plant %s: %s' % (name, json.dumps(planted[name])))
    if planted:
        out['plants'] = planted
        with open(os.path.join(cs.OUT_DIR, out_name), 'w') as f:
            json.dump(out, f, indent=1)
    print(json.dumps(dict(card=out['card'], summary=out['summary'],
                          rounds=len(rounds),
                          rounds_over=out['rounds_over'],
                          plants_over={n: any(p['over'].values())
                                       for n, p in planted.items()})))


if __name__ == '__main__':
    main()
