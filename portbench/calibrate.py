"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 ... \\
        [--control_seeds 1 2 3] [--faults frozen batch0] [--out FILE]

For each seed: the program's set-up and its checked steps, then the
plain reference on the same seeds, and the gaps (check.py): the lower
readings.  For each control seed: the reference in the control's
precision (fp8, reference/ctx.py) in the program's place: the upper
readings.  For each fault (harness.plant) and control seed: the program
with that fault planted.  One JSON line per reading, and a summary of the
largest sound reading and the smallest control and fault readings per
number.  On the CPU, ``--flags`` takes JSON flag changes (narrow widths).
"""

import argparse
import json
import sys
import time

import torch

from . import check, harness


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control_seeds', type=int, nargs='*', default=[])
    p.add_argument('--faults', nargs='*', default=[])
    p.add_argument('--device', default='cuda')
    p.add_argument('--flags', default='{}')
    p.add_argument('--out', default='')
    args = p.parse_args(argv)
    flags = json.loads(args.flags)
    subsets = harness.Run(args.workload, 0, 'cpu').subsets
    rows = []

    def emit(kind, seed, found, t0):
        row = {'kind': kind, 'seed': seed, 's': time.time() - t0,
               'gaps': {k: v[0] for k, v in found.items()},
               'where': {k: v[1] for k, v in found.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)

    refs = {}

    def reference(seed, precision='f32'):
        run = harness.Run(args.workload, seed, args.device, flags=flags)
        out = run.reference(precision)
        del run
        if args.device == 'cuda':
            torch.cuda.empty_cache()
        return out

    def program(seed, fault=None):
        run = harness.Run(args.workload, seed, args.device, flags=flags,
                          fault=fault)
        out = run.setup(warmup=False)
        run.free()
        return out

    for seed in args.seeds:
        t0 = time.time()
        prog = program(seed)
        refs[seed] = reference(seed)
        emit('program', seed, check.gaps(prog, refs[seed], subsets), t0)
    for seed in args.control_seeds:
        t0 = time.time()
        if seed not in refs:
            refs[seed] = reference(seed)
        emit('control', seed, check.gaps(reference(seed, 'fp8'), refs[seed],
                                         subsets), t0)
        for fault in args.faults:
            t0 = time.time()
            emit(fault, seed, check.gaps(program(seed, fault), refs[seed],
                                         subsets), t0)
    summary = {}
    for row in rows:
        for k, v in row['gaps'].items():
            s = summary.setdefault(k, {})
            agg = max if row['kind'] == 'program' else min
            s[row['kind']] = agg(s.get(row['kind'], v), v)
    print(json.dumps({'workload': args.workload, 'summary': summary}))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'workload': args.workload, 'rows': rows,
                       'summary': summary}, f, indent=1)
    return summary


if __name__ == '__main__':
    sys.exit(0 if main() else 1)
