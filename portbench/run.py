"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It runs supervised_gan_tpu_torch on cuda:0
(the cell's chips from cuda:0 on) and fails, printing no result, where the
card or the program is missing.  The host threads are those the cell's
configuration states.  Set-up (the kernels' build in a checkout's first
run, weights, pools, images, the checked steps, warm-up) is timed from the
process's start to the first timed dispatch; the window then dispatches
for --seconds; with --trace 1 the mix's traced dispatches follow the
window and the per-layer metrics are read (metrics/<name>.py) instead of
the end-to-end ones.  Last, with the program freed, the plain reference
runs the checked steps again and ``correct`` says whether every compared
number lies within its limit; the numbers are printed beside their limits
on stderr and, under ``checks``, last in the result line.
"""

import time

T_IMPORT = time.time()

import argparse    # noqa: E402
import json        # noqa: E402
import os          # noqa: E402
import subprocess  # noqa: E402
import sys         # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel and build cache of the run at a fixed path in the checkout
# (the program's nvcc libraries go to supervised_gan_tpu_torch/build/)
_CACHE = ROOT / 'portbench_run' / 'cache'
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = str(_CACHE / _sub)


def host_threads(workload):
    """The host threads the cell's configuration states (its file's
    ``host_threads``), read before torch is loaded; None where it states
    none or the cell is not found (the harness then says why)."""
    try:
        with open(ROOT / 'BENCHMARK.json') as f:
            bench = json.load(f)
        cell = {w['name']: w for w in bench['workloads']}[workload]
        conf = {c['name']: c for c in bench['configs']}[cell['config']]
        with open(ROOT / conf['file']) as f:
            return json.load(f).get('host_threads')
    except (OSError, KeyError, ValueError):
        return None


_ARGS = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
_ARGS.add_argument('--workload', required=True)
_ARGS.add_argument('--seed', type=int, required=True)
_ARGS.add_argument('--seconds', type=float, required=True)
_ARGS.add_argument('--trace', type=int, choices=(0, 1), default=0)
THREADS = (host_threads(_ARGS.parse_known_args()[0].workload)
           if __name__ == '__main__' else None)
if THREADS:
    os.environ['OMP_NUM_THREADS'] = str(THREADS)

import torch  # noqa: E402

from . import harness  # noqa: E402


def card(index):
    out = subprocess.run(['nvidia-smi', '-i', str(index),
                          '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    line = out.stdout.strip().splitlines()
    return line[0].rsplit(', ', 1)[1] if line else 'unknown'


def fail(msg):
    print('portbench: %s' % msg, file=sys.stderr)
    sys.exit(2)


def main(argv=None):
    args = _ARGS.parse_args(argv)
    t0 = harness.process_start() or T_IMPORT
    if THREADS:
        torch.set_num_threads(THREADS)

    bench = harness.benchmark()
    cell = harness.lookup(bench, args.workload)[0]
    if not torch.cuda.is_available():
        fail('no CUDA device: the benchmark runs on a card only')
    if torch.cuda.device_count() < cell['chips']:
        fail('%s needs %d cards, %d found' % (
            args.workload, cell['chips'], torch.cuda.device_count()))
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)

    run = harness.Run(args.workload, args.seed, device, bench=bench)
    prog = run.setup()
    setup_s = time.time() - t0
    window = run.window(args.seconds)
    summary = run.traced() if args.trace else None
    memory_peak = torch.cuda.max_memory_allocated(device)
    finite = run.finite()
    steps = sum(w[3] for w in window)
    e2e = harness.end_to_end(window, run.mix['batch'], setup_s)
    if args.trace:
        flops = harness.step_flops(run.recipe, run.flags, run.mix['batch'])
        readings = harness.Readings(run, window, summary, flops)
        metrics = {}
        for m in harness.metric_specs(bench, args.workload, 'per_layer'):
            v = harness.reader(m['name'])(readings)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in harness.metric_specs(bench, args.workload,
                                                 'end_to_end')}
    run.free()

    ref = run.reference()
    found = harness.check.gaps(prog, ref, run.subsets)
    correct, checks = harness.check.verdict(found, run.limits)
    correct = correct and finite
    checks['finite_losses'] = {'value': int(finite), 'limit': 1}

    device_rec = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                  'count': cell['chips'], 'memory_peak_bytes': memory_peak,
                  'power_limit': card(0)}
    if summary is not None:
        device_rec['busy_s'] = summary.busy_s()
        device_rec['window_s'] = summary.window_s
    result = {'correct': correct, 'attempted': steps,
              'failed': 0 if finite else steps, 'metrics': metrics,
              'device': device_rec, 'setup': {'first_build_s': run.build_s},
              'where': {k: v[1] for k, v in found.items()}}
    if summary is not None:
        result['breakdown'] = summary.breakdown()
    result['checks'] = checks

    found_mods = harness.forbidden_modules()
    if found_mods:
        fail('the run loaded %s' % ', '.join(found_mods))
    print(json.dumps(result))
    for k, v in checks.items():
        print('check %s %r limit %r' % (k, v['value'], v['limit']),
              file=sys.stderr)


if __name__ == '__main__':
    main()
