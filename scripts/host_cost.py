#!/usr/bin/env python3
"""Where the host's time goes in one eager DSGAN train step of the port:
the bench configuration (supervised_gan_tpu_torch.bench DSGAN_ARGS, bf16
unless flags say otherwise), a few steps on one CUDA card.

    PYTHONPATH=<checkout> python3 scripts/host_cost.py [--steps N] [flags]

Flags after the script's own go after DSGAN_ARGS (``--no_pallas`` for the
library route).  PYTHONPATH picks the checkout whose package is measured,
so one copy of this script measures two trees.  It prints one JSON line:

  * ``enqueue_ms``: the host's time to issue a step, no synchronize (as
    the bench's enqueue_ms_per_step), and ``wall_ms`` with one;
  * ``host_ms``: the same steps under torch.profiler with host operators,
    split by call.  The script wraps these calls in record_function spans
    (at run time, the package is not changed), and each span's time is its
    own, less the spans nested in it:
      - ``autograd_functions``: the Functions' forward and backward
        (ops/kernels/functions.py), their Python and the torch calls they
        make besides the spans below;
      - ``wrapper_checks``: ops/kernels/common.py's checks and arguments
        (on_cpu, check_cuda_inputs, bias_arg, stream_arg, raise_on_error);
      - ``wrappers_ctypes``: the kernel wrappers themselves (output
        allocation, library lookup, the ctypes call and its launch);
      - ``contiguous``: every Tensor.contiguous() call;
      - ``dx_weight_flip``: conv3x3's dx weight flip and transpose
        (functions.py _conv3x3_dx, less its conv3x3 call);
      - ``pageable_copies``: ops/resample.py's interpolation and blur (the
        host-to-device copies of their constants, with the synchronize
        each makes, where the checkout still makes them) and set_input;
      - ``rest``: the step less all of these (the networks' torch calls,
        autograd, the losses, Adam, the pools).
    Under the profiler every call costs more than without it; the shares
    are the finding, and ``enqueue_ms`` is the unprofiled scale.
    ``syncs``: cudaStreamSynchronize / cudaDeviceSynchronize calls a step.

It reads no dataset and writes nothing but its line.
"""

import argparse
import functools
import importlib
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

CATEGORIES = ('autograd_functions', 'wrapper_checks', 'wrappers_ctypes',
              'contiguous', 'dx_weight_flip', 'pageable_copies')
WRAPPER_MODULES = ('conv3x3', 'conv3x3_dw', 'conv3x3_in', 'conv4s2',
                   'convt4s2', 'instance_norm')
CHECKS = ('on_cpu', 'check_cuda_inputs', 'bias_arg', 'stream_arg',
          'raise_on_error', '_check_stats')
WRAPPERS = ('conv3x3', 'conv3x3_dw', 'conv3x3_in_stats', 'conv4s2',
            'convt4s2', 'instance_norm_act', 'instance_norm_apply',
            'instance_norm_bwd')
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize')


def _spanned(fn, label):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    run.__dict__.update(getattr(fn, '__dict__', {}))   # launch counters
    return run


def _patch(module, name, category):
    if hasattr(module, name):
        setattr(module, name, _spanned(getattr(module, name),
                                       'host.%s.%s' % (category, name)))


def instrument():
    """Wrap the calls of each category in record_function spans, in every
    module that holds a reference to them."""
    pkg = 'supervised_gan_tpu_torch'
    kmods = [importlib.import_module('%s.ops.kernels.%s' % (pkg, m))
             for m in WRAPPER_MODULES]
    functions = importlib.import_module(pkg + '.ops.kernels.functions')
    common = importlib.import_module(pkg + '.ops.kernels.common')
    for m in kmods + [common]:
        for name in CHECKS:
            _patch(m, name, 'wrapper_checks')
    for m in kmods + [functions]:
        for name in WRAPPERS:
            _patch(m, name, 'wrappers_ctypes')
    _patch(functions, '_conv3x3_dx', 'dx_weight_flip')
    for cls in vars(functions).values():
        if isinstance(cls, type) and issubclass(cls, torch.autograd.Function):
            for name in ('forward', 'backward'):
                if name in vars(cls):
                    setattr(cls, name, staticmethod(_spanned(
                        vars(cls)[name].__func__,
                        'host.autograd_functions.%s.%s'
                        % (cls.__name__, name))))
    resample = importlib.import_module(pkg + '.ops.resample')
    for name in ('_lerp_axis', 'blur_downsample'):
        _patch(resample, name, 'pageable_copies')
    for modname in (pkg + '.ops', pkg + '.nn.discriminators'):
        _patch(importlib.import_module(modname), 'blur_downsample',
               'pageable_copies')
    contiguous = torch.Tensor.contiguous
    torch.Tensor.contiguous = _spanned(contiguous, 'host.contiguous.call')
    return contiguous


def _own_ms(events, steps):
    """ms a step by category: each span's time less the spans nested in
    it (the conv3x3 call inside _conv3x3_dx is its wrapper's)."""
    out = dict.fromkeys(CATEGORIES, 0.0)
    for e in events:
        if not e.name.startswith('host.'):
            continue
        nested = 0.0
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            if c.name.startswith('host.'):
                nested += c.cpu_time_total
            else:
                stack.extend(c.cpu_children)
        out[e.name.split('.')[1]] += (e.cpu_time_total - nested) / 1e3 / steps
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--warmup', type=int, default=3)
    ours, rest = p.parse_known_args()
    from supervised_gan_tpu_torch.bench import DSGAN_ARGS
    from supervised_gan_tpu_torch.models import create_model
    from supervised_gan_tpu_torch.models.base import disable_tf32
    from supervised_gan_tpu_torch.options import TrainOptions
    import supervised_gan_tpu_torch

    disable_tf32()
    opt = TrainOptions().parse(DSGAN_ARGS + rest)
    model = create_model(opt)
    dev = model.device
    if dev.type != 'cuda':
        sys.exit('host_cost: needs a CUDA card')
    if not opt.no_pallas:
        from supervised_gan_tpu_torch.ops.kernels import build
        build.build_all()
    rng = np.random.RandomState(0)
    batch = {'A': rng.uniform(-1, 1, (opt.batchSize, opt.fineSize,
                                      opt.fineSize, 3)).astype(np.float32),
             'A_paths': ['bench.png'] * opt.batchSize}

    def step():
        with record_function('host_cost.step'):
            model.set_input(batch)
            model.optimize_parameters()

    for _ in range(ours.warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ours.steps):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / ours.steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ours.steps

    instrument()
    model.set_input = _spanned(model.set_input,
                               'host.pageable_copies.set_input')
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ours.steps):
            step()
        profiled_enqueue_ms = (time.perf_counter() - t0) * 1e3 / ours.steps
        torch.cuda.synchronize()
    events = prof.events()
    host = _own_ms(events, ours.steps)
    host['rest'] = profiled_enqueue_ms - sum(host.values())
    spans = [e.time_range for e in events if e.name == 'host_cost.step']
    syncs = sum(1 for e in events if e.name in SYNC_CALLS and any(
        r.start <= e.time_range.start <= r.end for r in spans)) / ours.steps
    print(json.dumps({
        'package': supervised_gan_tpu_torch.__file__,
        'flags': rest, 'steps': ours.steps,
        'kernels': not opt.no_pallas, 'compute_dtype': opt.compute_dtype,
        'enqueue_ms': enqueue_ms, 'wall_ms': wall_ms,
        'profiled_enqueue_ms': profiled_enqueue_ms, 'host_ms': host,
        'host_share': {k: v / profiled_enqueue_ms for k, v in host.items()},
        'syncs': syncs,
        'device': torch.cuda.get_device_name(dev)}))


if __name__ == '__main__':
    main()
