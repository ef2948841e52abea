"""Benchmark: DSGAN training images/s on one card, printed as ONE JSON line.

    python -m supervised_gan_tpu_torch.bench [train flags]

The port of the JAX package's root bench.py.  It runs the full
twostage_cycle train step of the README DSGAN recipe at the configuration
bench.py:35-64 pins (G1 fcgan ngf 32, G2 CRN ngf 64, F2 unet_128 nff 32, a
2-scale D1 and a 4-scale D2 bank, the six-term G loss, three pools, three
Adams; 512 px, batch 1, bf16) on synthetic input: the batch of
bench.py:120-124, uniform(-1, 1) from RandomState(0).  It reads no dataset
and writes no image.  Flags on the command line follow DSGAN_ARGS and take
their place: ``--no_pallas`` runs every kernel site on its PyTorch library
call, ``--compute_dtype float32`` the f32 step, ``--gpu_ids -1`` the CPU.

Timing, as bench.py:132-188 there:
  * 5 warm-up steps, the kernels' build included (``warmup_s``);
  * N_WINDOWS windows of WINDOW_STEPS steps, each ended by one synchronize
    and none inside; ``value`` is the median window's images/s and
    ``wall_ms_per_step`` its step time;
  * WINDOW_STEPS steps with no synchronize at all: ``enqueue_ms_per_step``,
    the host's cost of issuing a step;
  * one trace of TRACE_STEPS steps (utils/profile.py; the device and the
    runtime's calls, not the host's operators): the device time a step of
    every kernel and copy (``device_ms_per_step``), its kernels
    (``device_kernels_per_step``), ``busy_share`` = device / wall and
    ``host_gap_ms`` = wall - device.  A trace that fails or in which a
    launch lost its device record fails the run (the JAX probe swallows a
    failure, bench.py:179-187 there).  On the CPU there is no device to
    trace.
The wrappers' ``launches_per_step`` are counted over the windows.

Then the chunked dispatch (--steps_per_dispatch, bench.py:146-163 there):
the batch stacked CHUNK times, ``train_chunk_stacked`` once (on a card the
step's capture as a CUDA graph, models/graph.py), then N_WINDOWS windows of
WINDOW_STEPS steps in chunks of CHUNK, each ended by one synchronize:
``chunked_img_s`` (median) and ``chunked_windows_img_s``.  On a card a
trace of one chunk of min(TRACE_STEPS, CHUNK) steps gives the chunked
step's device time, kernels and busy share (``chunked_*``), the graph's
kernel nodes (``graph_kernels``; each replay counted as a launch of each)
and the kernels launched beside the replays (the copies of the inputs into
the graph's, ``chunked_kernels_outside_graph_per_step``).
``value`` is the better of the per-step and the chunked rate, and
``dispatch_mode`` says which ('per_step' or 'chunked[k=CHUNK]'), as the JAX
bench chooses; every other field without ``chunked`` is the per-step
mode's.  On the CPU the chunked steps run eagerly.

Left out of the JAX record, since none of them measures this port on this
card: ``vs_baseline``, ``vs_a100_estimate`` and ``baseline_note`` (an A100
estimate from XLA's FLOP count, BENCH_FLOPS.json), ``vs_torch_cpu_measured``
(a CPU anchor, BASELINE_TORCH.json), the XLA compile-cache fields and the
TPU gate names.

It runs on ``cuda:<first --gpu_ids>`` and never falls back to the CPU;
under ``--gpu_ids -1`` (``backend`` "cpu") every device field is null.  The
``main`` parameters shorten a run for tests; the command line always runs
the constants below.  ``main`` takes another configuration's flags as
``base`` (bench_extra.py: the stage-1 and SGAN step-2 configurations),
with its name for the metric.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .models import create_model
from .models.base import disable_tf32
from .nn import core as nn_core
from .ops.kernels import (build, kernels_enabled, launch_counts,
                          reset_launch_counts)
from .options import TrainOptions
from .utils.profile import device_rows, is_copy, kernel_launches, traced

# bench.py:35-64 of the JAX package, with the paths of this checkout: the
# dataroot is never read, and the options write opt.txt under
# ./checkpoints/bench_dsgan
DSGAN_ARGS = [
    '--dataroot', './datasets/unused', '--name', 'bench_dsgan',
    '--model', 'twostage_cycle', '--which_direction', 'AtoB',
    '--dataset_mode', 'single', '--loadSize', '1024', '--fineSize', '512',
    '--transform_1to2', 'bilinear_2', '--batchSize', '1',
    '--input_nc', '2', '--output_nc', '1', '--which_channel', 'rg_b',
    '--which_model_netG1', 'fcgan', '--n_layers_G1', '5', '--ngf1', '32',
    '--which_model_netD1', 'n_layers', '--n_layers_D1', '3', '3',
    '--ndf1', '32', '--scale_factor1', '1', '2', '--lambda_D1', '0.5', '0.4',
    '--which_model_netG2', 'crn', '--ngf2', '64',
    '--upsample_mode2', 'bilinear', '--n_layers_CRN_block2', '2',
    '--which_model_netF2', 'unet_128', '--nff2', '32',
    '--which_model_netD2', 'n_layers', '--n_layers_D2', '3', '4', '3', '4',
    '--ndf2', '64', '--scale_factor2', '1', '1', '2', '2',
    '--lambda_D2', '0.3', '0.3', '0.2', '0.2',
    '--lambda_A', '10', '--lambda_B', '10', '--lambda_A_cycle', '5',
    '--lambda_fake_cycle', '1', '--noise_nc1', '8', '--noiseSize1', '4',
    '--noise_nc2', '8', '--noiseSize2', '8', '--norm', 'instance',
    '--no_dropout1', '--n_update_G', '1', '--no_lsgan1', '--no_lsgan2',
    '--GAN_losses_D2', 'real_fake', '--GAN_losses_G2', 'real_fake',
    '--manualSeed', '0', '--lr1', '0.0002', '--lr2', '0.0002',
    '--checkpoints_dir', './checkpoints', '--display_id', '0',
    '--compute_dtype', 'bfloat16',
]

WARMUP_STEPS = 5
WINDOW_STEPS = 30
N_WINDOWS = 3
TRACE_STEPS = 12
CHUNK = 10


def card(index):
    """{'name', 'power_limit'} of card ``index`` as nvidia-smi reports
    them."""
    out = subprocess.run(['nvidia-smi', '-i', str(index),
                          '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(', ', 1)
    return {'name': name, 'power_limit': limit}


def main(args=None, windows=N_WINDOWS, window_steps=WINDOW_STEPS,
         trace_steps=TRACE_STEPS, chunk=CHUNK, base=DSGAN_ARGS,
         metric_name='dsgan_twostage_cycle', record_extra=None):
    """Run the benchmark; returns the record it prints.  ``args``: the
    flags after ``base`` (default: the command line's); ``metric_name``
    goes into the metric and ``record_extra``'s keys into the record;
    window_steps must be a multiple of chunk."""
    if window_steps % chunk:
        raise ValueError('bench: %d window steps are not chunks of %d'
                         % (window_steps, chunk))
    disable_tf32()
    t_setup0 = time.perf_counter()
    opt = TrainOptions().parse(
        list(base) + (sys.argv[1:] if args is None else list(args)))
    for flag in ('data_mesh', 'dcn_num_processes'):
        if getattr(opt, flag) > 1:
            raise NotImplementedError(
                'bench: --%s %d: the bench measures one card; a data-parallel '
                'bench is not ported' % (flag, getattr(opt, flag)))
    model = create_model(opt)
    dev = model.device
    cuda = dev.type == 'cuda'
    if cuda and kernels_enabled():
        build.build_all()          # one nvcc a source, all at once

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(0)
    shape = (opt.batchSize, opt.fineSize, opt.fineSize, 3)
    # B: the second image of the aligned and unaligned datasets
    model.set_input({'A': rng.uniform(-1, 1, shape).astype(np.float32),
                     'B': rng.uniform(-1, 1, shape).astype(np.float32),
                     'A_paths': ['bench.png'] * opt.batchSize,
                     'B_paths': ['bench_B.png'] * opt.batchSize})
    for _ in range(WARMUP_STEPS):
        model.optimize_parameters()
    sync()
    warmup_s = time.perf_counter() - t_setup0

    reset_launch_counts()
    windows_img_s = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(window_steps):
            model.optimize_parameters()
        sync()
        windows_img_s.append(window_steps * opt.batchSize
                             / (time.perf_counter() - t0))
    steps = windows * window_steps
    launches = {k: v / steps for k, v in launch_counts().items()}
    img_s = statistics.median(windows_img_s)
    wall_ms = 1e3 * opt.batchSize / img_s

    t0 = time.perf_counter()
    for _ in range(window_steps):
        model.optimize_parameters()
    enqueue_ms = (time.perf_counter() - t0) / window_steps * 1e3
    sync()

    device_ms = kernels_per_step = primer_lost = None
    if cuda:
        prof, primer_lost = traced(model.optimize_parameters, trace_steps,
                                   dev, host=False)
        rows = device_rows(prof, trace_steps)
        if not rows:
            raise RuntimeError('bench: the profiler recorded no device time')
        device_ms = sum(r[1] for r in rows)
        kernels_per_step = sum(r[2] for r in rows if not is_copy(r[0]))

    stacked = {name: torch.stack([t] * chunk)
               for name, t in model.step_inputs().items()}
    model.train_chunk_stacked(stacked, chunk)       # on a card, the capture
    sync()
    chunked_windows = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(window_steps // chunk):
            model.train_chunk_stacked(stacked, chunk)
        sync()
        chunked_windows.append(window_steps * opt.batchSize
                               / (time.perf_counter() - t0))
    chunked_img_s = statistics.median(chunked_windows)
    chunked_wall_ms = 1e3 * opt.batchSize / chunked_img_s
    chunked_ms = chunked_kernels = outside = None
    if cuda:
        # one chunk of at most trace_steps steps: back to back, replays
        # emit device records faster than the host's trace per step does,
        # and a 10-step chunk of the f32 library route (38k kernels) lost
        # some in every trace on an H100
        n = min(trace_steps, chunk)
        part = {name: t[:n] for name, t in stacked.items()}
        prof, _ = traced(lambda: model.train_chunk_stacked(part, n), 1, dev,
                         host=False, graph_kernels=model.graph_kernels())
        rows = device_rows(prof, n)
        chunked_ms = sum(r[1] for r in rows)
        chunked_kernels = sum(r[2] for r in rows if not is_copy(r[0]))
        outside = kernel_launches(prof)[0] / n
    if chunked_img_s > img_s:
        value, mode = chunked_img_s, 'chunked[k=%d]' % chunk
    else:
        value, mode = img_s, 'per_step'

    errors = model.get_current_errors()
    rec = {
        'metric': 'vnc%d_%s_train_images_per_sec_per_chip'
                  % (opt.fineSize, metric_name),
        'value': value,
        'unit': 'images/sec',
        'dispatch_mode': mode,
        'per_step_img_s': img_s,
        'windows_img_s': windows_img_s,
        'window_steps': window_steps,
        'chunk_steps': chunk,
        'chunked_img_s': chunked_img_s,
        'chunked_windows_img_s': chunked_windows,
        'chunked_wall_ms_per_step': chunked_wall_ms,
        'chunked_device_ms_per_step': chunked_ms,
        'chunked_device_kernels_per_step': chunked_kernels,
        'chunked_busy_share': (chunked_ms / chunked_wall_ms
                               if cuda else None),
        'graph_kernels': model.graph_kernels(),
        'chunked_kernels_outside_graph_per_step': outside,
        'finite': bool(np.all(np.isfinite(list(errors.values())))),
        'wall_ms_per_step': wall_ms,
        'enqueue_ms_per_step': enqueue_ms,
        'device_ms_per_step': device_ms,
        'device_kernels_per_step': kernels_per_step,
        'busy_share': device_ms / wall_ms if cuda else None,
        'host_gap_ms': wall_ms - device_ms if cuda else None,
        'device_rate_img_s': (1e3 * opt.batchSize / device_ms
                              if cuda else None),
        'trace_steps': trace_steps,
        'trace_primer_records_lost': primer_lost,
        'launches_per_step': launches,
        'warmup_s': warmup_s,
        'backend': dev.type,
        'device': card(dev.index or 0) if cuda else None,
        'gates': {
            'kernels': kernels_enabled(),
            'conv3_in_fused': nn_core._CONV3_IN_FUSED,
            'compute_dtype': opt.compute_dtype,
            # the port always skips a conv bias that the next norm cancels
            # (nn/core.py); the JAX package's SGAN_TPU_SKIP_INERT_BIAS=0
            # has no counterpart
            'skip_inert_bias': True,
            'tf32': {'cudnn': torch.backends.cudnn.allow_tf32,
                     'matmul': torch.backends.cuda.matmul.allow_tf32},
        },
    }
    rec.update(record_extra or {})
    print(json.dumps(rec))
    return rec


if __name__ == '__main__':
    main()
