#!/usr/bin/env python3
"""Drive the PyTorch port's DSGAN sampler on one CUDA card and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card (an H100 for the
sm_90a build) and nvcc.  Any failed phase exits non-zero and prints no
result line.

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel from supervised_gan_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time and ptxas report;
  3. each kernel at every site of the sampler at 512 px (README DSGAN
     widths): kernel vs plain version in float32 with TF32 off (tolerance
     1e-4 abs + 1e-4 rel: f32 sums in another order) and in bfloat16
     (2e-2 abs + 2e-2 rel: one bf16 ulp of outputs up to ~5); the device
     time of the kernel, the plain version and one PyTorch library call of
     the same function (median over CUDA-graph replays, so without the
     host's launch cost), the kernel's eager call time, and the bound
     (bytes at 3.35 TB/s or f32 FLOPs at 67 TFLOP/s, the larger);
  4. the slice: G1 and G2 at README widths from seed 0 saved as
     latest_net_G{1,2}.pth, then the port's sampler entry point
     (supervised_gan_tpu_torch.test.main) with the README DSGAN flags,
     --fineSize 512 --how_many 8: every output finite, PNGs and index.html
     written, each kernel's launch count = its sites per sample x 8
     (counts set to 0 just before, read just after); images per second;
     then once more in --compute_dtype bfloat16;
  5. the forward alone: wall time per sample, and device time by kernel and
     the device's busy share from a torch.profiler trace (written to
     chiprun_out/sampler_trace.json);
  6. one full-width sample on the card against the same weights and noise
     through the plain versions on the CPU (tolerance 2e-3, the CPU slice
     test's: InstanceNorm after chains of convs magnifies reordered sums);
  7. a JSON line of per-kernel results, the card line, and the last line
     {"ok": true, "device": {...}}.

Per-site numbers go to chiprun_out/chip_smoke.json.  Checkpoints and
sample images go to checkpoints/chip_smoke and results/chip_smoke.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit('chip_smoke: torch.cuda.is_available() is false; this script '
             'needs a CUDA card')

import torch.nn.functional as F  # noqa: E402

from supervised_gan_tpu_torch import nn as tnn  # noqa: E402
from supervised_gan_tpu_torch import test as sampler  # noqa: E402
from supervised_gan_tpu_torch.ops import bilinear_upsample  # noqa: E402
from supervised_gan_tpu_torch.ops import kernels as K  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import build  # noqa: E402
from supervised_gan_tpu_torch.utils import pth  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, 'chiprun_out')
CKPT_DIR = os.path.join(ROOT, 'checkpoints')
RESULTS_DIR = os.path.join(ROOT, 'results', 'chip_smoke')
NAME = 'chip_smoke'
SAMPLES = 8
DEV = torch.device('cuda', 0)

# H100 SXM published peaks (NVIDIA data sheet: f32 outside the tensor cores,
# HBM3 bandwidth)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The sampler's flags: the architecture flags of the README DSGAN command
# (README.md:60-78), sampling at 512 px.
DSGAN_FLAGS = [
    '--dataroot', './datasets/null', '--name', NAME,
    '--model', 'twostage_cycle', '--which_direction', 'AtoB',
    '--dataset_mode', 'single', '--loadSize', '512', '--fineSize', '512',
    '--transform_1to2', 'bilinear_2', '--batchSize', '1',
    '--input_nc', '2', '--output_nc', '1', '--which_channel', 'rg_b',
    '--which_model_netG1', 'fcgan', '--n_layers_G1', '5', '--ngf1', '32',
    '--which_model_netD1', 'n_layers', '--n_layers_D1', '3', '3',
    '--ndf1', '32', '--scale_factor1', '1', '2',
    '--which_model_netG2', 'crn', '--ngf2', '64',
    '--upsample_mode2', 'bilinear', '--n_layers_CRN_block2', '2',
    '--which_model_netF2', 'unet_128', '--nff2', '32',
    '--which_model_netD2', 'n_layers', '--n_layers_D2', '3', '4', '3', '4',
    '--ndf2', '64', '--scale_factor2', '1', '1', '2', '2',
    '--noise_nc1', '8', '--noiseSize1', '4', '--noise_nc2', '8',
    '--noiseSize2', '8', '--norm', 'instance', '--no_dropout1',
    '--manualSeed', '0', '--serial_batches', '--no_flip', '--no_rotate',
    '--display_id', '0', '--checkpoints_dir', CKPT_DIR]

# Every kernel site of one 512 px sample (G1 fcgan ngf 32 x 5 layers; G2 CRN
# ngf 64, bilinear, 2-conv blocks, InstanceNorm).
# convt4s2: (Ci, Co, input side, bias) -- the six G1 transposed convs
CONVT_SITES = [(8, 256, 4, False), (256, 256, 8, True), (256, 128, 16, True),
               (128, 64, 32, True), (64, 32, 64, True), (32, 2, 128, False)]
# conv3x3: (Ci, Co, side) -- blockh5 stem, the shared label block at five
# scales, the bilinear blocks' 128 -> 64 convs, two inter convs per block,
# and the 512^2 head
SCALES = (16, 32, 64, 128, 256)
CONV3_SITES = ([(10, 64, 8)] + [(2, 64, s) for s in SCALES]
               + [(128, 64, s) for s in SCALES]
               + [(64, 64, s) for s in SCALES for _ in range(2)]
               + [(64, 64, 512), (64, 1, 512)])
# instance_norm_act: (C, side, slope) -- after each upsample block, the inter
# blocks (ReLU-fused inside, identity at block ends; the head block has only
# the fused one), the label blocks
IN_SITES = ([(64, s, None) for s in SCALES + (512,)]
            + [(64, s, sl) for s in SCALES for sl in (0.0, None)]
            + [(64, 512, 0.0)]
            + [(64, s, None) for s in SCALES])

KERNEL_INFO = {
    'conv3x3': dict(source='supervised_gan_tpu_torch/csrc/conv3x3.cu',
                    replaces='supervised_gan_tpu/ops/pallas/conv3x3.py:143'),
    'convt4s2': dict(source='supervised_gan_tpu_torch/csrc/convt4s2.cu',
                     replaces='supervised_gan_tpu/ops/pallas/convt4s2.py:157'),
    'instance_norm_act': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:109'),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _event_ms(run):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def device_ms(fn, reps=20, trials=5):
    """Median device time of one call of fn: `reps` calls captured in a CUDA
    graph, the graph replayed `trials` times, each replay timed with CUDA
    events.  The graph takes the host's launch cost out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(_event_ms(graph.replay) / reps
                           for _ in range(trials))
    del graph
    return ms


def call_ms(fn, trials=7):
    """Median time of one eager call as a caller sees it on an idle card
    (host launch cost included)."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(fn) for _ in range(trials))


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                        else 'bytes')


def err(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol):
    return bool(((a.float() - b.float()).abs()
                 <= tol + tol * b.float().abs()).all())


def randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device=DEV) * scale


def site_cases():
    """(kernel name, site label, kernel fn, plain fn, library fn, flops,
    bytes, make inputs) for every site."""
    cases = []
    for ci, co, s, has_b in CONVT_SITES:
        def mk(gen, ci=ci, co=co, s=s, has_b=has_b):
            return (randn((1, ci, s, s), gen),
                    randn((ci, co, 4, 4), gen, (4 * ci) ** -0.5),
                    randn((co,), gen, 0.1) if has_b else None)
        flops = 2.0 * co * (2 * s) ** 2 * ci * 4
        nbytes = 4.0 * (ci * s * s + ci * co * 16 + co * (2 * s) ** 2
                        + (co if has_b else 0))
        cases.append(('convt4s2', '%d->%d @%d^2' % (ci, co, s), K.convt4s2,
                      K.convt4s2_plain,
                      lambda x, w, b: F.conv_transpose2d(x, w, b, 2, 1),
                      flops, nbytes, mk))
    for ci, co, s in CONV3_SITES:
        def mk(gen, ci=ci, co=co, s=s):
            return (randn((1, ci, s, s), gen),
                    randn((co, ci, 3, 3), gen, (9 * ci) ** -0.5),
                    randn((co,), gen, 0.1))
        flops = 2.0 * co * s * s * ci * 9
        nbytes = 4.0 * (ci * s * s + co * ci * 9 + co + co * s * s)
        cases.append(('conv3x3', '%d->%d @%d^2' % (ci, co, s), K.conv3x3,
                      K.conv3x3_plain,
                      lambda x, w, b: F.conv2d(x, w, b, 1, 1),
                      flops, nbytes, mk))
    for c, s, slope in IN_SITES:
        def mk(gen, c=c, s=s):
            return (randn((1, c, s, s), gen, 2.0) + 0.5,)

        def lib(x, slope=slope):
            y = F.instance_norm(x, eps=1e-5)
            if slope is None:
                return y
            return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)
        n = c * s * s
        cases.append(('instance_norm_act',
                      '%d @%d^2 slope %s' % (c, s, slope),
                      lambda x, slope=slope: K.instance_norm_act(x, 1e-5, slope),
                      lambda x, slope=slope: K.instance_norm_act_plain(
                          x, 1e-5, slope),
                      lib, 6.0 * n, 8.0 * n, mk))
    return cases


def phase_kernels():
    gen = torch.Generator(device=DEV).manual_seed(1234)
    per_site, agg = [], {}
    for name, label, kern, plain, lib, flops, nbytes, mk in site_cases():
        args = mk(gen)
        y = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        e32 = err(y, ref)
        check(y.shape == ref.shape and bool(torch.isfinite(y).all()),
              '%s %s: bad output' % (name, label))
        check(within(y, ref, 1e-4), '%s %s: f32 max abs err %.3g'
              % (name, label, e32))
        args16 = tuple(None if a is None else a.to(torch.bfloat16)
                       for a in args)
        y16, ref16 = kern(*args16), plain(*args16)
        torch.cuda.synchronize()
        check(y16.dtype == torch.bfloat16, '%s %s: bf16 output dtype %s'
              % (name, label, y16.dtype))
        e16 = err(y16, ref16)
        check(within(y16, ref16, 2e-2), '%s %s: bf16 max abs err %.3g'
              % (name, label, e16))
        t_k = device_ms(lambda: kern(*args))
        t_k16 = device_ms(lambda: kern(*args16))
        t_p = device_ms(lambda: plain(*args))
        t_l = device_ms(lambda: lib(*args))
        t_call = call_ms(lambda: kern(*args))
        b_ms, b_by = bound_ms(flops, nbytes)
        site = dict(kernel=name, site=label, max_abs_err=e32,
                    max_abs_err_bf16=e16, ms=t_k, ms_bf16=t_k16, plain_ms=t_p,
                    library_ms=t_l, call_ms=t_call, bound_ms=b_ms,
                    bound_by=b_by, flops=flops, bytes=nbytes)
        per_site.append(site)
        print('  %-18s %-22s err f32 %.2e bf16 %.2e | kernel %.4f ms '
              '(bf16 %.4f, eager call %.4f) plain %.4f library %.4f '
              'bound %.4f (%s)' % (name, label, e32, e16, t_k, t_k16, t_call,
                                   t_p, t_l, b_ms, b_by))
        a = agg.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      library_ms=0.0, bound_ms=0.0, flops=0.0,
                                      bytes=0.0, sites=0))
        a['max_abs_err'] = max(a['max_abs_err'], e32)
        for k, v in (('ms', t_k), ('plain_ms', t_p), ('library_ms', t_l),
                     ('bound_ms', b_ms), ('flops', flops), ('bytes', nbytes)):
            a[k] += v
        a['sites'] += 1
    for a in agg.values():
        _, a['bound_by'] = bound_ms(a['flops'], a['bytes'])
    return per_site, agg


def save_readme_weights():
    """G1 and G2 at README widths from seed 0, on cuda:0, written as the
    sampler's latest_net_G{1,2}.pth."""
    gen = torch.Generator().manual_seed(0)
    g1 = tnn.define_G(2, 0, 32, 'fcgan', 'instance', False, n_layers_G=5,
                      use_fcn=True, noise_nc=8, generator=gen).to(DEV)
    g2 = tnn.define_G(2, 1, 64, 'crn', 'instance', False, n_layers_G=5,
                      noise_nc=8, upsample_mode='bilinear',
                      n_layers_CRN_block=2, generator=gen).to(DEV)
    d = os.path.join(CKPT_DIR, NAME)
    os.makedirs(d, exist_ok=True)
    pth.save_pth(os.path.join(d, 'latest_net_G1.pth'), g1)
    pth.save_pth(os.path.join(d, 'latest_net_G2.pth'), g2)
    return g1, g2


def run_sampler(extra, samples, results_dir):
    """The sampler entry point in-process, with the launch counts set to 0
    just before and read just after."""
    K.reset_launch_counts()
    r = sampler.main(DSGAN_FLAGS + ['--gpu_ids', '0', '--how_many',
                                    str(samples), '--results_dir',
                                    results_dir] + extra)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    expect = {'conv3x3': len(CONV3_SITES) * samples,
              'convt4s2': len(CONVT_SITES) * samples,
              'instance_norm_act': len(IN_SITES) * samples}
    check(counts == expect, 'launch counts %s, expected %s' % (counts, expect))
    check(r['nonfinite'] == 0, '%d samples with non-finite values'
          % r['nonfinite'])
    images = os.path.join(r['web_dir'], 'images')
    names = sorted(os.listdir(images))
    want = sorted('%04d_fake_%s.png' % (i + 1, ab) for i in range(samples)
                  for ab in 'AB')
    check(names == want, 'result images %s' % names[:4])
    check(os.path.exists(os.path.join(r['web_dir'], 'index.html')),
          'no index.html')
    return r, counts


def phase_reference(g1, g2):
    """One 512 px sample through the kernels on the card and through the
    plain versions on the CPU, same weights and noise."""
    gen = torch.Generator().manual_seed(7)
    n1 = torch.randn((1, 8, 4, 4), generator=gen)
    n2 = torch.randn((1, 8, 8, 8), generator=gen)
    outs = []
    for dev in (DEV, torch.device('cpu')):
        a, b = g1.to(dev), g2.to(dev)
        with torch.no_grad():
            fa = a(n1.to(dev))
            label = bilinear_upsample(fa, 2)
            fb = b(label, n2.to(dev))
        outs.append([t.cpu() for t in (fa, label, fb)])
    for name, x, y in zip(('G1', 'transform', 'G2'), *outs):
        e = err(x, y)
        print('  reference %-9s shape %s max abs err %.3e' % (name,
                                                             tuple(x.shape), e))
        check(e <= 2e-3, 'card vs CPU reference %s: %.3g' % (name, e))
    check(tuple(outs[0][2].shape) == (1, 1, 512, 512), 'G2 output shape')


def phase_forward(g1, g2, reps=10):
    """The sampler's forward alone (noise -> G1 -> bilinear_2 -> G2, no image
    writing): median wall time per sample with a synchronize, and from a
    torch.profiler trace of 3 samples the device time per sample by kernel,
    hence the device's busy share of the wall time."""
    gen = torch.Generator(device=DEV).manual_seed(3)

    def fwd():
        n1 = torch.randn((1, 8, 4, 4), generator=gen, device=DEV)
        n2 = torch.randn((1, 8, 8, 8), generator=gen, device=DEV)
        with torch.no_grad():
            return g2(bilinear_upsample(g1(n1), 2), n2)

    for _ in range(2):
        fwd()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    out = dict(wall_ms=statistics.median(walls), device_ms=None,
               busy_share=None, top=[])
    print('  forward: median %.3f ms per 512 px sample (wall, %d reps)'
          % (out['wall_ms'], reps))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 3e3, e.count / 3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    prof.export_chrome_trace(os.path.join(OUT_DIR, 'sampler_trace.json'))
    if not rows:
        print('  profiler: no device time recorded; busy share not measured')
        return out
    rows.sort(key=lambda r: -r[1])
    out['device_ms'] = sum(r[1] for r in rows)
    out['busy_share'] = out['device_ms'] / out['wall_ms']
    out['kernels_per_sample'] = sum(r[2] for r in rows)
    out['top'] = rows[:16]
    print('  device time %.3f ms per sample in %.0f kernels, busy share %.3f '
          'of the wall' % (out['device_ms'], out['kernels_per_sample'],
                           out['busy_share']))
    for key, ms, n in out['top']:
        print('    %8.4f ms  x%5.1f  %s' % (ms, n, key[:90]))
    return out


def main():
    t_start = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    print('torch %s, CUDA %s, device %s, python %s'
          % (torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0), sys.version.split()[0]))
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.rmtree(os.path.join(CKPT_DIR, NAME), ignore_errors=True)
    shutil.rmtree(RESULTS_DIR, ignore_errors=True)

    print('== build')
    t0 = time.time()
    reports = build.build_all()
    print('built %d kernel libraries in %.1f s' % (len(reports),
                                                    time.time() - t0))
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print('  %s: %s' % (name, line.strip()))

    print('== kernels vs plain versions at the 512 px sites')
    per_site, agg = phase_kernels()

    print('== slice: DSGAN sampler, 512 px, %d samples' % SAMPLES)
    g1, g2 = save_readme_weights()
    r32, counts = run_sampler([], SAMPLES, os.path.join(RESULTS_DIR, 'f32'))
    ips = SAMPLES / r32['loop_seconds']
    print('sampler f32: %d samples in %.3f s = %.3f images/s (drawing %.3f s, '
          'writing images %.3f s); launches %s'
          % (SAMPLES, r32['loop_seconds'], ips, r32['sample_seconds'],
             r32['write_seconds'], counts))
    r16, counts16 = run_sampler(['--compute_dtype', 'bfloat16'], 2,
                                os.path.join(RESULTS_DIR, 'bf16'))
    ips16 = 2 / r16['loop_seconds']
    print('sampler bf16: 2 samples in %.3f s = %.3f images/s; launches %s'
          % (r16['loop_seconds'], ips16, counts16))

    print('== forward alone: wall and device time per sample')
    fwd = phase_forward(g1, g2)

    print('== reference: one 512 px sample, card kernels vs CPU plain')
    phase_reference(g1, g2)

    kernels = []
    for name in ('conv3x3', 'convt4s2', 'instance_norm_act'):
        a = agg[name]
        kernels.append(dict(
            name=name, route='cuda', source=KERNEL_INFO[name]['source'],
            replaces=KERNEL_INFO[name]['replaces'], launches=counts[name],
            max_abs_err=a['max_abs_err'], ms=a['ms'], plain_ms=a['plain_ms'],
            bound_ms=a['bound_ms'], bound_by=a['bound_by'],
            library_ms=a['library_ms']))
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  sites=per_site, kernels=kernels,
                  forward=fwd,
                  sampler=dict(samples=SAMPLES,
                               loop_seconds=r32['loop_seconds'],
                               sample_seconds=r32['sample_seconds'],
                               write_seconds=r32['write_seconds'],
                               images_per_second=ips,
                               bf16_samples=2,
                               bf16_loop_seconds=r16['loop_seconds'],
                               bf16_images_per_second=ips16),
                  seconds=time.time() - t_start)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump(detail, f, indent=1)
    print('total %.1f s' % (time.time() - t_start))
    print(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
