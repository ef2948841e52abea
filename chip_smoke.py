#!/usr/bin/env python3
"""Drive the PyTorch port's DSGAN sampler, DSGAN train step, stage-1 label
GAN and the README DSGAN workflow on one CUDA card, and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card (an H100 for the
sm_90a build) and nvcc.  Any failed phase exits non-zero and prints no
result line.  TF32 is off throughout (cuDNN and matmul), so every float32
comparison is float32 against float32.

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel from supervised_gan_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time and ptxas report;
  3. the forward kernels (conv3x3, convt4s2, instance_norm_act) at every
     site of the 512 px sampler (README DSGAN widths): kernel vs plain
     version in float32 (tolerance 1e-4 abs + 1e-4 rel: f32 sums in
     another order) and in bfloat16 (2e-2 abs + 2e-2 rel: one bf16 ulp of
     outputs up to ~5); the device time of the kernel, the plain version
     and one PyTorch library call of the same function (median over
     CUDA-graph replays, so without the host's launch cost), the kernel's
     eager call time, and the bound (bytes at 3.35 TB/s or FLOPs at
     67 TFLOP/s f32 / 989 TFLOP/s bf16, the larger);
  4. the fused conv3x3 + InstanceNorm region's kernels, conv3x3_in_stats
     and instance_norm_apply, at the CRN's 64 -> 64 trunk sites, 16^2 to
     512^2 (only 512^2 passes the region's gate at its default pixel
     minimum; the smaller ones as if it were lowered): f32 and bf16, slopes
     None and 0.0, y within 1e-4 / 2e-2 as in 3, mean and rstd within 1e-4
     of their largest entry, identical output on two runs; device times of
     the kernel, its plain version, the region (both kernels), the split
     path (conv3x3 + instance_norm_act) and the library pair (F.conv2d,
     then F.instance_norm and F.relu);
  5. the train step's sites, recorded from one f32 step of the bench.py
     DSGAN configuration at 512 px: every call of the conv3x3_dw,
     instance_norm_bwd and conv4s2 kernels, of the four autograd Functions
     and of the two dx paths (conv3x3 on the cotangent, convt4s2 as the
     k4 s2 conv's dx), by shape, with its count per step;
  6. kernels A (conv3x3_dw), B (instance_norm_bwd) and C (conv4s2) at every
     recorded site, and conv3x3 and convt4s2 at their dx sites, as in 3;
     conv3x3_dw's tolerance is 1e-4 (f32 and bf16 inputs; 2e-5 absolute)
     of the largest |dW|, since each entry sums every pixel.  Library
     calls: torch.nn.grad.conv2d_weight, aten's native_batch_norm_backward
     after the activation's backward, F.conv2d, F.conv_transpose2d;
  7. every autograd Function (Conv3x3, ConvT4s2, Conv4s2, InstanceNormAct)
     at every recorded site, and Conv3x3InAct at the region's 512^2 site,
     so every kernel at every shape the train step gives it: its output
     against the plain forward within 1e-4, and its dx, dW and db against
     autograd through the plain forward, within 1e-4 of the largest entry
     of each (the region's db, a sum of rounding noise, within 1e-4 of the
     largest sum of |dconv| it adds up); Conv3x3InAct once more in bf16,
     against autograd of the plain forward on the same bf16 tensors, within
     2e-2;
  8. the sampler: G1, G2 and F2 at README widths from seed 0 saved as
     latest_net_{G1,G2,F2}.pth, then the port's sampler entry point with
     the README DSGAN flags at 512 px, 8 samples: outputs finite, PNGs and
     index.html written, each kernel's launch count = its sites per sample
     x 8 (counts set to 0 just before, read just after); once more in
     bfloat16; the forward alone (wall time, torch.profiler device time and
     busy share); one sample on the card against the CPU plain versions;
     then 8 samples and the card-vs-CPU sample with the region's gate on;
  9. training: a synthetic set of 8 1024^2 RGB PNGs (label in R and G,
     image in B), then the port's train entry point
     (supervised_gan_tpu_torch.train.main) with the bench.py DSGAN flags,
     8 steps in bfloat16 and 4 in float32: every printed loss finite, the
     numbered and latest checkpoints and full state written, each kernel's
     launch count = its launches per step (worked out from the networks'
     structure) x steps, median step time; one bf16 step profiled (device
     time by wrapper and busy share);
 10. one full-width f32 step at 512 px, --pool_size 0 --no_dropout2, on
     the card through the kernels and on the CPU through the plain versions
     with the same weights, noise and batch, the CPU's D banks set to the
     card's after the D updates: each loss term within 1e-3 relative and
     every parameter's gradient within 5e-2 relative in L2, beside the
     noise floor of a CPU step with weights scaled by 1 + 1e-6 N(0, 1)
     (see phase_reference_step);
 11. the stage-1 label GAN (--model fcgan), the command of
     tools/recipe_r05.py:71-84 at its widths and 512 px, on the synthetic
     set: 8 bf16 and 4 f32 steps with exact launch counts and finite
     losses, then its sampler for 4 samples;
 12. the hand-off: its latest_net_{G,D_0,D_1}.pth copied to
     seq_net_{G1,D1_0,D1_1}.pth;
 13. the README DSGAN command (README.md:60-78) with only its paths, the
     step count, --display_id 0, --print_freq 1 and --compute_dtype
     bfloat16 changed: --sequential_train loads those files (checked); 8
     steps with the region's gate on and 8 with it off, exact launch
     counts, median step time of each;
 14. phase 10 again with the region's gate on;
 15. a JSON line of per-kernel results, the card line, and the last line
     {"ok": true, "device": {...}}.

Per-site numbers go to chiprun_out/chip_smoke.json; profiler traces to
chiprun_out/{sampler,train}_trace.json.  Checkpoints go to
checkpoints/chip_smoke*, images and the synthetic set to
results/chip_smoke.
"""

import collections
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit('chip_smoke: torch.cuda.is_available() is false; this script '
             'needs a CUDA card')

import torch.nn.functional as F  # noqa: E402
from PIL import Image  # noqa: E402

from supervised_gan_tpu_torch import nn as tnn  # noqa: E402
from supervised_gan_tpu_torch import test as sampler  # noqa: E402
from supervised_gan_tpu_torch import train as trainer  # noqa: E402
from supervised_gan_tpu_torch.models import create_model  # noqa: E402
from supervised_gan_tpu_torch.nn import core as nn_core  # noqa: E402
from supervised_gan_tpu_torch.ops import bilinear_upsample  # noqa: E402
from supervised_gan_tpu_torch.ops import conv as ops_conv  # noqa: E402
from supervised_gan_tpu_torch.ops import kernels as K  # noqa: E402
from supervised_gan_tpu_torch.ops import norm as ops_norm  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import build  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import functions  # noqa: E402
from supervised_gan_tpu_torch.options import TrainOptions  # noqa: E402
from supervised_gan_tpu_torch.utils import pth  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, 'chiprun_out')
CKPT_DIR = os.path.join(ROOT, 'checkpoints')
RESULTS_DIR = os.path.join(ROOT, 'results', 'chip_smoke')
DATA_DIR = os.path.join(RESULTS_DIR, 'data')
NAME = 'chip_smoke'
TRAIN_NAME = 'chip_smoke_train'
STAGE1_NAME = 'chip_smoke_stage1'
README_NAME = 'chip_smoke_readme'
PRETRAINED_DIR = os.path.join(CKPT_DIR, 'chip_smoke_pretrained')
SAMPLES = 8
TRAIN_IMAGES = 8
F32_STEPS = 4
DEV = torch.device('cuda', 0)
ON_CARD = ['--gpu_ids', '0']

# H100 SXM published peaks (NVIDIA data sheet: f32 outside the tensor cores,
# dense bf16 on the tensor cores, HBM3 bandwidth)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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

# The training flags: bench.py:35-64 (the README DSGAN recipe at 512 px,
# batch 1, lr 2e-4, BCE GAN losses, F2 with dropout), without its
# --compute_dtype, which each run adds.
TRAIN_FLAGS = [
    '--dataroot', DATA_DIR, '--name', TRAIN_NAME,
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
    '--checkpoints_dir', CKPT_DIR, '--display_id', '0']

# The stage-1 label GAN: the command of tools/recipe_r05.py:71-84 (the
# README workflow's `--model fcgan` step, SGAN step 1) with the synthetic
# set's path; its architecture flags, which the sampler takes too, and its
# training flags.
STAGE1_ARCH = [
    '--dataroot', DATA_DIR, '--name', STAGE1_NAME,
    '--model', 'fcgan', '--which_direction', 'A',
    '--dataset_mode', 'single', '--loadSize', '512', '--fineSize', '512',
    '--batchSize', '1', '--input_nc', '2',
    '--which_model_netG', 'deconv', '--n_layers_G', '5', '--ngf', '32',
    '--noise_nc', '8', '--noiseSize', '8', '--norm', 'instance',
    '--no_dropout', '--which_channel', 'rg', '--manualSeed', '0',
    '--checkpoints_dir', CKPT_DIR, '--display_id', '0']
STAGE1_TRAIN = [
    '--which_model_netD', 'n_layers', '--n_layers_D', '3', '3', '3',
    '--ndf', '32', '--scale_factor', '1', '2', '4',
    '--lambda_D', '0.5', '0.4', '0.1', '--n_update_G', '2', '--no_lsgan']

# The README DSGAN command, README.md:60-78, verbatim; readme_args changes
# its paths and step count only.
README_DSGAN = [
    '--dataroot', './datasets/gan/vnc-rgb', '--name', 'dsgan_model',
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
    '--lambda_fake_cycle', '1',
    '--noise_nc1', '8', '--noiseSize1', '4', '--noise_nc2', '8',
    '--noiseSize2', '8', '--norm', 'instance', '--no_dropout1',
    '--n_update_G', '1', '--niter', '150', '--niter_decay', '50',
    '--no_lsgan1', '--no_lsgan2', '--sequential_train', '--manualSeed', '0',
    '--GAN_losses_D2', 'real_fake', '--GAN_losses_G2', 'real_fake',
    '--which_epoch_sequential', 'seq', '--which_model_to_load', 'G1', 'D1',
    '--pretrained_model_dir', 'pretrained/twostage',
    '--lr1', '0.0002', '--lr2', '0.0002']

# the stage-1 files the README command loads, as tools/recipe_r05.py
# export_seq copies them (the third scale of stage 1's D bank is dropped)
HANDOFF = (('latest_net_G.pth', 'seq_net_G1.pth'),
           ('latest_net_D_0.pth', 'seq_net_D1_0.pth'),
           ('latest_net_D_1.pth', 'seq_net_D1_1.pth'))

# Every kernel site of one 512 px sample (G1 fcgan ngf 32 x 5 layers; G2 CRN
# ngf 64, bilinear, 2-conv blocks, InstanceNorm).
# convt4s2: (Ci, Co, input side, bias) -- the six G1 transposed convs; the
# four middle ones' biases are inert (a BatchNorm follows) and skipped
CONVT_SITES = [(8, 256, 4, False), (256, 256, 8, False),
               (256, 128, 16, False), (128, 64, 32, False),
               (64, 32, 64, False), (32, 2, 128, False)]
# conv3x3: (Ci, Co, side, bias) -- blockh5 stem, the shared label block at
# five scales, the bilinear blocks' 128 -> 64 convs, two inter convs per
# block, and the 512^2 head; only the head's bias is not cancelled by the
# norm that follows
SCALES = (16, 32, 64, 128, 256)
CONV3_SITES = ([(10, 64, 8, False)] + [(2, 64, s, False) for s in SCALES]
               + [(128, 64, s, False) for s in SCALES]
               + [(64, 64, s, False) for s in SCALES for _ in range(2)]
               + [(64, 64, 512, False), (64, 1, 512, True)])
# instance_norm_act: (C, side, slope) -- after each upsample block, the inter
# blocks (ReLU-fused inside, identity at block ends; the head block has only
# the fused one), the label blocks
IN_SITES = ([(64, s, None) for s in SCALES + (512,)]
            + [(64, s, sl) for s in SCALES for sl in (0.0, None)]
            + [(64, 512, 0.0)]
            + [(64, s, None) for s in SCALES])

# Kernel launches per train step of the bench.py configuration, from the
# networks' structure.  Per forward: G1 6 convt4s2 (its first takes the
# noise, so 5 need a dx); G2 23 conv3x3 (6 of them, the stem and the five
# label-block calls, see only the label: on the real label they need no dx)
# and 22 IN; F2 (unet_128) 7 conv4s2 (the stem sees the input image), 7
# convt4s2 and 11 IN; the D1 bank 6 conv4s2 (2 stems) and 6 IN; the D2 bank
# 14 conv4s2 (4 stems) and 14 IN.  A step runs G1 once, G2 twice (real and
# fake label), F2 three times; each D bank twice in its own update (on
# detached inputs: no stem dx, every dW) and once in the G update (D held
# fixed: every dx, no dW).  dx of conv3x3 is conv3x3, of conv4s2 convt4s2
# and of convt4s2 conv4s2; every IN forward has its backward.
G2_CONV3, G2_LABEL_SIDE, G2_IN = 23, 6, 22
F2_DOWN, F2_UP, F2_IN = 7, 7, 11
D1_CONV, D1_STEMS, D2_CONV, D2_STEMS = 6, 2, 14, 4
G1_CONVT = 6
IN_PER_STEP = 2 * G2_IN + 3 * F2_IN + 3 * D1_CONV + 3 * D2_CONV
LAUNCHES_PER_STEP = {
    'conv3x3': 2 * G2_CONV3 + (G2_CONV3 - G2_LABEL_SIDE) + G2_CONV3,
    'conv3x3_dw': 2 * G2_CONV3,
    'instance_norm_act': IN_PER_STEP,
    'instance_norm_bwd': IN_PER_STEP,
    'conv4s2': (3 * F2_DOWN + 3 * D1_CONV + 3 * D2_CONV
                + 3 * F2_UP + (G1_CONVT - 1)),
    'convt4s2': (G1_CONVT + 3 * F2_UP
                 + 2 * (D1_CONV - D1_STEMS) + 2 * (D2_CONV - D2_STEMS)
                 + D1_CONV + D2_CONV + (F2_DOWN - 1) + 2 * F2_DOWN),
}

# With the region's gate on (SGAN_TPU_CONV3_IN=1), G2's one site that passes
# it at README widths, blockh0's first inter conv (64 -> 64 at 512^2, then IN
# and ReLU), runs as conv3x3_in_stats + instance_norm_apply: one conv3x3 and
# one instance_norm_act fewer per G2 forward; its backward keeps the IN
# backward and the conv's dx and dW.  Its bias takes part (a gradient).
G2_REGION_SITES = 1
REGION_BIASES = ('G2.blockh0.1.model.1.bias',)


def gated(per_g2, counts):
    """Launch counts with the gate on, for `per_g2` G2 forwards."""
    n = per_g2 * G2_REGION_SITES
    return dict(counts, conv3x3=counts['conv3x3'] - n,
                instance_norm_act=counts['instance_norm_act'] - n,
                conv3x3_in_stats=n, instance_norm_apply=n)


# The stage-1 step's launches (n_update_D 1, n_update_G 2): G runs 3 times
# (the first fake, then a recomputed one after each G update; the G loss
# backpropagates through the recorded fake); its 6 transposed convs' dx is
# conv4s2 for the 5 whose input is not the noise, in the 2 G updates.  The
# D bank has 3 Ds of n_layers 3: each 3 k4 s2 convs and 3 IN.  The D update
# runs the bank twice (pooled fake, real: detached, so no stem dx), each G
# update once (every dx).  Every IN forward has its backward.
S1_G_RUNS, S1_G_CONVT, S1_G_UPDATES = 3, 6, 2
S1_DS, S1_D_CONV, S1_D_IN = 3, 3, 3
S1_D_PASSES = 2 + S1_G_UPDATES
STAGE1_PER_STEP = {
    'convt4s2': (S1_G_RUNS * S1_G_CONVT + 2 * S1_DS * (S1_D_CONV - 1)
                 + S1_G_UPDATES * S1_DS * S1_D_CONV),
    'conv4s2': (S1_D_PASSES * S1_DS * S1_D_CONV
                + S1_G_UPDATES * (S1_G_CONVT - 1)),
    'instance_norm_act': S1_D_PASSES * S1_DS * S1_D_IN,
    'instance_norm_bwd': S1_D_PASSES * S1_DS * S1_D_IN,
}

KERNEL_INFO = {
    'conv3x3': dict(source='supervised_gan_tpu_torch/csrc/conv3x3.cu',
                    replaces='supervised_gan_tpu/ops/pallas/conv3x3.py:143'),
    'convt4s2': dict(source='supervised_gan_tpu_torch/csrc/convt4s2.cu',
                     replaces='supervised_gan_tpu/ops/pallas/convt4s2.py:157'),
    'instance_norm_act': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:109'),
    'conv3x3_dw': dict(source='supervised_gan_tpu_torch/csrc/conv3x3_dw.cu',
                       replaces='supervised_gan_tpu/ops/pallas/conv3x3.py:226'),
    'instance_norm_bwd': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:319'),
    'conv4s2': dict(source='supervised_gan_tpu_torch/csrc/conv4s2.cu',
                    replaces='supervised_gan_tpu/ops/pallas/conv4s2.py:81'),
    'conv3x3_in_stats': dict(
        source='supervised_gan_tpu_torch/csrc/conv3x3_in.cu',
        replaces='supervised_gan_tpu/ops/pallas/conv3x3_in.py:65'),
    'instance_norm_apply': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:312'),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def expected(per_unit, units):
    """Every wrapper's launch count: per_unit[name] x units, else 0."""
    out = {k.__name__: 0 for k in K.KERNELS}
    out.update({k: v * units for k, v in per_unit.items()})
    return out


@contextlib.contextmanager
def region_gate(on):
    """The fused conv3x3 + IN region's gate (SGAN_TPU_CONV3_IN), set for
    this block."""
    before = nn_core._CONV3_IN_FUSED
    nn_core._CONV3_IN_FUSED = on
    try:
        yield
    finally:
        nn_core._CONV3_IN_FUSED = before


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


def bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                        else 'bytes')


def err(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol):
    return bool(((a.float() - b.float()).abs()
                 <= tol + tol * b.float().abs()).all())


def within_sum(a, b, tol, atol=2e-5):
    """max |a - b| <= atol + tol * max |b|: for results that sum many
    products (a weight gradient sums every pixel)."""
    return err(a, b) <= atol + tol * float(b.float().abs().max())


def randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device=DEV) * scale


def _bf16(args):
    return tuple(None if a is None else a.to(torch.bfloat16) for a in args)


# kern, plain and lib take mk(gen)'s tuple; to16 makes its bf16 version
Case = collections.namedtuple(
    'Case', 'kernel label count kern plain lib flops nbytes nbytes16 mk '
            'close to16', defaults=(_bf16,))


def sampler_cases():
    """The forward kernels at the sampler's sites (count: per sample)."""
    cases = []
    for ci, co, s, has_b in CONVT_SITES:
        def mk(gen, ci=ci, co=co, s=s, has_b=has_b):
            return (randn((1, ci, s, s), gen),
                    randn((ci, co, 4, 4), gen, (4 * ci) ** -0.5),
                    randn((co,), gen, 0.1) if has_b else None)
        elems = ci * s * s + ci * co * 16 + co * (2 * s) ** 2
        cases.append(Case('convt4s2', '%d->%d @%d^2' % (ci, co, s), 1,
                          K.convt4s2, K.convt4s2_plain,
                          lambda x, w, b: F.conv_transpose2d(x, w, b, 2, 1),
                          2.0 * co * (2 * s) ** 2 * ci * 4,
                          4.0 * elems + 4.0 * co * has_b,
                          2.0 * elems + 4.0 * co * has_b, mk, within))
    for ci, co, s, has_b in CONV3_SITES:
        def mk(gen, ci=ci, co=co, s=s, has_b=has_b):
            return (randn((1, ci, s, s), gen),
                    randn((co, ci, 3, 3), gen, (9 * ci) ** -0.5),
                    randn((co,), gen, 0.1) if has_b else None)
        elems = ci * s * s + co * ci * 9 + co * s * s
        cases.append(Case('conv3x3', '%d->%d @%d^2' % (ci, co, s), 1,
                          K.conv3x3, K.conv3x3_plain,
                          lambda x, w, b: F.conv2d(x, w, b, 1, 1),
                          2.0 * co * s * s * ci * 9,
                          4.0 * elems + 4.0 * co * has_b,
                          2.0 * elems + 4.0 * co * has_b, mk, within))
    for c, s, slope in IN_SITES:
        def mk(gen, c=c, s=s):
            return (randn((1, c, s, s), gen, 2.0) + 0.5,)

        def lib(x, slope=slope):
            y = F.instance_norm(x, eps=1e-5)
            if slope is None:
                return y
            return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)
        n = c * s * s
        cases.append(Case('instance_norm_act',
                          '%d @%d^2 slope %s' % (c, s, slope), 1,
                          lambda x, slope=slope: K.instance_norm_act(
                              x, 1e-5, slope),
                          lambda x, slope=slope: K.instance_norm_act_plain(
                              x, 1e-5, slope),
                          lib, 6.0 * n, 8.0 * n, 4.0 * n, mk, within))
    return cases


def run_cases(cases):
    """Each case: kernel vs plain in f32 and bf16, then device times.
    Returns (per-site records, per-kernel sums weighted by each site's
    count)."""
    gen = torch.Generator(device=DEV).manual_seed(1234)
    per_site, agg = [], {}
    for c in cases:
        args = c.mk(gen)
        y, ref = c.kern(*args), c.plain(*args)
        torch.cuda.synchronize()
        e32 = err(y, ref)
        check(y.shape == ref.shape and bool(torch.isfinite(y).all()),
              '%s %s: bad output' % (c.kernel, c.label))
        check(c.close(y, ref, 1e-4), '%s %s: f32 max abs err %.3g'
              % (c.kernel, c.label, e32))
        args16 = c.to16(args)
        y16, ref16 = c.kern(*args16), c.plain(*args16)
        torch.cuda.synchronize()
        tol16 = 1e-4 if c.close is within_sum else 2e-2
        e16 = err(y16, ref16)
        check(c.close(y16, ref16, tol16), '%s %s: bf16 max abs err %.3g'
              % (c.kernel, c.label, e16))
        t_k = device_ms(lambda: c.kern(*args))
        t_k16 = device_ms(lambda: c.kern(*args16))
        t_p = device_ms(lambda: c.plain(*args))
        t_l = device_ms(lambda: c.lib(*args))
        t_call = call_ms(lambda: c.kern(*args))
        b_ms, b_by = bound_ms(c.flops, c.nbytes)
        b16_ms, b16_by = bound_ms(c.flops, c.nbytes16, PEAK_BF16_FLOPS)
        per_site.append(dict(
            kernel=c.kernel, site=c.label, count=c.count, max_abs_err=e32,
            max_abs_err_bf16=e16, ms=t_k, ms_bf16=t_k16, plain_ms=t_p,
            library_ms=t_l, call_ms=t_call, bound_ms=b_ms, bound_by=b_by,
            bound_ms_bf16=b16_ms, bound_by_bf16=b16_by, flops=c.flops,
            bytes=c.nbytes))
        print('  %-17s %-26s x%-3d err f32 %.2e bf16 %.2e | kernel %.4f ms '
              '(bf16 %.4f, eager call %.4f) plain %.4f library %.4f bound '
              '%.4f (%s)' % (c.kernel, c.label, c.count, e32, e16, t_k,
                             t_k16, t_call, t_p, t_l, b_ms, b_by))
        a = agg.setdefault(c.kernel, dict(
            max_abs_err=0.0, ms=0.0, ms_bf16=0.0, plain_ms=0.0,
            library_ms=0.0, bound_ms=0.0, bound_ms_bf16=0.0, flops=0.0,
            bytes=0.0, bytes16=0.0, sites=0))
        a['max_abs_err'] = max(a['max_abs_err'], e32)
        for k, v in (('ms', t_k), ('ms_bf16', t_k16), ('plain_ms', t_p),
                     ('library_ms', t_l), ('bound_ms', b_ms),
                     ('bound_ms_bf16', b16_ms), ('flops', c.flops),
                     ('bytes', c.nbytes), ('bytes16', c.nbytes16)):
            a[k] += v * c.count
        a['sites'] += c.count
    for a in agg.values():
        _, a['bound_by'] = bound_ms(a['flops'], a['bytes'])
    return per_site, agg


# ---------------------------------------------- the fused region, row 6 -- #

# the CRN's 64 -> 64 trunk convs followed by IN, 16^2 to 512^2
REGION_SIDES = (16, 32, 64, 128, 256, 512)


def _region_lib(x, w, b):
    """The library pair: cuDNN's conv, then aten's instance_norm and relu."""
    return F.relu(F.instance_norm(F.conv2d(x, w, b, 1, 1), eps=1e-5))


def phase_region():
    """conv3x3_in_stats and instance_norm_apply at the trunk sites against
    their plain versions (f32, bf16; slopes None and 0.0), run-to-run
    identity, and device times.  Returns (per-site records, per-kernel sums
    over the sites of one G2 forward at the default pixel minimum)."""
    gen = torch.Generator(device=DEV).manual_seed(4321)
    per_site = []
    agg = {name: dict(max_abs_err=0.0, ms=0.0, ms_bf16=0.0, plain_ms=0.0,
                      library_ms=None, bound_ms=0.0, flops=0.0, bytes=0.0,
                      sites=0)
           for name in ('conv3x3_in_stats', 'instance_norm_apply')}
    for side in REGION_SIDES:
        site = '64->64 @%d^2' % side
        count = int(side * side >= ops_conv.CONV3_MIN_PIXELS)
        x = randn((1, 64, side, side), gen)
        w = randn((64, 64, 3, 3), gen, (9 * 64) ** -0.5)
        b = randn((64,), gen, 0.1)
        errs = {}
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            args = (x.to(dt), w.to(dt), b.to(dt))
            y, m, r = K.conv3x3_in_stats(*args)
            again = K.conv3x3_in_stats(*args)
            yp, mp, rp = K.conv3x3_in_stats_plain(*args)
            torch.cuda.synchronize()
            check(y.shape == yp.shape and y.dtype == dt
                  and bool(torch.isfinite(y).all()),
                  'conv3x3_in_stats %s %s: bad output' % (site, tag))
            check(all(torch.equal(a, c) for a, c in zip((y, m, r), again)),
                  'conv3x3_in_stats %s %s: two runs differ' % (site, tag))
            check(within(y, yp, tol), 'conv3x3_in_stats %s %s: y off by %.3g'
                  % (site, tag, err(y, yp)))
            for name, a, c in (('mean', m, mp), ('rstd', r, rp)):
                check(within_sum(a, c, 1e-4, atol=1e-7),
                      'conv3x3_in_stats %s %s: %s off by %.3g of its largest '
                      'entry' % (site, tag, name,
                                 err(a, c) / float(c.abs().max())))
            e_apply = e_region = 0.0
            for slope in (None, 0.0):
                z = K.instance_norm_apply(y, m, r, slope)
                zp = K.instance_norm_apply_plain(y, m, r, slope)
                zr = K.instance_norm_apply_plain(yp, mp, rp, slope)
                torch.cuda.synchronize()
                check(within(z, zp, tol) and within(z, zr, tol),
                      'region %s %s slope %s: apply off by %.3g, region off '
                      'the plain region by %.3g' % (site, tag, slope,
                                                    err(z, zp), err(z, zr)))
                e_apply = max(e_apply, err(z, zp))
                e_region = max(e_region, err(z, zr))
            errs[tag] = dict(y=err(y, yp), mean=err(m, mp), rstd=err(r, rp),
                             apply=e_apply, region=e_region)
        x16, w16, b16 = x.bfloat16(), w.bfloat16(), b.bfloat16()
        y, m, r = K.conv3x3_in_stats(x, w, b)
        y16, m16, r16 = K.conv3x3_in_stats(x16, w16, b16)
        t = dict(
            kernel=device_ms(lambda: K.conv3x3_in_stats(x, w, b)),
            kernel_bf16=device_ms(lambda: K.conv3x3_in_stats(x16, w16, b16)),
            plain=device_ms(lambda: K.conv3x3_in_stats_plain(x, w, b)),
            conv3x3=device_ms(lambda: K.conv3x3(x, w, b)),
            apply=device_ms(lambda: K.instance_norm_apply(y, m, r, 0.0)),
            apply_bf16=device_ms(
                lambda: K.instance_norm_apply(y16, m16, r16, 0.0)),
            apply_plain=device_ms(
                lambda: K.instance_norm_apply_plain(y, m, r, 0.0)),
            region=device_ms(lambda: K.instance_norm_apply(
                *K.conv3x3_in_stats(x, w, b), 0.0)),
            split=device_ms(lambda: K.instance_norm_act(
                K.conv3x3(x, w, b), 1e-5, 0.0)),
            library_pair=device_ms(lambda: _region_lib(x, w, b)))
        n_out = 64.0 * side * side
        flops = 2.0 * 9 * 64 * n_out + 3.0 * n_out
        nbytes = 4.0 * (2 * n_out + 64 * 64 * 9 + 64 + 2 * 64)
        b_ms, b_by = bound_ms(flops, nbytes)
        a_flops, a_bytes = 3.0 * n_out, 8.0 * n_out + 8.0 * 64
        a_ms, a_by = bound_ms(a_flops, a_bytes)
        per_site.append(dict(kernel='conv3x3_in_stats', site=site,
                             count=count, errors=errs, ms=t,
                             bound_ms=b_ms, bound_by=b_by,
                             apply_bound_ms=a_ms, apply_bound_by=a_by))
        print('  region %-14s x%d err f32 %s bf16 %s | stats kernel %.4f ms '
              '(bf16 %.4f) plain %.4f conv3x3 %.4f bound %.4f (%s); apply '
              '%.4f (bf16 %.4f) plain %.4f bound %.4f (%s); region %.4f split '
              '%.4f library pair %.4f' % (
                  site, count, errs['f32'], errs['bf16'], t['kernel'],
                  t['kernel_bf16'], t['plain'], t['conv3x3'], b_ms, b_by,
                  t['apply'], t['apply_bf16'], t['apply_plain'], a_ms, a_by,
                  t['region'], t['split'], t['library_pair']))
        for name, vals in (
                ('conv3x3_in_stats', dict(
                    max_abs_err=errs['f32']['y'], ms=t['kernel'],
                    ms_bf16=t['kernel_bf16'], plain_ms=t['plain'],
                    bound_ms=b_ms, flops=flops, bytes=nbytes)),
                ('instance_norm_apply', dict(
                    max_abs_err=errs['f32']['apply'], ms=t['apply'],
                    ms_bf16=t['apply_bf16'], plain_ms=t['apply_plain'],
                    bound_ms=a_ms, flops=a_flops, bytes=a_bytes))):
            a = agg[name]
            a['max_abs_err'] = max(a['max_abs_err'], vals.pop('max_abs_err'))
            for k, v in vals.items():
                a[k] += v * count
            a['sites'] += count
    for a in agg.values():
        _, a['bound_by'] = bound_ms(a['flops'], a['bytes'])
    return per_site, agg


# ------------------------------------------------ the train step's sites -- #

def train_opt(extra):
    return TrainOptions().parse(TRAIN_FLAGS + ON_CARD + extra)


def fixed_batch(px=512, seed=0):
    rng = np.random.RandomState(seed)
    a = np.zeros((1, px, px, 3), np.float32)
    a[..., 0] = (rng.rand(px, px) > 0.7) * 2.0 - 1.0
    a[..., 1] = (rng.rand(px, px) > 0.8) * 2.0 - 1.0
    a[..., 2] = rng.uniform(-1, 1, (px, px))
    return {'A': a, 'A_paths': ['synthetic.png']}


def _recorder(fn, key_of, book):
    def wrapped(*args, **kw):
        book[key_of(*args, **kw)] += 1
        return fn(*args, **kw)
    return wrapped


def _shape(t):
    return tuple(t.shape)


def record_train_sites():
    """One f32 step of the bench configuration with the kernel wrappers and
    the Functions wrapped to count their calls by signature."""
    books = {k: collections.Counter() for k in (
        'conv3x3_dw', 'instance_norm_bwd', 'conv4s2', 'Conv3x3', 'ConvT4s2',
        'Conv4s2', 'InstanceNormAct', 'conv3x3_dx', 'conv4s2_dx')}
    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    patch(functions, 'conv3x3_dw', _recorder(
        K.conv3x3_dw, lambda x, g: (_shape(x), g.shape[1]),
        books['conv3x3_dw']))
    patch(functions, 'instance_norm_bwd', _recorder(
        K.instance_norm_bwd, lambda x, g, m, r, slope=None: (_shape(x), slope),
        books['instance_norm_bwd']))
    patch(functions, 'conv4s2', _recorder(
        K.conv4s2, lambda x, w, b=None: (_shape(x), _shape(w), b is not None),
        books['conv4s2']))
    patch(functions, '_conv3x3_dx', _recorder(
        functions._conv3x3_dx, lambda g, w: (_shape(g), _shape(w)),
        books['conv3x3_dx']))
    # convt4s2 runs in ConvT4s2's forward and as Conv4s2's dx: a call made
    # outside a ConvT4s2 forward is a dx
    in_convt_forward = []

    def convt4s2(x, w, b=None):
        if not in_convt_forward:
            books['conv4s2_dx'][(_shape(x), _shape(w))] += 1
        return K.convt4s2(x, w, b)
    patch(functions, 'convt4s2', convt4s2)

    def fn_recorder(name, cls, key_of, depth=None):
        class Recorded:
            @staticmethod
            def apply(*args):
                books[name][key_of(*args)] += 1
                if depth is None:
                    return cls.apply(*args)
                depth.append(name)
                try:
                    return cls.apply(*args)
                finally:
                    depth.pop()
        return Recorded

    conv_key = (lambda x, w, b: (_shape(x), _shape(w), b is not None))
    patch(ops_conv, 'Conv3x3', fn_recorder('Conv3x3', K.Conv3x3, conv_key))
    patch(ops_conv, 'ConvT4s2', fn_recorder('ConvT4s2', K.ConvT4s2,
                                            conv_key, in_convt_forward))
    patch(ops_conv, 'Conv4s2', fn_recorder('Conv4s2', K.Conv4s2, conv_key))
    patch(ops_norm, 'InstanceNormAct', fn_recorder(
        'InstanceNormAct', K.InstanceNormAct,
        lambda x, eps, slope: (_shape(x), slope)))
    try:
        model = create_model(train_opt(['--compute_dtype', 'float32',
                                        '--name', TRAIN_NAME + '_sites']))
        model.set_input(fixed_batch())
        model.optimize_parameters()
        torch.cuda.synchronize()
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
    del model
    torch.cuda.empty_cache()
    return books


def _slope_act_backward(g, y, slope):
    if slope is None:
        return g
    if slope == 0.0:
        return torch.ops.aten.threshold_backward(g, y, 0.0)
    return torch.ops.aten.leaky_relu_backward(g, y, slope, True)


def train_cases(books):
    """Kernels A, B and C at every recorded site (count: per step)."""
    cases = []
    for (xs, co), count in sorted(books['conv3x3_dw'].items()):
        n, ci, h, w = xs

        def mk(gen, xs=xs, co=co):
            return (randn(xs, gen), randn((xs[0], co) + xs[2:], gen))
        elems = n * (ci + co) * h * w
        cases.append(Case(
            'conv3x3_dw', '%d->%d @%dx%d' % (ci, co, h, w), count,
            K.conv3x3_dw, K.conv3x3_dw_plain,
            lambda x, g, ci=ci, co=co: torch.nn.grad.conv2d_weight(
                x, (co, ci, 3, 3), g, 1, 1),
            2.0 * co * ci * 9 * n * h * w, 4.0 * elems + 36.0 * co * ci,
            2.0 * elems + 36.0 * co * ci, mk, within_sum))
    for (xs, slope), count in sorted(books['instance_norm_bwd'].items(),
                                     key=lambda kv: (kv[0][0],
                                                     str(kv[0][1]))):
        n, c, h, w = xs

        def mk(gen, xs=xs, slope=slope):
            x = randn(xs, gen, 2.0) + 0.5
            y, mean, rstd = K.instance_norm_act_plain(x, 1e-5, slope,
                                                      return_stats=True)
            return (x, randn(xs, gen), mean.contiguous(), rstd.contiguous(),
                    y)

        def to16(a):
            return (a[0].bfloat16(), a[1].bfloat16(), a[2], a[3],
                    a[4].bfloat16())

        def lib(x, g, mean, rstd, y, slope=slope):
            # the two aten calls that autograd of F.instance_norm + act runs
            gy = _slope_act_backward(g, y, slope)
            n_, c_, h_, w_ = x.shape
            return torch.ops.aten.native_batch_norm_backward(
                gy.reshape(1, n_ * c_, h_, w_), x.reshape(1, n_ * c_, h_, w_),
                None, None, None, mean.reshape(-1), rstd.reshape(-1), True,
                1e-5, [True, False, False])[0]
        elems = n * c * h * w
        cases.append(Case(
            'instance_norm_bwd', '%d @%dx%d slope %s' % (c, h, w, slope),
            count,
            lambda x, g, m, r, y, slope=slope: K.instance_norm_bwd(
                x, g, m, r, slope),
            lambda x, g, m, r, y, slope=slope: K.instance_norm_bwd_plain(
                x, g, m, r, slope),
            lib, 10.0 * elems, 12.0 * elems + 8.0 * n * c,
            6.0 * elems + 8.0 * n * c, mk, within, to16))
    for (xs, ws, has_b), count in sorted(books['conv4s2'].items()):
        n, ci, h, w = xs
        co = ws[0]
        ho, wo = (h - 2) // 2 + 1, (w - 2) // 2 + 1

        def mk(gen, xs=xs, ws=ws, has_b=has_b):
            return (randn(xs, gen), randn(ws, gen, (16 * ws[1]) ** -0.5),
                    randn((ws[0],), gen, 0.1) if has_b else None)
        elems = n * ci * h * w + co * ci * 16 + n * co * ho * wo
        cases.append(Case(
            'conv4s2', '%d->%d @%dx%d%s' % (ci, co, h, w,
                                            ' +b' if has_b else ''),
            count, K.conv4s2, K.conv4s2_plain,
            lambda x, w_, b: F.conv2d(x, w_, b, 2, 1),
            2.0 * co * ci * 16 * n * ho * wo, 4.0 * elems + 4.0 * co * has_b,
            2.0 * elems + 4.0 * co * has_b, mk, within))
    # the dx launches of the conv3x3 and convt4s2 wrappers, against the
    # library call of the same function (for PERF.md's rows 1 and 4)
    for (gs, ws), count in sorted(books['conv3x3_dx'].items()):
        n, co, h, w = gs
        ci = ws[1]

        def mk(gen, gs=gs, ci=ci, co=co):
            return (randn(gs, gen), randn((ci, co, 3, 3), gen,
                                          (9 * co) ** -0.5), None)
        elems = n * (co + ci) * h * w + ci * co * 9
        cases.append(Case(
            'conv3x3_dx', '%d->%d @%dx%d' % (co, ci, h, w), count,
            K.conv3x3, K.conv3x3_plain,
            lambda x, w_, b: F.conv2d(x, w_, b, 1, 1),
            2.0 * ci * co * 9 * n * h * w, 4.0 * elems, 2.0 * elems, mk,
            within))
    for (gs, ws), count in sorted(books['conv4s2_dx'].items()):
        n, co, h, w = gs
        ci = ws[1]

        def mk(gen, gs=gs, ws=ws):
            return (randn(gs, gen), randn(ws, gen, (4 * ws[0]) ** -0.5), None)
        elems = n * co * h * w + co * ci * 16 + n * ci * 4 * h * w
        cases.append(Case(
            'convt4s2_dx', '%d->%d @%dx%d' % (co, ci, h, w), count,
            K.convt4s2, K.convt4s2_plain,
            lambda x, w_, b: F.conv_transpose2d(x, w_, b, 2, 1),
            2.0 * ci * 4 * h * w * co * 4 * n, 4.0 * elems, 2.0 * elems, mk,
            within))
    return cases


def _grads_close(name, site, ours, plain, tol=1e-4):
    worst = 0.0
    for which, a, b in zip(('dx', 'dW', 'db'), ours, plain):
        if b is None:
            continue
        ratio = err(a, b) / max(float(b.float().abs().max()), 1e-30)
        worst = max(worst, ratio)
        check(within_sum(a, b, tol, atol=1e-6),
              '%s %s: %s off autograd of the plain forward by %.3g of its '
              'largest entry' % (name, site, which, ratio))
    return worst


def phase_functions(books):
    """Each Function's dx, dW, db at every recorded site against autograd
    through the plain forward, f32."""
    gen = torch.Generator(device=DEV).manual_seed(77)
    plains = {'Conv3x3': K.conv3x3_plain, 'ConvT4s2': K.convt4s2_plain,
              'Conv4s2': K.conv4s2_plain}
    out = {}
    for name in ('Conv3x3', 'ConvT4s2', 'Conv4s2'):
        worst = 0.0
        for (xs, ws, has_b) in sorted(books[name]):
            fan = ws[1] * ws[2] * ws[3] if name != 'ConvT4s2' else ws[0] * 4
            args = [randn(xs, gen), randn(ws, gen, fan ** -0.5)]
            if has_b:
                co = ws[1] if name == 'ConvT4s2' else ws[0]
                args.append(randn((co,), gen, 0.1))
            ts = [a.clone().requires_grad_(True) for a in args]
            y = getattr(K, name).apply(*ts, *([] if has_b else [None]))
            g = torch.randn(y.shape, generator=gen, device=DEV)
            ours = torch.autograd.grad(y, ts, g)
            ps = [a.clone().requires_grad_(True) for a in args]
            y_plain = plains[name](*ps)
            check(within(y.detach(), y_plain.detach(), 1e-4),
                  '%s %s: forward off the plain version by %.3g'
                  % (name, (xs, ws), err(y.detach(), y_plain.detach())))
            plain = torch.autograd.grad(y_plain, ps, g)
            worst = max(worst, _grads_close(name, (xs, ws), ours, plain))
        out[name] = dict(sites=len(books[name]), worst_ratio=worst)
        print('  %-15s %3d sites: y within 1e-4; dx, dW, db within %.2e of '
              'their largest entry' % (name, len(books[name]), worst))
    worst = 0.0
    for xs, slope in sorted(books['InstanceNormAct'],
                            key=lambda k: (k[0], str(k[1]))):
        x = randn(xs, gen, 2.0) + 0.5
        g = randn(xs, gen)
        xt = x.clone().requires_grad_(True)
        y = K.InstanceNormAct.apply(xt, 1e-5, slope)
        (ours,) = torch.autograd.grad(y, xt, g)
        xp = x.clone().requires_grad_(True)
        y_plain = K.instance_norm_act_plain(xp, 1e-5, slope)
        check(within(y.detach(), y_plain.detach(), 1e-4),
              'InstanceNormAct %s: forward off the plain version by %.3g'
              % (xs, err(y.detach(), y_plain.detach())))
        (plain,) = torch.autograd.grad(y_plain, xp, g)
        worst = max(worst, _grads_close('InstanceNormAct', xs, (ours,),
                                        (plain,)))
    out['InstanceNormAct'] = dict(sites=len(books['InstanceNormAct']),
                                  worst_ratio=worst)
    print('  %-15s %3d sites: y within 1e-4; dx within %.2e of its largest '
          'entry' % ('InstanceNormAct', len(books['InstanceNormAct']), worst))
    out['Conv3x3InAct'] = phase_region_function(gen)
    return out


def phase_region_function(gen, side=512):
    """Conv3x3InAct at the region's site (64 -> 64 at 512^2, bias), in f32
    and in bf16, with no activation and with the site's ReLU, against
    autograd through its plain forward on the same tensors: within 1e-4 in
    f32 and 2e-2 in bf16 (run_cases' tolerances).  With the ReLU the plain
    forward takes its mask from the kernels' own pre-activation: ~10 of the
    site's 16.7M pre-activations lie within the conv's f32 rounding of 0,
    and a mask flipped at one of them moves dx by ~4 % of its largest entry,
    whatever the kernels' own error.  db sums the norm's input cotangent,
    rounding noise around 0 on both sides: it is held within the tolerance
    times the largest per-channel sum of |dconv|, the scale of that sum's
    rounding error."""
    base = [randn((1, 64, side, side), gen),
            randn((64, 64, 3, 3), gen, (9 * 64) ** -0.5),
            randn((64,), gen, 0.1)]
    g32 = randn((1, 64, side, side), gen)
    out = {}
    for tag, dt, tol in (('f32', torch.float32, 1e-4),
                         ('bf16', torch.bfloat16, 2e-2)):
        args = [a.to(dt) for a in base]
        g = g32.to(dt)
        with torch.no_grad():
            pre = K.instance_norm_apply_plain(*K.conv3x3_in_stats(*args),
                                              None)
        for slope in (None, 0.0):
            site = '%s slope %s' % (tag, slope)
            ts = [a.clone().requires_grad_(True) for a in args]
            y = K.Conv3x3InAct.apply(*ts, 1e-5, slope)
            ours = torch.autograd.grad(y, ts, g)
            ps = [a.clone().requires_grad_(True) for a in args]
            yc, mean, rstd = K.conv3x3_in_stats_plain(*ps)
            y_plain = K.instance_norm_apply_plain(yc, mean, rstd, None)
            if slope is not None:
                y_plain = torch.where(pre >= 0, y_plain, y_plain * slope)
            check(y.dtype == dt and all(o.dtype == dt for o in ours),
                  'Conv3x3InAct %s: output or gradient dtype' % site)
            check(within(y.detach(), y_plain.detach(), tol),
                  'Conv3x3InAct %s: forward off the plain version by %.3g'
                  % (site, err(y.detach(), y_plain.detach())))
            plain = torch.autograd.grad(y_plain, ps, g)
            worst = _grads_close('Conv3x3InAct', site, ours[:2], plain[:2],
                                 tol)
            dconv = K.instance_norm_bwd_plain(yc.detach(), g, mean.detach(),
                                              rstd.detach(), slope)
            db_scale = float(dconv.float().abs().sum(dim=(0, 2, 3)).max())
            db_err = err(ours[2], plain[2])
            check(db_err <= tol * db_scale, 'Conv3x3InAct %s: db off by '
                  '%.3g, %.3g of the largest sum of |dconv|'
                  % (site, db_err, db_err / db_scale))
            print('  %-15s %-16s: y within %g; dx, dW within %.2e of their '
                  'largest entry; db off by %.2e (largest sum of |dconv| '
                  '%.3g)' % ('Conv3x3InAct', site, tol, worst, db_err,
                             db_scale))
            out[site] = dict(worst_ratio=worst, db_err=db_err,
                             db_scale=db_scale)
    return out


# ------------------------------------------------------------- sampler -- #

def save_readme_weights():
    """G1, G2 and F2 at README widths from seed 0, G1 and G2 on cuda:0,
    written as the sampler's latest_net_{G1,G2,F2}.pth (F2 is loaded and
    not run)."""
    gen = torch.Generator().manual_seed(0)
    g1 = tnn.define_G(2, 0, 32, 'fcgan', 'instance', False, n_layers_G=5,
                      use_fcn=True, noise_nc=8, generator=gen).to(DEV)
    g2 = tnn.define_G(2, 1, 64, 'crn', 'instance', False, n_layers_G=5,
                      noise_nc=8, upsample_mode='bilinear',
                      n_layers_CRN_block=2, generator=gen).to(DEV)
    f2 = tnn.define_G(1, 2, 32, 'unet_128', 'instance', True, generator=gen)
    d = os.path.join(CKPT_DIR, NAME)
    os.makedirs(d, exist_ok=True)
    for net, label in ((g1, 'G1'), (g2, 'G2'), (f2, 'F2')):
        pth.save_pth(os.path.join(d, 'latest_net_%s.pth' % label), net)
    return g1, g2


SAMPLER_PER_SAMPLE = {'conv3x3': len(CONV3_SITES),
                      'convt4s2': len(CONVT_SITES),
                      'instance_norm_act': len(IN_SITES)}


def run_sampler(flags, samples, results_dir, per_sample=SAMPLER_PER_SAMPLE,
                visuals=('fake_A', 'fake_B')):
    """The sampler entry point in-process, with the launch counts set to 0
    just before and read just after."""
    K.reset_launch_counts()
    r = sampler.main(flags + ['--gpu_ids', '0', '--how_many', str(samples),
                              '--results_dir', results_dir])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    expect = expected(per_sample, samples)
    check(counts == expect, 'launch counts %s, expected %s' % (counts, expect))
    check(r['nonfinite'] == 0, '%d samples with non-finite values'
          % r['nonfinite'])
    images = os.path.join(r['web_dir'], 'images')
    names = sorted(os.listdir(images))
    want = sorted('%04d_%s.png' % (i + 1, v) for i in range(samples)
                  for v in visuals)
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


def profile_rows(run, n, trace_name):
    """Device time per run of fn by kernel from a torch.profiler trace of n
    runs: (rows sorted by time, total device ms per run)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    # user annotations on the device timeline (Optimizer.step#Adam.step)
    # span kernels that are counted already
    rows = [(e.key, e.self_device_time_total / (n * 1e3), e.count / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, 'is_user_annotation', False)]
    prof.export_chrome_trace(os.path.join(OUT_DIR, trace_name))
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


# device kernel symbols of each wrapper, as the profiler names them
KERNEL_SYMBOLS = {
    'conv3x3': ('conv3x3_kernel',), 'convt4s2': ('convt4s2_kernel',),
    'instance_norm_act': ('in_stats_kernel', 'in_apply_kernel'),
    'conv3x3_dw': ('dw_partial_kernel', 'dw_reduce_kernel'),
    'instance_norm_bwd': ('in_bwd_stats_kernel', 'in_bwd_apply_kernel'),
    'conv4s2': ('conv4s2_kernel', 'conv4s2_reduce_kernel'),
    'conv3x3_in_stats': ('conv3x3_in_kernel', 'conv3x3_in_fold_kernel'),
    'instance_norm_apply': ('in_norm_kernel',)}


# the rest of the device time by what ran it, first match wins
TORCH_GROUPS = (
    ('torch cuDNN conv', ('cudnn', 'implicit_gemm', 'tensorTransform')),
    ('torch cuBLAS matmul', ('gemm',)),
    ('torch copy/cast/cat', ('copy_kernel', 'CatArray')),
    ('torch avg_pool', ('avg_pool',)),
    ('torch index/flip', ('index', 'scatter_gather')),
    ('torch Adam', ('multi_tensor_apply',)))


def by_kernel(rows):
    """Profiler rows grouped by wrapper, {name: [device ms, launches]}, and
    the rest by TORCH_GROUPS, else 'torch elementwise/reduce'."""
    owner = {sym: name for name, syms in KERNEL_SYMBOLS.items()
             for sym in syms}
    out = collections.OrderedDict(
        (name, [0.0, 0.0]) for name in list(KERNEL_SYMBOLS)
        + [g for g, _ in TORCH_GROUPS] + ['torch elementwise/reduce'])
    for key, ms, count in rows:
        sym = key.split('(anonymous namespace)::')[-1].split('<')[0]
        name = owner.get(sym.split('(')[0])
        if name is None:
            name = next((g for g, subs in TORCH_GROUPS
                         if any(t in key for t in subs)),
                        'torch elementwise/reduce')
        out[name][0] += ms
        out[name][1] += count
    return out


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
    rows, total = profile_rows(fwd, 3, 'sampler_trace.json')
    if not rows:
        print('  profiler: no device time recorded; busy share not measured')
        return out
    out['device_ms'] = total
    out['busy_share'] = total / out['wall_ms']
    out['kernels_per_sample'] = sum(r[2] for r in rows)
    out['top'] = rows[:16]
    print('  device time %.3f ms per sample in %.0f kernels, busy share %.3f '
          'of the wall' % (out['device_ms'], out['kernels_per_sample'],
                           out['busy_share']))
    for key, ms, n in out['top']:
        print('    %8.4f ms  x%5.1f  %s' % (ms, n, key[:90]))
    return out


# ------------------------------------------------------------ training -- #

def write_train_set():
    """TRAIN_IMAGES 1024^2 RGB PNGs: sparse binary label maps in R and G,
    a random image in B (the verify skill's recipe at 1024 px)."""
    d = os.path.join(DATA_DIR, 'train')
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(TRAIN_IMAGES):
        a = np.zeros((1024, 1024, 3), np.uint8)
        a[..., 0] = (rng.rand(1024, 1024) > 0.7) * 255
        a[..., 1] = (rng.rand(1024, 1024) > 0.8) * 255
        a[..., 2] = rng.randint(0, 255, (1024, 1024))
        Image.fromarray(a).save(os.path.join(d, '%03d.png' % i))


def run_train(args, name, steps, per_step, nets=None):
    """The train entry point in-process for one epoch of `steps` images,
    launch counts set to 0 just before and read just after, each expected
    to be per_step x steps.  `nets`: the checkpoints the run must write
    (with its full state and web page), or None for a run that saves
    none."""
    K.reset_launch_counts()
    r = trainer.main(args)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(r['steps'] == steps, '%s: %d steps, expected %d'
          % (name, r['steps'], steps))
    expect = expected(per_step, steps)
    check(counts == expect, '%s launch counts %s, expected %s'
          % (name, counts, expect))
    run_dir = os.path.join(CKPT_DIR, name)
    losses = []
    with open(os.path.join(run_dir, 'loss_log.txt')) as f:
        for line in f:
            if line.startswith('=' * 16):          # a run's header
                losses = []
            if line.startswith('(epoch'):
                vals = line.split(')', 1)[1].split()
                losses.append({vals[i][:-1]: float(vals[i + 1])
                               for i in range(0, len(vals), 2)})
    check(len(losses) == steps and all(
        np.isfinite(v) for step in losses for v in step.values()),
        '%s: non-finite or missing losses %s' % (name, losses))
    if nets is not None:
        files = set(os.listdir(run_dir))
        for label in ('1', 'latest'):
            want = {'%s_net_%s.pth' % (label, n) for n in nets} | {
                '%s_state.pt' % label}
            check(want <= files, '%s: missing checkpoints %s'
                  % (name, sorted(want - files)))
        check(os.path.exists(os.path.join(run_dir, 'web', 'index.html')),
              '%s: no web/index.html' % name)
    step_ms = [1e3 * t for t in r['step_seconds']]
    out = dict(steps=steps, launches=counts, first_step_ms=step_ms[0],
               median_step_ms=statistics.median(step_ms[1:]),
               step_ms=step_ms, last_losses=losses[-1])
    print('%s: %d steps, first %.1f ms (kernel build and cuDNN set-up), '
          'median of the rest %.1f ms; launches %s; last losses %s'
          % (name, steps, step_ms[0], out['median_step_ms'], counts,
             losses[-1]))
    return out


def _epoch_flags(name, dtype, steps):
    """One epoch of `steps` images in `dtype`, every step printed (given
    after a command's own flags, these take their place)."""
    return ['--compute_dtype', dtype, '--name', name, '--niter', '1',
            '--niter_decay', '0', '--print_freq', '1', '--max_dataset_size',
            str(steps)]


def bench_train(dtype, steps):
    """The bench.py DSGAN configuration."""
    name = '%s_%s' % (TRAIN_NAME, dtype)
    return run_train(
        TRAIN_FLAGS + ON_CARD + _epoch_flags(name, dtype, steps)
        + ['--display_freq', str(steps), '--save_epoch_freq', '1'],
        name, steps, LAUNCHES_PER_STEP,
        ('G1', 'G2', 'F2', 'D1_0', 'D1_1', 'D2_0', 'D2_1', 'D2_2', 'D2_3'))


def stage1_train(dtype, steps):
    """The stage-1 label GAN's recipe command."""
    name = '%s_%s' % (STAGE1_NAME, dtype)
    return run_train(
        STAGE1_ARCH + STAGE1_TRAIN + ON_CARD + _epoch_flags(name, dtype, steps)
        + ['--display_freq', str(steps), '--save_epoch_freq', '1'],
        name, steps, STAGE1_PER_STEP, ('G', 'D_0', 'D_1', 'D_2'))


def handoff(stage1_name):
    """Stage 1's latest G and first two Ds as the sequential checkpoints."""
    os.makedirs(PRETRAINED_DIR, exist_ok=True)
    for a, b in HANDOFF:
        shutil.copy(os.path.join(CKPT_DIR, stage1_name, a),
                    os.path.join(PRETRAINED_DIR, b))


def readme_args(name, dtype, steps):
    """The README DSGAN command with this checkout's paths and `steps`
    steps of one epoch in `dtype`."""
    args = list(README_DSGAN)
    for flag, value in (('--dataroot', DATA_DIR),
                        ('--pretrained_model_dir', PRETRAINED_DIR)):
        args[args.index(flag) + 1] = value
    return args + ON_CARD + _epoch_flags(name, dtype, steps) + [
        '--checkpoints_dir', CKPT_DIR, '--display_id', '0']


def check_sequential_load():
    """The README command's model holds the hand-off's G1 and D1 bank."""
    model = create_model(TrainOptions().parse(readme_args(
        README_NAME + '_load', 'float32', 1)))
    for label, net in (('G1', model.netG1), ('D1_0', model.netD1[0]),
                       ('D1_1', model.netD1[1])):
        saved = torch.load(os.path.join(PRETRAINED_DIR, 'seq_net_%s.pth'
                                        % label), weights_only=True)
        ours = net.state_dict()
        check(set(ours) == set(saved) and all(
            torch.equal(ours[k].cpu(), v) for k, v in saved.items()),
            '--sequential_train did not load seq_net_%s.pth' % label)
    del model
    torch.cuda.empty_cache()


def readme_train(gate, steps):
    """The README DSGAN command in bf16 with the region's gate on or off."""
    name = '%s_gate_%s' % (README_NAME, 'on' if gate else 'off')
    with region_gate(gate):
        return run_train(readme_args(name, 'bfloat16', steps), name, steps,
                         gated(2, LAUNCHES_PER_STEP) if gate
                         else LAUNCHES_PER_STEP)


def phase_profile_step():
    """One bf16 step of the bench configuration, timed alone (wall, with a
    synchronize) and traced: device time per step by kernel, busy share."""
    model = create_model(train_opt(['--compute_dtype', 'bfloat16', '--name',
                                    TRAIN_NAME + '_profile']))
    model.set_input(fixed_batch())

    def step():
        model.optimize_parameters()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    out = dict(wall_ms=statistics.median(walls), device_ms=None,
               busy_share=None, top=[])
    rows, total = profile_rows(step, 1, 'train_trace.json')
    if rows:
        out.update(device_ms=total, busy_share=total / out['wall_ms'],
                   kernels_per_step=sum(r[2] for r in rows), top=rows[:25],
                   by_kernel=by_kernel(rows))
        print('  bf16 step: %.1f ms wall (median of 3), device %.1f ms in '
              '%.0f kernels, busy share %.3f' % (
                  out['wall_ms'], total, out['kernels_per_step'],
                  out['busy_share']))
        print('  device ms a step by wrapper and torch op class (launches): '
              + ', '.join('%s %.3f (%d)' % (k, v[0], v[1])
                          for k, v in out['by_kernel'].items()))
        for key, ms, n in out['top']:
            print('    %8.4f ms  x%5.1f  %s' % (ms, n, key[:90]))
    else:
        print('  profiler: no device time recorded; busy share not measured')
    del model
    torch.cuda.empty_cache()
    return out


def _step_in_parts(model, d_from=None):
    """optimize_parameters at n_update 1, its three updates called in turn;
    with ``d_from``, the D banks take d_from's parameters between the D
    updates and the G update.  Returns the six loss terms; the D updates'
    gradients stay in the D banks' .grad (the G update takes only G1, G2
    and F2's)."""
    taps = model._record()
    metrics = {'D1': model.update_D1(taps), 'D2': model.update_D2(taps)}
    if d_from is not None:
        with torch.no_grad():
            for label in ('D1', 'D2'):
                for p, q in zip(model.nets()[label].parameters(),
                                d_from.nets()[label].parameters()):
                    p.copy_(q)
    metrics.update(model.update_G(taps))
    return {k: float(v) for k, v in metrics.items()}


def _grad_diffs(model, ref, noise_only=()):
    """Per parameter: (||g - g_ref|| / ||g_ref||, max |g - g_ref| / max
    |g_ref|, name); fails if a parameter has a gradient on one side only.
    The parameters named in ``noise_only`` (whose gradient is rounding
    noise on both sides) must have one on both and are not compared."""
    out = []
    for label, net in model.nets().items():
        theirs = dict(ref.nets()[label].named_parameters())
        for name, p in net.named_parameters():
            r = theirs[name].grad
            if '%s.%s' % (label, name) in noise_only:
                check(p.grad is not None and r is not None,
                      'reference step: %s.%s has no gradient' % (label, name))
                continue
            if p.grad is None or r is None:
                check(p.grad is None and r is None,
                      'reference step: %s.%s has a gradient on one side only'
                      % (label, name))
                continue
            d = p.grad.detach().cpu().double() - r.double()
            out.append((float(d.norm() / max(float(r.double().norm()), 1e-30)),
                        float(d.abs().max()
                              / max(float(r.abs().max()), 1e-30)),
                        '%s.%s' % (label, name)))
    return sorted(out, reverse=True)


def phase_reference_step(gate=False, grad_tol=5e-2):
    """One f32 step at 512 px on the card (kernels) and on the CPU (plain
    versions), same weights, noise and batch, no pool, no dropout; each
    loss term within 1e-3 relative, each parameter's gradient within
    ``grad_tol`` relative in L2.  ``gate``: the region's gate on, on both
    sides (the biases it takes are checked for a gradient only: it is
    rounding noise, as around any norm).

    Adam's first step moves every parameter by about lr * sign(g), so a D
    entry whose gradient is rounding-sized lands 2 lr apart on the two
    sides, and the G update that follows sees two different D banks.  So
    the CPU's D banks take the card's updated parameters before its G
    update.  What is left is f32 rounding, which this step amplifies (IN
    over the 8^2-16^2 planes of the deep D and F2 layers, activation kinks,
    real against fake in the D losses).  For scale, the phase also runs the
    CPU step with every weight scaled by 1 + 1e-6 N(0, 1), a few ulps, and
    prints how far that moves each gradient: the noise floor."""
    with region_gate(gate):
        return _reference_step(REGION_BIASES if gate else (), grad_tol,
                               '_ref_gated' if gate else '_ref')


def _reference_step(noise_only, grad_tol, tag):
    extra = ['--compute_dtype', 'float32', '--pool_size', '0',
             '--no_dropout2']
    card = create_model(train_opt(extra + ['--name', TRAIN_NAME + tag]))
    gen = torch.Generator().manual_seed(11)
    shapes = card._noise_shapes()
    noises = {k: torch.randn(v, generator=gen) for k, v in shapes.items()}
    card.draw_noises = lambda: {k: v.to(DEV) for k, v in noises.items()}
    batch = fixed_batch(seed=5)
    weights = {label: {k: v.cpu().clone()
                        for k, v in net.state_dict().items()}
               for label, net in card.nets().items()}

    def cpu_model(tag):
        m = create_model(TrainOptions().parse(TRAIN_FLAGS + extra + [
            '--gpu_ids', '-1', '--name', TRAIN_NAME + tag]))
        for label, net in m.nets().items():
            net.load_state_dict(weights[label])
        m.draw_noises = lambda: dict(noises)
        m.set_input(batch)
        return m

    card.set_input(batch)
    t = time.perf_counter()
    m_card = _step_in_parts(card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    cpu = cpu_model(tag + '_cpu')
    t = time.perf_counter()
    m_cpu = _step_in_parts(cpu, d_from=card)
    cpu_s = time.perf_counter() - t
    worst_metric = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                       for k in m_cpu)
    worst = _grad_diffs(card, cpu, noise_only)
    noisy = cpu_model(tag + '_cpu_noisy')
    pg = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for net in noisy.nets().values():
            for p in net.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=pg))
    _step_in_parts(noisy, d_from=card)
    floor = _grad_diffs(noisy, cpu, noise_only)
    del noisy
    print('  card step %.3f s, CPU step %.3f s; losses card %s cpu %s; worst '
          'loss rel diff %.2e' % (card_s, cpu_s, m_card, m_cpu, worst_metric))
    print('  gradients, card vs CPU (L2 rel, max-entry rel): %s'
          % [(round(a, 6), round(b, 6), n) for a, b, n in worst[:5]])
    print('  noise floor, CPU with weights x (1 + 1e-6 N) vs CPU: %s'
          % [(round(a, 6), round(b, 6), n) for a, b, n in floor[:5]])
    check(worst_metric <= 1e-3, 'reference step: loss terms differ by %.3g'
          % worst_metric)
    check(worst[0][0] <= grad_tol, 'reference step: %s gradient differs by '
          '%.3g relative in L2' % (worst[0][2], worst[0][0]))
    out = dict(card_s=card_s, cpu_s=cpu_s, losses_card=m_card,
               losses_cpu=m_cpu, worst_loss_rel=worst_metric,
               grad_tol=grad_tol, worst_grads=worst[:10],
               noise_floor=floor[:10], params=len(worst))
    del card, cpu
    torch.cuda.empty_cache()
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
    for d in os.listdir(CKPT_DIR) if os.path.isdir(CKPT_DIR) else []:
        if d.startswith(NAME):
            shutil.rmtree(os.path.join(CKPT_DIR, d))
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

    print('== forward kernels vs plain versions at the 512 px sampler sites')
    per_site, agg = run_cases(sampler_cases())

    print('== the fused conv3x3 + IN region\'s kernels at the CRN trunk sites')
    per_site_r, agg_r = phase_region()
    agg.update(agg_r)

    print('== the train step\'s sites (one f32 step, bench.py configuration)')
    books = record_train_sites()
    for name, book in books.items():
        print('  %-17s %3d calls a step at %3d shapes' % (
            name, sum(book.values()), len(book)))
    dx_per_step = {
        'conv3x3_dx': LAUNCHES_PER_STEP['conv3x3'] - 2 * G2_CONV3,
        'conv4s2_dx': (LAUNCHES_PER_STEP['convt4s2'] - G1_CONVT
                       - 3 * F2_UP)}
    for k, n in list(dx_per_step.items()) + [
            (k, LAUNCHES_PER_STEP[k])
            for k in ('conv3x3_dw', 'instance_norm_bwd', 'conv4s2')]:
        check(sum(books[k].values()) == n, 'recorded %s calls %d, expected '
              '%d a step' % (k, sum(books[k].values()), n))

    print('== kernels A, B, C, and conv3x3 and convt4s2 as dx, vs plain '
          'versions at the train step\'s sites')
    per_site_t, agg_t = run_cases(train_cases(books))
    per_site += per_site_t
    agg.update(agg_t)

    print('== autograd Functions vs autograd of the plain forwards')
    fn_checks = phase_functions(books)

    print('== sampler: DSGAN, 512 px, %d samples' % SAMPLES)
    g1, g2 = save_readme_weights()
    r32, counts = run_sampler(DSGAN_FLAGS, SAMPLES,
                              os.path.join(RESULTS_DIR, 'f32'))
    ips = SAMPLES / r32['loop_seconds']
    print('sampler f32: %d samples in %.3f s = %.3f images/s (drawing %.3f s, '
          'writing images %.3f s); launches %s'
          % (SAMPLES, r32['loop_seconds'], ips, r32['sample_seconds'],
             r32['write_seconds'], counts))
    r16, counts16 = run_sampler(DSGAN_FLAGS + ['--compute_dtype', 'bfloat16'],
                                2, os.path.join(RESULTS_DIR, 'bf16'))
    ips16 = 2 / r16['loop_seconds']
    print('sampler bf16: 2 samples in %.3f s = %.3f images/s; launches %s'
          % (r16['loop_seconds'], ips16, counts16))
    print('== sampler forward alone: wall and device time per sample')
    fwd = phase_forward(g1, g2)
    print('== reference: one 512 px sample, card kernels vs CPU plain')
    phase_reference(g1, g2)
    print('== sampler with the region\'s gate on: %d samples, and one sample '
          'card vs CPU' % SAMPLES)
    with region_gate(True):
        r_gated, counts_gated = run_sampler(
            DSGAN_FLAGS, SAMPLES, os.path.join(RESULTS_DIR, 'gated'),
            gated(1, SAMPLER_PER_SAMPLE))
        phase_reference(g1, g2)
    print('sampler gated f32: %d samples in %.3f s (drawing %.3f s); '
          'launches %s' % (SAMPLES, r_gated['loop_seconds'],
                           r_gated['sample_seconds'], counts_gated))
    del g1, g2
    torch.cuda.empty_cache()

    print('== training: bench.py DSGAN configuration, 512 px')
    write_train_set()
    train16 = bench_train('bfloat16', TRAIN_IMAGES)
    train32 = bench_train('float32', F32_STEPS)
    print('== one bf16 train step profiled')
    prof = phase_profile_step()
    print('== reference: one f32 train step at 512 px, card vs CPU plain')
    ref_step = phase_reference_step()

    print('== stage 1: the label GAN (--model fcgan), recipe command, 512 px')
    stage1_16 = stage1_train('bfloat16', TRAIN_IMAGES)
    stage1_32 = stage1_train('float32', F32_STEPS)
    stage1_name = '%s_bfloat16' % STAGE1_NAME
    r_s1, counts_s1 = run_sampler(
        STAGE1_ARCH + ['--name', stage1_name], 4,
        os.path.join(RESULTS_DIR, 'stage1'), {'convt4s2': G1_CONVT},
        ('fake',))
    print('stage-1 sampler: 4 samples in %.3f s; launches %s'
          % (r_s1['loop_seconds'], counts_s1))

    print('== hand-off: stage 1\'s G and D_0, D_1 as seq_net_{G1,D1_0,D1_1}')
    handoff(stage1_name)
    check_sequential_load()
    print('== the README DSGAN command (--sequential_train), bf16, region '
          'gate on and off')
    readme = {'gate_on': readme_train(True, TRAIN_IMAGES),
              'gate_off': readme_train(False, TRAIN_IMAGES)}
    print('== reference: one f32 train step with the region\'s gate on, '
          'card vs CPU plain')
    ref_step_gated = phase_reference_step(gate=True)

    kernels = []
    for name in ('conv3x3', 'convt4s2', 'instance_norm_act', 'conv3x3_dw',
                 'instance_norm_bwd', 'conv4s2', 'conv3x3_in_stats',
                 'instance_norm_apply'):
        a = agg[name]
        run = readme['gate_on'] if name in agg_r else train16
        kernels.append(dict(
            name=name, route='cuda', source=KERNEL_INFO[name]['source'],
            replaces=KERNEL_INFO[name]['replaces'],
            launches=run['launches'][name],
            max_abs_err=a['max_abs_err'], ms=a['ms'], plain_ms=a['plain_ms'],
            bound_ms=a['bound_ms'], bound_by=a['bound_by'],
            library_ms=a['library_ms']))
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  sites=per_site, region_sites=per_site_r, kernels=kernels,
                  kernel_sums=agg, launches_per_step=LAUNCHES_PER_STEP,
                  stage1_launches_per_step=STAGE1_PER_STEP,
                  train_sites={k: {repr(s): c for s, c in v.items()}
                               for k, v in books.items()},
                  functions=fn_checks, forward=fwd,
                  sampler=dict(samples=SAMPLES,
                               loop_seconds=r32['loop_seconds'],
                               sample_seconds=r32['sample_seconds'],
                               write_seconds=r32['write_seconds'],
                               images_per_second=ips,
                               sampler_launches=counts,
                               bf16_samples=2,
                               bf16_loop_seconds=r16['loop_seconds'],
                               bf16_images_per_second=ips16,
                               gated_loop_seconds=r_gated['loop_seconds'],
                               gated_sample_seconds=r_gated['sample_seconds'],
                               gated_launches=counts_gated),
                  train=dict(bf16=train16, f32=train32, profile=prof,
                             reference_step=ref_step,
                             reference_step_gated=ref_step_gated),
                  stage1=dict(bf16=stage1_16, f32=stage1_32,
                              sampler_loop_seconds=r_s1['loop_seconds'],
                              sampler_launches=counts_s1),
                  readme=readme, seconds=time.time() - t_start)
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
