#!/usr/bin/env python3
"""Drive the PyTorch port's DSGAN sampler, DSGAN train step (per step and
chunked, --steps_per_dispatch, as a CUDA graph of the step), stage-1 label
GAN, the README DSGAN workflow and the bench entry point on one CUDA card,
on the hand-written kernels and under --no_pallas, and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card (an H100 for the
sm_90a build) and nvcc.  Any failed phase exits non-zero and prints no
result line.  TF32 is off throughout (cuDNN and matmul), so every float32
comparison is float32 against float32.

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel from supervised_gan_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time and ptxas report; count
     the HMMA (tensor-core) instructions in conv3x3's, conv3x3_dw's,
     conv4s2's, convt4s2's and conv3x3_in's SASS (cuobjdump; each needs
     bf16 and TF32 ones) and their ptxas spills (conv3x3_in's must be 0);
     conv3x3 at ragged shapes (odd sides, 1x1, channel counts off its
     chunk and tile sizes, N = 2) and at the 512^2 and 8^2 sites, f32 and
     bf16 against its plain version (tolerances as in 3), each launched
     twice with bitwise identical outputs; conv3x3_dw likewise at ragged
     shapes (Ci 1, 2, 5, 10, 17 x Co 1, 7, 64, 65, odd sides, N = 2) and at
     64 -> 64 on 512^2, within its tolerance of 6, its split of the pixel
     sum checked against ops/kernels/conv3x3_dw.py tc_plan; conv4s2 likewise
     at ragged shapes (Ci 1, 2, 3, 17 x Co 5, 70, odd sides, N = 2) and at
     128 -> 256 on 128^2, within the tolerances of 3, its split of the
     input channels checked against ops/kernels/conv4s2.py tc_plan there and
     at every train site; convt4s2 likewise at ragged shapes (Ci 1, 2, 3,
     17 x Co 1, 2, 5, 70, odd sides, N = 2) and at 256 -> 128 on 64^2 and
     128 -> 64 on 128^2, its split of the input channels checked against
     ops/kernels/convt4s2.py tc_plan there, at the sampler's sites and at
     every train site; instance_norm_act and instance_norm_bwd at ragged
     shapes (1x1 and odd planes, N = 2, C = 1), at the planes just under
     and just over each route's size threshold, at a 1024^2 plane (the
     two-pass route) and at the 512^2 site, f32 and bf16, slopes None,
     0.0 and 0.2, within the tolerances of 3 (mean and rstd within 1e-4 of
     their largest entry), two runs bitwise identical, the library's plan
     (instance_norm_plan) checked against ops/kernels/instance_norm.py
     in_plan there, at the sampler's sites and at every train site, with
     the clusters the card holds at once; the IN kernels' registers and
     spills;
  3. the forward kernels (conv3x3, convt4s2, instance_norm_act) at every
     site of the 512 px sampler (README DSGAN widths): kernel vs plain
     version in float32 (tolerance 1e-4 abs + 1e-4 rel: f32 sums in
     another order) and in bfloat16 (2e-2 abs + 2e-2 rel: one bf16 ulp of
     outputs up to ~5); the device time of the kernel, the plain version
     and one PyTorch library call of the same function (median over
     CUDA-graph replays, so without the host's launch cost; every library
     call also on the bf16 inputs), the kernel's eager call
     time, and the bound (bytes at 3.35
     TB/s or FLOPs, the larger: f32 convolutions at 495/3 TFLOP/s, as
     3xTF32 on the tensor cores, with the 67 TFLOP/s CUDA-core bound kept
     in chip_smoke.json; other f32 work at 67 TFLOP/s; bf16 at 989);
  4. the fused conv3x3 + InstanceNorm region's kernels, conv3x3_in_stats
     and instance_norm_apply, at the CRN's 64 -> 64 trunk sites, 16^2 to
     512^2 (only 512^2 passes the region's gate at its default pixel
     minimum; the smaller ones as if it were lowered): f32 and bf16, slopes
     None and 0.0, y within 1e-4 / 2e-2 as in 3, mean and rstd within 1e-4
     of their largest entry, identical output on two runs; device times of
     the kernel, its plain version, the region (both kernels), the split
     path (conv3x3 + instance_norm_act) and the library pair (F.conv2d,
     then F.instance_norm and F.relu), each in f32 and bf16, and the
     statistics' fold kernel alone (torch.profiler); conv3x3_in_stats also
     at ragged shapes (N = 2, sides off its 8 x 16 tile, Co off its 64
     channels, more than 128 tiles a plane) within the same tolerances,
     two runs bitwise identical, on constant planes (w = 0: var exactly 0,
     so mean = b and rstd = 1 / sqrt(eps) exactly), and its workspace size
     against ops/kernels/conv3x3_in.py workspace_floats;
  5. the train step's sites, recorded from one f32 step of the bench.py
     DSGAN configuration at 512 px: every call of the conv3x3_dw,
     instance_norm_bwd and conv4s2 kernels, of the four autograd Functions
     and of the two dx paths (conv3x3 on the cotangent, convt4s2 as the
     k4 s2 conv's dx) and convt4s2's calls in F2's forward, by shape, with
     its count per step;
  6. kernels A (conv3x3_dw), B (instance_norm_bwd) and C (conv4s2) at every
     recorded site, conv3x3 and convt4s2 at their dx sites, convt4s2 at
     F2's 21 forward sites and instance_norm_act at the step's 137
     forward sites (the backward's), as in 3; conv3x3_dw's tolerance is 1e-4 (f32
     and bf16 inputs; 2e-5 absolute) of the largest |dW|, since each entry
     sums every pixel.  Library calls: torch.nn.grad.conv2d_weight, aten's
     native_batch_norm_backward after the activation's backward, F.conv2d,
     F.conv_transpose2d, each also on the bf16 inputs;
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
     under --no_pallas one sample on the card (library calls, no launch)
     against the CPU plain versions within 2e-3, and 2 samples through the
     sampler with every launch count 0; then 8 samples and the card-vs-CPU
     sample with the region's gate on;
  9. training: a synthetic set of 8 1024^2 RGB PNGs (label in R and G,
     image in B), then the port's train entry point
     (supervised_gan_tpu_torch.train.main) with the bench.py DSGAN flags,
     8 steps in bfloat16 and 4 in float32: every printed loss finite, the
     numbered and latest checkpoints and full state written, each kernel's
     launch count = its launches per step (worked out from the networks'
     structure) x steps, median step time; one bf16 step profiled (device
     time by wrapper and busy share; the conv4s2 and convt4s2 device
     kernels in it: their wrappers' launches plus one reduce for each
     launch that tc_plan splits; the IN kernels' one a launch, two on the
     two-pass route);
 10. one full-width f32 step at 512 px, --pool_size 0 --no_dropout2, on
     the card through the kernels and on the CPU through the plain versions
     with the same weights, noise and batch, the CPU's D banks set to the
     card's after the D updates: each loss term within 1e-3 relative and
     every parameter's gradient within 5e-2 relative in L2, beside the
     noise floor of a CPU step with weights scaled by 1 + 1e-6 N(0, 1)
     (see phase_reference_step); then the same with the card's step under
     --no_pallas (library calls, no launch); then the train entry point
     with --profile_dir, 20 f32 steps, its trace of steps 10-20 written
     with every launch's device record (phase_profile_dir); then the bench
     entry point (supervised_gan_tpu_torch.bench.main) in turns: kernels
     bf16, --no_pallas bf16, --no_pallas f32, kernels f32, each 3 windows
     of BENCH_WINDOW_STEPS steps per step and chunked (one chunk of 10) and
     a BENCH_TRACE_STEPS-step trace (one chunk traced), its
     record printed, finite, its device fields set, its wrappers' launches
     a step those of this phase (all 0 under --no_pallas; phase_bench);
     Then the chunked dispatch (--steps_per_dispatch, a CUDA graph of the
     step, models/graph.py): one eager bf16 step of the bench configuration,
     set_input included, under torch.cuda.set_sync_debug_mode("error")
     (phase_sync_free); train_chunk of 4 batches against 4 eager steps in
     f32 and bf16, every parameter, Adam moment and pool image and the last
     losses, bitwise under deterministic algorithms; and one step under the
     default algorithms, a replay against eager steps from a state they
     share bitwise, within twice the spread of three eager runs
     (phase_chunk_equals_eager); in each bench arm
     the chunked windows and trace, the graph's kernel nodes equal to the
     eager step's traced kernels and the chunked step's traced kernels
     equal to those plus the input copies beside each replay; the train
     entry point with --steps_per_dispatch 4 over 8 steps with a print at
     step 6: chunks 4, 2, 2, finite losses, latest_*.pth and
     latest_state.pt written (phase_chunked_driver);
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
 14. phase 10 again with the region's gate on, then in bf16 on both sides
     with the gate on (see phase_reference_step for its tolerances);
 15. a JSON line of per-kernel results, the card line, and the last line
     {"ok": true, "device": {...}}.

Every torch.profiler trace opens with spin kernels that take the records
the profiler loses at its start (see traced), and must hold a device
record for each kernel launch of the run it traces.  Per-site numbers go
to chiprun_out/chip_smoke.json; profiler traces to
chiprun_out/{sampler,train}_trace.json.  Checkpoints go to
checkpoints/chip_smoke*, images and the synthetic set to
results/chip_smoke.
"""

import collections
import contextlib
import ctypes
import gc
import importlib
import io
import json
import re
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

from supervised_gan_tpu_torch import bench  # noqa: E402
from supervised_gan_tpu_torch import nn as tnn  # noqa: E402
from supervised_gan_tpu_torch import test as sampler  # noqa: E402
from supervised_gan_tpu_torch import train as trainer  # noqa: E402
from supervised_gan_tpu_torch.models import create_model  # noqa: E402
from supervised_gan_tpu_torch.models.base import CAPTURE_AFTER  # noqa: E402
from supervised_gan_tpu_torch.nn import core as nn_core  # noqa: E402
from supervised_gan_tpu_torch.ops import bilinear_upsample  # noqa: E402
from supervised_gan_tpu_torch.ops import conv as ops_conv  # noqa: E402
from supervised_gan_tpu_torch.ops import kernels as K  # noqa: E402
from supervised_gan_tpu_torch.ops import norm as ops_norm  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import build  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import common  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import functions  # noqa: E402
from supervised_gan_tpu_torch.options import TrainOptions  # noqa: E402
from supervised_gan_tpu_torch.utils import pth  # noqa: E402
from supervised_gan_tpu_torch.utils.profile import (  # noqa: E402
    PRIMER_SPINS, device_rows, traced)

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
# dense bf16 and TF32 on the tensor cores, HBM3 bandwidth).  An f32
# convolution can run on the tensor cores as 3xTF32 (three TF32 products a
# multiply-add, f32 accuracy), so the conv kernels' f32 bound counts their
# FLOPs at a third of the TF32 rate; the CUDA-core bound is kept beside it.
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
CONV_KERNELS = ('conv3x3', 'conv3x3_dx', 'convt4s2', 'convt4s2_dx',
                'convt4s2_f2', 'conv3x3_dw', 'conv4s2', 'conv3x3_in_stats')

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
        n = c * s * s
        cases.append(Case('instance_norm_act',
                          '%d @%d^2 slope %s' % (c, s, slope), 1,
                          lambda x, slope=slope: K.instance_norm_act(
                              x, 1e-5, slope),
                          lambda x, slope=slope: K.instance_norm_act_plain(
                              x, 1e-5, slope),
                          _in_library(slope), 6.0 * n, 8.0 * n, 4.0 * n, mk,
                          within))
    return cases


def _in_library(slope):
    """F.instance_norm, then the activation: the library yardstick of
    instance_norm_act."""
    def lib(x):
        y = F.instance_norm(x, eps=1e-5)
        if slope is None:
            return y
        return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)
    return lib


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
        # the bf16 yardstick: the same library call on the bf16 inputs
        # (cuDNN on the tensor cores; aten's instance norm and its backward)
        t_l16 = device_ms(lambda: c.lib(*args16))
        t_call = call_ms(lambda: c.kern(*args))
        peak = PEAK_TF32X3_FLOPS if c.kernel in CONV_KERNELS \
            else PEAK_F32_FLOPS
        b_ms, b_by = bound_ms(c.flops, c.nbytes, peak)
        b_cc, _ = bound_ms(c.flops, c.nbytes)
        b16_ms, b16_by = bound_ms(c.flops, c.nbytes16, PEAK_BF16_FLOPS)
        per_site.append(dict(
            kernel=c.kernel, site=c.label, count=c.count, max_abs_err=e32,
            max_abs_err_bf16=e16, ms=t_k, ms_bf16=t_k16, plain_ms=t_p,
            library_ms=t_l, library_ms_bf16=t_l16, call_ms=t_call,
            bound_ms=b_ms, bound_by=b_by, bound_ms_cuda_core=b_cc,
            bound_ms_bf16=b16_ms, bound_by_bf16=b16_by, flops=c.flops,
            bytes=c.nbytes))
        print('  %-17s %-26s x%-3d err f32 %.2e bf16 %.2e | kernel %.4f ms '
              '(bf16 %.4f, eager call %.4f) plain %.4f library %.4f (bf16 '
              '%.4f) bound %.4f (%s; bf16 %.4f)' % (
                  c.kernel, c.label, c.count, e32, e16, t_k, t_k16, t_call,
                  t_p, t_l, t_l16, b_ms, b_by, b16_ms))
        a = agg.setdefault(c.kernel, dict(
            max_abs_err=0.0, ms=0.0, ms_bf16=0.0, plain_ms=0.0,
            library_ms=0.0, library_ms_bf16=0.0, bound_ms=0.0,
            bound_ms_cuda_core=0.0, bound_ms_bf16=0.0, flops=0.0, bytes=0.0,
            bytes16=0.0, sites=0, peak_flops=peak))
        a['max_abs_err'] = max(a['max_abs_err'], e32)
        for k, v in (('ms', t_k), ('ms_bf16', t_k16), ('plain_ms', t_p),
                     ('library_ms', t_l), ('library_ms_bf16', t_l16),
                     ('bound_ms', b_ms), ('bound_ms_cuda_core', b_cc),
                     ('bound_ms_bf16', b16_ms), ('flops', c.flops),
                     ('bytes', c.nbytes), ('bytes16', c.nbytes16)):
            a[k] += v * c.count
        a['sites'] += c.count
    for name, a in agg.items():
        _, a['bound_by'] = bound_ms(a['flops'], a['bytes'], a['peak_flops'])
        print('  %-17s over %d launches: kernel f32 %.4f ms, bf16 %.4f; '
              'library f32 %.4f, bf16 %.4f; bound f32 %.4f (%s), bf16 %.4f; '
              'f32 CUDA-core bound %.4f' % (
                  name, a['sites'], a['ms'], a['ms_bf16'], a['library_ms'],
                  a['library_ms_bf16'],
                  a['bound_ms'], a['bound_by'], a['bound_ms_bf16'],
                  a['bound_ms_cuda_core']))
    return per_site, agg


# ---------------------------------------------- the fused region, row 6 -- #

# the CRN's 64 -> 64 trunk convs followed by IN, 16^2 to 512^2
REGION_SIDES = (16, 32, 64, 128, 256, 512)


def _region_lib(x, w, b):
    """The library pair: cuDNN's conv, then aten's instance_norm and relu."""
    return F.relu(F.instance_norm(F.conv2d(x, w, b, 1, 1), eps=1e-5))


def _fold_ms(args, reps=20):
    """Device ms a call of conv3x3_in_stats's two kernels, the main kernel
    and the fold, from a torch.profiler trace of `reps` calls."""
    K.conv3x3_in_stats(*args)
    torch.cuda.synchronize()
    prof = traced(lambda: K.conv3x3_in_stats(*args), reps)[0]
    out = dict(main=0.0, fold=0.0)
    seen = dict(main=0, fold=0)
    for key, ms, count in device_rows(prof, reps):
        for part, sym in (('main', 'conv3x3_in_tc_kernel'),
                          ('fold', 'conv3x3_in_fold_kernel')):
            if sym in key:
                out[part] += ms
                seen[part] += count
    check(out['main'] > 0 and out['fold'] > 0 and seen == dict(main=1, fold=1),
          'conv3x3_in_stats: the profiler saw %s of its kernels a call, '
          'device ms %s' % (seen, out))
    return out


def phase_region():
    """conv3x3_in_stats and instance_norm_apply at the trunk sites against
    their plain versions (f32, bf16; slopes None and 0.0), run-to-run
    identity, and device times in both dtypes.  Returns (per-site records,
    per-kernel sums over the sites of one G2 forward at the default pixel
    minimum)."""
    gen = torch.Generator(device=DEV).manual_seed(4321)
    per_site = []
    agg = {name: dict(max_abs_err=0.0, ms=0.0, ms_bf16=0.0, plain_ms=0.0,
                      library_ms=None, library_ms_bf16=None, bound_ms=0.0,
                      bound_ms_bf16=0.0, flops=0.0, bytes=0.0, sites=0,
                      peak_flops=peak)
           for name, peak in (('conv3x3_in_stats', PEAK_TF32X3_FLOPS),
                              ('instance_norm_apply', PEAK_F32_FLOPS))}
    for side in REGION_SIDES:
        site = '64->64 @%d^2' % side
        count = int(side * side >= ops_conv.CONV3_MIN_PIXELS)
        x = randn((1, 64, side, side), gen)
        w = randn((64, 64, 3, 3), gen, (9 * 64) ** -0.5)
        b = randn((64,), gen, 0.1)
        errs = {}
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            errs[tag], (y, m, r), (yp, mp, rp) = check_region_stats(
                site, tag, (x.to(dt), w.to(dt), b.to(dt)), tol)
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
            errs[tag].update(apply=e_apply, region=e_region)
        t = {}
        for tag, (xa, wa, ba) in (('', (x, w, b)),
                                  ('_bf16', _bf16((x, w, b)))):
            y, m, r = K.conv3x3_in_stats(xa, wa, ba)
            t.update({
                'kernel' + tag: device_ms(
                    lambda: K.conv3x3_in_stats(xa, wa, ba)),
                'conv3x3' + tag: device_ms(lambda: K.conv3x3(xa, wa, ba)),
                'apply' + tag: device_ms(
                    lambda: K.instance_norm_apply(y, m, r, 0.0)),
                'region' + tag: device_ms(lambda: K.instance_norm_apply(
                    *K.conv3x3_in_stats(xa, wa, ba), 0.0)),
                'split' + tag: device_ms(lambda: K.instance_norm_act(
                    K.conv3x3(xa, wa, ba), 1e-5, 0.0)),
                'library_pair' + tag: device_ms(
                    lambda: _region_lib(xa, wa, ba))})
            parts = _fold_ms((xa, wa, ba))
            t['profiled_main' + tag] = parts['main']
            t['fold' + tag] = parts['fold']
        y, m, r = K.conv3x3_in_stats(x, w, b)
        t['plain'] = device_ms(lambda: K.conv3x3_in_stats_plain(x, w, b))
        t['apply_plain'] = device_ms(
            lambda: K.instance_norm_apply_plain(y, m, r, 0.0))
        n_out = 64.0 * side * side
        flops = 2.0 * 9 * 64 * n_out + 3.0 * n_out
        nbytes = 4.0 * (2 * n_out + 64 * 64 * 9 + 64 + 2 * 64)
        nbytes16 = 2.0 * (2 * n_out + 64 * 64 * 9) + 4.0 * (64 + 2 * 64)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_TF32X3_FLOPS)
        b16_ms, _ = bound_ms(flops, nbytes16, PEAK_BF16_FLOPS)
        a_flops, a_bytes = 3.0 * n_out, 8.0 * n_out + 8.0 * 64
        a_ms, a_by = bound_ms(a_flops, a_bytes)
        a16_ms, _ = bound_ms(a_flops, 4.0 * n_out + 8.0 * 64, PEAK_BF16_FLOPS)
        per_site.append(dict(kernel='conv3x3_in_stats', site=site,
                             count=count, errors=errs, ms=t,
                             bound_ms=b_ms, bound_by=b_by,
                             bound_ms_bf16=b16_ms,
                             apply_bound_ms=a_ms, apply_bound_by=a_by))
        print('  region %-14s x%d err f32 %s bf16 %s' % (
            site, count, errs['f32'], errs['bf16']))
        for tag, label in (('', 'f32'), ('_bf16', 'bf16')):
            print('    %-4s stats kernel %.4f ms (main %.4f + fold %.4f, '
                  'profiled) conv3x3 %.4f bound %.4f; apply %.4f; region '
                  '%.4f split %.4f (region / split %.3f) library pair %.4f'
                  % (label, t['kernel' + tag], t['profiled_main' + tag],
                     t['fold' + tag], t['conv3x3' + tag],
                     b_ms if not tag else b16_ms, t['apply' + tag],
                     t['region' + tag], t['split' + tag],
                     t['region' + tag] / t['split' + tag],
                     t['library_pair' + tag]))
        print('    plain stats %.4f ms, plain apply %.4f; bound %s, apply '
              'bound %.4f (%s)' % (t['plain'], t['apply_plain'], b_by, a_ms,
                                   a_by))
        for name, vals in (
                ('conv3x3_in_stats', dict(
                    max_abs_err=errs['f32']['y'], ms=t['kernel'],
                    ms_bf16=t['kernel_bf16'], plain_ms=t['plain'],
                    bound_ms=b_ms, bound_ms_bf16=b16_ms, flops=flops,
                    bytes=nbytes)),
                ('instance_norm_apply', dict(
                    max_abs_err=errs['f32']['apply'], ms=t['apply'],
                    ms_bf16=t['apply_bf16'], plain_ms=t['apply_plain'],
                    bound_ms=a_ms, bound_ms_bf16=a16_ms, flops=a_flops,
                    bytes=a_bytes))):
            a = agg[name]
            a['max_abs_err'] = max(a['max_abs_err'], vals.pop('max_abs_err'))
            for k, v in vals.items():
                a[k] += v * count
            a['sites'] += count
    for a in agg.values():
        _, a['bound_by'] = bound_ms(a['flops'], a['bytes'], a['peak_flops'])
    return per_site, agg


def check_region_stats(site, tag, args, tol):
    """conv3x3_in_stats on args against its plain version: y within tol (as
    `within`), mean and rstd within 1e-4 of their largest entry, two
    launches bitwise identical.  Returns (errors, kernel outputs, plain
    outputs)."""
    y, m, r = K.conv3x3_in_stats(*args)
    again = K.conv3x3_in_stats(*args)
    yp, mp, rp = K.conv3x3_in_stats_plain(*args)
    torch.cuda.synchronize()
    check(y.shape == yp.shape and y.dtype == args[0].dtype
          and bool(torch.isfinite(y).all()) and m.shape == mp.shape
          and r.shape == rp.shape,
          'conv3x3_in_stats %s %s: bad output' % (site, tag))
    check(all(torch.equal(a, c) for a, c in zip((y, m, r), again)),
          'conv3x3_in_stats %s %s: two runs differ' % (site, tag))
    check(within(y, yp, tol), 'conv3x3_in_stats %s %s: y off by %.3g'
          % (site, tag, err(y, yp)))
    for name, a, c in (('mean', m, mp), ('rstd', r, rp)):
        check(within_sum(a, c, 1e-4, atol=1e-7),
              'conv3x3_in_stats %s %s: %s off by %.3g of its largest '
              'entry' % (site, tag, name, err(a, c) / float(c.abs().max())))
    return (dict(y=err(y, yp), mean=err(m, mp), rstd=err(r, rp)),
            (y, m, r), (yp, mp, rp))


# conv3x3_in_stats at (N, Ci, Co, H, W): sides off its 8 x 16 pixel tile,
# one pixel, Co off its 64-channel tile and over two of them, Ci off the
# 8 / 16-channel chunk, and planes of more than the fold's 128 tile strides
RAGGED_REGION = [(2, 3, 5, 7, 13), (2, 17, 33, 1, 1), (2, 64, 72, 9, 40),
                 (2, 130, 70, 21, 19), (2, 16, 24, 130, 200),
                 (1, 8, 130, 33, 47)]
CIN_MODULE = importlib.import_module(
    'supervised_gan_tpu_torch.ops.kernels.conv3x3_in')


def phase_region_shapes():
    """conv3x3_in_stats at RAGGED_REGION, f32 and bf16 (check_region_stats);
    on constant planes (w = 0, so y = b: one-pixel planes with any bias,
    and 21 x 19 planes with biases of a few bits, whose sums are exact),
    where the fold must give var exactly 0: mean = b and rstd = 1 /
    sqrt(eps) bit for bit; and the library's workspace size against
    workspace_floats at every shape and trunk site.  Returns the worst
    errors."""
    gen = torch.Generator(device=DEV).manual_seed(77)
    lib = build.load('conv3x3_in', CIN_MODULE._SIGNATURES)
    for n, ci, co, h, w in (RAGGED_REGION
                            + [(1, 64, 64, s, s) for s in REGION_SIDES]):
        check(lib.conv3x3_in_workspace(n, co, h, w)
              == CIN_MODULE.workspace_floats(n, co, h, w),
              'conv3x3_in_workspace %s: %d, workspace_floats %d'
              % ((n, ci, co, h, w), lib.conv3x3_in_workspace(n, co, h, w),
                 CIN_MODULE.workspace_floats(n, co, h, w)))
    print('  workspace: conv3x3_in_workspace = workspace_floats at %d shapes'
          % (len(RAGGED_REGION) + len(REGION_SIDES)))
    worst = {'f32': 0.0, 'bf16': 0.0}
    for n, ci, co, h, w in RAGGED_REGION:
        x = randn((n, ci, h, w), gen)
        wt = randn((co, ci, 3, 3), gen, (9 * ci) ** -0.5)
        b = randn((co,), gen, 0.1)
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            site = '%d x %d->%d @%dx%d' % (n, ci, co, h, w)
            e, _, _ = check_region_stats(site, tag, (x.to(dt), wt.to(dt), b),
                                         tol)
            worst[tag] = max(worst[tag], e['y'])
            print('  conv3x3_in_stats %-22s %-4s err y %.2e mean %.2e rstd '
                  '%.2e, two runs identical' % (site, tag, e['y'], e['mean'],
                                                e['rstd']))
    rstd_eps = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(1e-5)))
    for n, ci, co, h, w, b in (
            (2, 17, 5, 1, 1, randn((5,), gen)),
            (2, 8, 6, 21, 19, torch.tensor([0.75, -1.5, 3.125, 0.0, -0.25,
                                            12.5], device=DEV))):
        for dt in (torch.float32, torch.bfloat16):
            x = randn((n, ci, h, w), gen).to(dt)
            y, m, r = K.conv3x3_in_stats(x, torch.zeros(co, ci, 3, 3,
                                                        device=DEV,
                                                        dtype=dt), b)
            torch.cuda.synchronize()
            site = 'constant %d x %d->%d @%dx%d %s' % (n, ci, co, h, w, dt)
            check(torch.equal(m, b.expand(n, co)), '%s: mean is not b' % site)
            check(bool((r == rstd_eps).all()), '%s: rstd %s, not 1 / sqrt(eps)'
                  ' = %r' % (site, r.tolist(), rstd_eps))
            print('  conv3x3_in_stats %s: mean = b, rstd = 1 / sqrt(eps) '
                  'exactly' % site)
    return worst


# ------------------------------------ conv3x3's tensor-core route, row 1 -- #

# (N, Ci, Co, H, W): odd sides, one pixel, channel counts off the chunk
# (16 bf16 / 8 f32 channels) and the 64-channel N tile, several N tiles;
# the last two take the kernel's 16-byte copies (W a multiple of 8, Ci of
# 8) with sides off its 8 x 16 pixel tile
RAGGED_CONV3 = ([(2, ci, co, h, w) for ci, co in ((3, 5), (17, 33), (1, 64),
                                                   (64, 1))
                 for h, w in ((7, 13), (1, 1))]
                + [(2, 130, 70, 21, 19), (2, 24, 40, 10, 24),
                   (2, 64, 72, 9, 40)])
# two runs of one launch must agree bitwise: the 512^2 trunk site and the
# smallest sampler site
IDENTITY_CONV3 = [(1, 64, 64, 512, 512), (1, 10, 64, 8, 8)]


def phase_conv3x3_shapes():
    """conv3x3 at ragged shapes and at IDENTITY_CONV3, f32 (1e-4) and bf16
    (2e-2) against conv3x3_plain, each launched twice: the two outputs must
    be identical.  Returns the worst errors."""
    gen = torch.Generator(device=DEV).manual_seed(99)
    worst = {'f32': 0.0, 'bf16': 0.0}
    for n, ci, co, h, w in RAGGED_CONV3 + IDENTITY_CONV3:
        x = randn((n, ci, h, w), gen)
        wt = randn((co, ci, 3, 3), gen, (9 * ci) ** -0.5)
        b = randn((co,), gen, 0.1)
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            args = (x.to(dt), wt.to(dt), b)
            y, again = K.conv3x3(*args), K.conv3x3(*args)
            ref = K.conv3x3_plain(*args)
            torch.cuda.synchronize()
            site = '%d x %d->%d @%dx%d %s' % (n, ci, co, h, w, tag)
            check(y.shape == ref.shape and y.dtype == dt
                  and bool(torch.isfinite(y).all()),
                  'conv3x3 %s: bad output' % site)
            check(within(y, ref, tol), 'conv3x3 %s: max abs err %.3g'
                  % (site, err(y, ref)))
            check(torch.equal(y, again), 'conv3x3 %s: two runs differ' % site)
            worst[tag] = max(worst[tag], err(y, ref))
            print('  conv3x3 %-26s err %.2e, two runs identical'
                  % (site, err(y, ref)))
    return worst


# conv3x3_dw's tensor-core route (rows 2-3): (N, Ci, Co, H, W) with input
# channels off its 8-channel fragments and its 32 / 64-channel blocks,
# output channels off its m16 fragments and its 64-channel block, and odd
# sides (the kernel's single-value staging); two runs of one launch must
# agree bitwise, there and at the 512^2 trunk site
RAGGED_DW = [(2, ci, co, h, w) for ci in (1, 2, 5, 10, 17)
             for co in (1, 7, 64, 65) for h, w in ((7, 13), (9, 5))]
IDENTITY_DW = [(1, 64, 64, 512, 512)]
DW_MODULE = importlib.import_module(
    'supervised_gan_tpu_torch.ops.kernels.conv3x3_dw')


def check_dw_plan(n, ci, co, h, w):
    """The kernel's split of the pixel sum (conv3x3_dw_splits) is the one
    ops/kernels/conv3x3_dw.py tc_plan describes, which the CPU rehearsal in
    tests/test_torch_conv3x3_dw_tc.py emulates, in both dtypes."""
    lib = build.load('conv3x3_dw', DW_MODULE._SIGNATURES)
    for dt, code in common.DTYPE_CODES.items():
        ours = lib.conv3x3_dw_splits(n, ci, co, h, w, code)
        plan = len(DW_MODULE.tc_plan(n, ci, co, h, w, dt)[1])
        check(ours == plan, 'conv3x3_dw %s %s: the kernel splits the pixels '
              '%d ways, tc_plan %d' % ((n, ci, co, h, w), dt, ours, plan))


def phase_conv3x3_dw_shapes():
    """conv3x3_dw at RAGGED_DW and IDENTITY_DW, f32 and bf16 inputs, against
    conv3x3_dw_plain within 1e-4 of the largest |dW| (within_sum), each
    launched twice: the two outputs must be identical.  Returns the worst
    errors relative to the largest |dW|."""
    gen = torch.Generator(device=DEV).manual_seed(98)
    worst = {'f32': 0.0, 'bf16': 0.0}
    for n, ci, co, h, w in RAGGED_DW + IDENTITY_DW:
        check_dw_plan(n, ci, co, h, w)
        x = randn((n, ci, h, w), gen)
        g = randn((n, co, h, w), gen)
        site_err = 0.0
        for tag, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
            xa, ga = x.to(dt), g.to(dt)
            dw, again = K.conv3x3_dw(xa, ga), K.conv3x3_dw(xa, ga)
            ref = K.conv3x3_dw_plain(xa, ga)
            torch.cuda.synchronize()
            site = '%d x %d->%d @%dx%d %s' % (n, ci, co, h, w, tag)
            check(dw.shape == (co, ci, 3, 3) and dw.dtype == torch.float32
                  and bool(torch.isfinite(dw).all()),
                  'conv3x3_dw %s: bad output' % site)
            rel = err(dw, ref) / float(ref.abs().max())
            check(within_sum(dw, ref, 1e-4), 'conv3x3_dw %s: off by %.3g of '
                  'the largest |dW|' % (site, rel))
            check(torch.equal(dw, again), 'conv3x3_dw %s: two runs differ'
                  % site)
            worst[tag] = max(worst[tag], rel)
            site_err = max(site_err, rel)
        print('  conv3x3_dw %-24s err %.2e of the largest |dW|, two runs '
              'identical' % ('%d x %d->%d @%dx%d' % (n, ci, co, h, w),
                             site_err))
    return worst


# conv4s2's tensor-core route (row 5): (N, Ci, Co, H, W) with the stems'
# 1-3 input channels and 17 (off its 8-channel chunk), output channels off
# its n8 fragments and its 64-channel block, odd sides (value-by-value
# staging) and N = 2; two runs of one launch must agree bitwise, there and
# at the widest train site, 128 -> 256 on 128^2
RAGGED_C4 = [(2, ci, co, h, w) for ci in (1, 2, 3, 17) for co in (5, 70)
             for h, w in ((7, 13), (9, 5))]
IDENTITY_C4 = [(1, 128, 256, 128, 128)]
C4_MODULE = importlib.import_module(
    'supervised_gan_tpu_torch.ops.kernels.conv4s2')


def check_conv4s2_plan(n, ci, co, h, w):
    """The kernel's split of the input-channel chunks (conv4s2_splits) is
    the one ops/kernels/conv4s2.py tc_plan describes, which the CPU
    rehearsal in tests/test_torch_conv4s2_tc.py emulates."""
    lib = build.load('conv4s2', C4_MODULE._SIGNATURES)
    ours = lib.conv4s2_splits(n, ci, co, h, w)
    plan = len(C4_MODULE.tc_plan(n, ci, co, h, w))
    check(ours == plan, 'conv4s2 %s: the kernel splits the input channels '
          '%d ways, tc_plan %d' % ((n, ci, co, h, w), ours, plan))


def phase_conv4s2_shapes():
    """conv4s2 at RAGGED_C4 and IDENTITY_C4, f32 (1e-4) and bf16 (2e-2)
    against conv4s2_plain, each launched twice: the two outputs must be
    identical.  Returns the worst errors."""
    gen = torch.Generator(device=DEV).manual_seed(97)
    worst = {'f32': 0.0, 'bf16': 0.0}
    for n, ci, co, h, w in RAGGED_C4 + IDENTITY_C4:
        check_conv4s2_plan(n, ci, co, h, w)
        x = randn((n, ci, h, w), gen)
        wt = randn((co, ci, 4, 4), gen, (16 * ci) ** -0.5)
        b = randn((co,), gen, 0.1)
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            args = (x.to(dt), wt.to(dt), b)
            y, again = K.conv4s2(*args), K.conv4s2(*args)
            ref = K.conv4s2_plain(*args)
            torch.cuda.synchronize()
            site = '%d x %d->%d @%dx%d %s' % (n, ci, co, h, w, tag)
            check(y.shape == ref.shape and y.dtype == dt
                  and bool(torch.isfinite(y).all()),
                  'conv4s2 %s: bad output' % site)
            check(within(y, ref, tol), 'conv4s2 %s: max abs err %.3g'
                  % (site, err(y, ref)))
            check(torch.equal(y, again), 'conv4s2 %s: two runs differ' % site)
            worst[tag] = max(worst[tag], err(y, ref))
            print('  conv4s2 %-26s err %.2e, two runs identical'
                  % (site, err(y, ref)))
    return worst


# convt4s2's tensor-core route (row 4): (N, Ci, Co, H, W) with 1-3 and 17
# input channels (off its 8- and 16-channel chunks; 1-3 output channels are
# the D stems' dx), output channels off its n8 fragments and its 32-channel
# block, odd sides (value-by-value staging) and N = 2; two runs of one launch
# must agree bitwise, there and at the two widest dx sites
RAGGED_CT = [(2, ci, co, h, w) for ci in (1, 2, 3, 17) for co in (1, 2, 5, 70)
             for h, w in ((7, 13), (9, 5))]
IDENTITY_CT = [(1, 256, 128, 64, 64), (1, 128, 64, 128, 128)]
CT_MODULE = importlib.import_module(
    'supervised_gan_tpu_torch.ops.kernels.convt4s2')


def check_convt4s2_plan(n, ci, co, h, w):
    """The kernel's split of the input channels (convt4s2_splits) is the one
    ops/kernels/convt4s2.py tc_plan describes, which the CPU rehearsal in
    tests/test_torch_convt4s2_tc.py emulates, and its route (tensor cores or
    its CUDA-core loop) the one tensor_cores describes."""
    lib = build.load('convt4s2', CT_MODULE._SIGNATURES)
    ours = lib.convt4s2_splits(n, ci, co, h, w)
    plan = len(CT_MODULE.tc_plan(n, ci, co, h, w))
    check(ours == plan, 'convt4s2 %s: the kernel splits the input channels '
          '%d ways, tc_plan %d' % ((n, ci, co, h, w), ours, plan))
    tc = bool(lib.convt4s2_tensor_cores(n, ci, co, h, w))
    check(tc == CT_MODULE.tensor_cores(ci, h, w), 'convt4s2 %s: the kernel '
          'takes the tensor cores: %s, tensor_cores says %s'
          % ((n, ci, co, h, w), tc, not tc))


def phase_convt4s2_shapes():
    """convt4s2 at RAGGED_CT and IDENTITY_CT, f32 (1e-4) and bf16 (2e-2)
    against convt4s2_plain, each launched twice: the two outputs must be
    identical.  Returns the worst errors."""
    gen = torch.Generator(device=DEV).manual_seed(98)
    worst = {'f32': 0.0, 'bf16': 0.0}
    for n, ci, co, h, w in RAGGED_CT + IDENTITY_CT:
        check_convt4s2_plan(n, ci, co, h, w)
        x = randn((n, ci, h, w), gen)
        wt = randn((ci, co, 4, 4), gen, (4 * ci) ** -0.5)
        b = randn((co,), gen, 0.1)
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            args = (x.to(dt), wt.to(dt), b)
            y, again = K.convt4s2(*args), K.convt4s2(*args)
            ref = K.convt4s2_plain(*args)
            torch.cuda.synchronize()
            site = '%d x %d->%d @%dx%d %s' % (n, ci, co, h, w, tag)
            check(y.shape == ref.shape and y.dtype == dt
                  and bool(torch.isfinite(y).all()),
                  'convt4s2 %s: bad output' % site)
            check(within(y, ref, tol), 'convt4s2 %s: max abs err %.3g'
                  % (site, err(y, ref)))
            check(torch.equal(y, again), 'convt4s2 %s: two runs differ'
                  % site)
            worst[tag] = max(worst[tag], err(y, ref))
            print('  convt4s2 %-25s err %.2e, two runs identical'
                  % (site, err(y, ref)))
    return worst


# the IN kernels' routes (rows 7 and 10), (N, C, H, W): 1x1 and odd planes
# (with H*W odd, plane p starts off a 16-byte boundary), N = 2 and C = 1;
# the planes just under and just over each route's threshold
# (in_thresholds); a 1024^2 plane (the two-pass route in f32); two runs of
# one launch must agree bitwise, there and at the two 512^2 sites
RAGGED_IN = [(2, 1, 1, 1), (2, 3, 1, 1), (2, 1, 3, 5), (2, 3, 15, 15),
             (2, 5, 31, 31), (2, 3, 63, 63), (2, 1, 255, 255),
             (1, 64, 15, 15)]
LARGE_IN = [(1, 2, 1024, 1024)]
IDENTITY_IN = [(1, 64, 512, 512)]
IN_MODULE = importlib.import_module(
    'supervised_gan_tpu_torch.ops.kernels.instance_norm')
IN_DIRECTIONS = ('forward', 'backward')


def in_thresholds(nc=6):
    """(1, nc, 1, HW) planes just under and just over the size at which
    in_plan moves from one block to a cluster and from a cluster to the
    two-pass kernels, for each dtype and direction."""
    shapes = set()
    for dt in common.DTYPE_CODES:
        for d in IN_DIRECTIONS:
            def route(hw, dt=dt, d=d):
                return IN_MODULE.ROUTES.index(
                    IN_MODULE.in_plan(1, nc, 1, hw, dt, d).route)
            for target in (1, 2):
                lo, hi = 1, 1 << 26
                while lo < hi:
                    mid = (lo + hi) // 2
                    if route(mid) >= target:
                        hi = mid
                    else:
                        lo = mid + 1
                shapes |= {(1, nc, 1, lo - 1), (1, nc, 1, lo)}
    return sorted(shapes, key=lambda t: t[3])


def check_in_plan(n, c, h, w):
    """The library's plan (instance_norm_plan) for N*C planes of H*W is the
    one ops/kernels/instance_norm.py in_plan describes, which the CPU
    rehearsal in tests/test_torch_instance_norm_cluster.py follows, in both
    dtypes and directions; a plan's cluster fits on the card
    (instance_norm_max_active_clusters > 0).  Returns {(dtype, direction):
    (plan, clusters the card holds at once)}."""
    lib = build.load('instance_norm', IN_MODULE._SIGNATURES)
    plans = {}
    for dt, code in common.DTYPE_CODES.items():
        for d in IN_DIRECTIONS:
            out = (ctypes.c_int * 5)()
            lib.instance_norm_plan(n * c, h * w, code, int(d == 'backward'),
                                   out)
            plan = IN_MODULE.in_plan(n, c, h, w, dt, d)
            want = (IN_MODULE.ROUTES.index(plan.route),) + tuple(plan[1:])
            check(tuple(out) == want, 'instance_norm %s %s %s: the library '
                  'plans %s, in_plan %s' % ((n, c, h, w), dt, d, tuple(out),
                                            tuple(plan)))
            active = lib.instance_norm_max_active_clusters(
                n * c, h * w, code, int(d == 'backward'))
            check(active > 0 or plan.route == 'two_pass',
                  'instance_norm %s %s %s: %s plan %s fits %d at once'
                  % ((n, c, h, w), dt, d, plan.route, tuple(plan), active))
            plans[(dt, d)] = (plan, active)
    return plans


def _plan_text(plans):
    return ', '.join(
        '%s %s %s x%d %dB %dt' % (
            'f32' if dt == torch.float32 else 'bf16', d[:3], p.route,
            p.cluster, p.smem, p.threads)
        for (dt, d), (p, _) in plans.items())


def phase_instance_norm_shapes():
    """instance_norm_act and instance_norm_bwd at RAGGED_IN, in_thresholds(),
    LARGE_IN and IDENTITY_IN, f32 (1e-4) and bf16 (2e-2) inputs, slopes None,
    0.0 and 0.2, against their plain versions (the backward at the plain
    forward's statistics); the forward's mean and rstd within 1e-4 of their
    largest entry; each launched twice: the two outputs identical.  Returns
    the worst errors and the plans."""
    gen = torch.Generator(device=DEV).manual_seed(96)
    worst = {'f32': 0.0, 'bf16': 0.0}
    plans = {}
    for n, c, h, w in RAGGED_IN + in_thresholds() + LARGE_IN + IDENTITY_IN:
        shape = (n, c, h, w)
        plans[shape] = check_in_plan(n, c, h, w)
        x32 = randn(shape, gen, 2.0) + 0.5
        g32 = randn(shape, gen)
        errs = {}
        for tag, dt, tol in (('f32', torch.float32, 1e-4),
                             ('bf16', torch.bfloat16, 2e-2)):
            x, g = x32.to(dt), g32.to(dt)
            for slope in (None, 0.0, 0.2):
                site = '%s %s slope %s' % (shape, tag, slope)
                y, m, r = K.instance_norm_act(x, 1e-5, slope,
                                              return_stats=True)
                again = K.instance_norm_act(x, 1e-5, slope,
                                            return_stats=True)
                yp, mp, rp = K.instance_norm_act_plain(x, 1e-5, slope,
                                                       return_stats=True)
                mp, rp = mp.contiguous(), rp.contiguous()
                dx = K.instance_norm_bwd(x, g, mp, rp, slope)
                dx2 = K.instance_norm_bwd(x, g, mp, rp, slope)
                dxp = K.instance_norm_bwd_plain(x, g, mp, rp, slope)
                torch.cuda.synchronize()
                for name, a, b in (('y', y, yp), ('dx', dx, dxp)):
                    check(a.shape == b.shape and a.dtype == dt
                          and bool(torch.isfinite(a).all()),
                          'instance_norm %s: bad %s' % (site, name))
                    check(within(a, b, tol), 'instance_norm %s: %s max abs '
                          'err %.3g' % (site, name, err(a, b)))
                for name, a, b in (('mean', m, mp), ('rstd', r, rp)):
                    check(err(a, b) <= 1e-4 * float(b.abs().max()),
                          'instance_norm %s: %s off by %.3g of its largest '
                          'entry' % (site, name,
                                     err(a, b) / float(b.abs().max())))
                check(all(torch.equal(a, b) for a, b in zip((y, m, r),
                                                            again)),
                      'instance_norm_act %s: two runs differ' % site)
                check(torch.equal(dx, dx2),
                      'instance_norm_bwd %s: two runs differ' % site)
                errs[tag] = max(errs.get(tag, 0.0), err(y, yp), err(dx, dxp))
            worst[tag] = max(worst[tag], errs[tag])
        print('  IN %-22s err f32 %.2e bf16 %.2e, two runs identical; %s'
              % (shape, errs['f32'], errs['bf16'], _plan_text(plans[shape])))
    return worst, {repr(k): {'%s %s' % (dt, d): dict(plan._asdict(),
                                                    active=a)
                             for (dt, d), (plan, a) in v.items()}
                   for k, v in plans.items()}


def ptxas_in_kernels():
    """{'in_fwd_plane_kernel<float, 512>': [registers, spill bytes], ...}
    for the IN library's one-launch kernels, from its ptxas report."""
    log = build.library_path('instance_norm').with_suffix('.log').read_text()
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            t = re.search(r'(in_(?:fwd|bwd)_plane_kernel)I(f|13__nv_bfloat16)'
                          r'Li(\d+)E', m.group(1))
            cur = None if t is None else '%s<%s, %s>' % (
                t.group(1), 'float' if t.group(2) == 'f' else 'bf16',
                t.group(3))
            if cur is not None:
                out[cur] = [0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            out[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out[cur][0] = int(m.group(1))
    return out


def split_launches(module, sites):
    """Reduce launches of module's kernel at {(N, Ci, Co, H, W): count}: one
    for each launch that its tc_plan splits."""
    return sum(c for (n, ci, co, h, w), c in sites.items()
               if len(module.tc_plan(n, ci, co, h, w)) > 1)


def ptxas_spills(name):
    """Bytes of spill stores and loads ptxas reports for csrc/<name>.cu
    (from the build log kept beside the library)."""
    log = build.library_path(name).with_suffix('.log').read_text()
    return sum(int(b) for b in re.findall(r'(\d+) bytes spill', log))


def _cuobjdump():
    """cuobjdump from the CUDA toolkit, else the copy in triton's package."""
    cand = [os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump'),
            shutil.which('cuobjdump') or '']
    try:
        import triton
        cand.append(os.path.join(os.path.dirname(triton.__file__), 'backends',
                                 'nvidia', 'bin', 'cuobjdump'))
    except ImportError:
        pass
    found = [c for c in cand if c and os.path.exists(c)]
    check(bool(found), 'no cuobjdump in the CUDA toolkit or triton')
    return found[0]


def sass_hmma(name):
    """Tensor-core instructions in the SASS of csrc/<name>.cu's library:
    {HMMA opcode with its shape and types: count}."""
    sass = subprocess.run([_cuobjdump(), '-sass',
                           str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = collections.Counter()
    for line in sass.splitlines():
        for tok in line.split():
            if tok.startswith('HMMA'):
                counts[tok] += 1
    return dict(counts)


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
        'Conv4s2', 'InstanceNormAct', 'conv3x3_dx', 'conv4s2_dx',
        'convt4s2_f2')}
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
    # outside a ConvT4s2 forward is a dx; one inside F2's forward is one of
    # F2's decoder sites
    in_convt_forward, in_f2 = [], []

    def convt4s2(x, w, b=None):
        if not in_convt_forward:
            books['conv4s2_dx'][(_shape(x), _shape(w))] += 1
        elif in_f2:
            books['convt4s2_f2'][(_shape(x), _shape(w), b is not None)] += 1
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
        f2_forward = model.netF2.forward

        def f2_recorded(*args, **kw):
            in_f2.append(True)
            try:
                return f2_forward(*args, **kw)
            finally:
                in_f2.pop()
        model.netF2.forward = f2_recorded
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
    # row 7 at the train step's forward sites (the backward's sites), as
    # InstanceNormAct calls it (with the statistics)
    for (xs, slope), count in sorted(books['InstanceNormAct'].items(),
                                     key=lambda kv: (kv[0][0],
                                                     str(kv[0][1]))):
        n, c, h, w = xs

        def mk(gen, xs=xs):
            return (randn(xs, gen, 2.0) + 0.5,)
        elems = n * c * h * w
        cases.append(Case(
            'instance_norm_act_train', '%d @%dx%d slope %s' % (c, h, w, slope),
            count,
            lambda x, slope=slope: K.instance_norm_act(
                x, 1e-5, slope, return_stats=True)[0],
            lambda x, slope=slope: K.instance_norm_act_plain(x, 1e-5, slope),
            _in_library(slope), 6.0 * elems, 8.0 * elems + 8.0 * n * c,
            4.0 * elems + 8.0 * n * c, mk, within))
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
    # F2's transposed convs (its decoder, 3 forwards a step), against
    # F.conv_transpose2d
    for (xs, ws, has_b), count in sorted(books['convt4s2_f2'].items()):
        n, ci, h, w = xs
        co = ws[1]

        def mk(gen, xs=xs, ws=ws, has_b=has_b):
            return (randn(xs, gen), randn(ws, gen, (4 * ws[0]) ** -0.5),
                    randn((ws[1],), gen, 0.1) if has_b else None)
        elems = n * ci * h * w + ci * co * 16 + n * co * 4 * h * w
        cases.append(Case(
            'convt4s2_f2', '%d->%d @%dx%d%s' % (ci, co, h, w,
                                              ' +b' if has_b else ''),
            count, K.convt4s2, K.convt4s2_plain,
            lambda x, w_, b: F.conv_transpose2d(x, w_, b, 2, 1),
            2.0 * co * 4 * h * w * ci * 4 * n, 4.0 * elems + 4.0 * co * has_b,
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


def phase_reference(g1, g2, card_kernels=True):
    """One 512 px sample on the card, through the kernels (or with
    ``card_kernels`` False through the library calls, as --no_pallas runs
    it), and through the plain versions on the CPU, same weights and
    noise."""
    gen = torch.Generator().manual_seed(7)
    n1 = torch.randn((1, 8, 4, 4), generator=gen)
    n2 = torch.randn((1, 8, 8, 8), generator=gen)
    outs = []
    for dev, on in ((DEV, card_kernels), (torch.device('cpu'), True)):
        a, b = g1.to(dev), g2.to(dev)
        K.set_kernels_enabled(on)
        K.reset_launch_counts()
        with torch.no_grad():
            fa = a(n1.to(dev))
            label = bilinear_upsample(fa, 2)
            fb = b(label, n2.to(dev))
        check(on or not any(K.launch_counts().values()),
              'a library-route sample launched %s' % K.launch_counts())
        outs.append([t.cpu() for t in (fa, label, fb)])
    K.set_kernels_enabled(True)
    for name, x, y in zip(('G1', 'transform', 'G2'), *outs):
        e = err(x, y)
        print('  reference %-9s shape %s max abs err %.3e' % (name,
                                                             tuple(x.shape), e))
        check(e <= 2e-3, 'card vs CPU reference %s: %.3g' % (name, e))
    check(tuple(outs[0][2].shape) == (1, 1, 512, 512), 'G2 output shape')


def profile_rows(run, n, trace_name):
    """Device time per run of fn by kernel from a torch.profiler trace of n
    runs: (rows sorted by time, total device ms per run)."""
    prof, lost = traced(run, n)
    rows = device_rows(prof, n)
    if rows:
        print('  trace: every kernel launch has its device record; the '
              'profiler lost %d of the %d primer records' % (lost,
                                                             PRIMER_SPINS))
    prof.export_chrome_trace(os.path.join(OUT_DIR, trace_name))
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


# device kernel symbols of each wrapper, as the profiler names them
KERNEL_SYMBOLS = {
    'conv3x3': ('conv3x3_tc_kernel',),
    'convt4s2': ('convt4s2_tc_kernel', 'convt4s2_reduce_kernel',
                 'convt4s2_cc_kernel'),
    'instance_norm_act': ('in_fwd_plane_kernel', 'in_stats_kernel',
                          'in_apply_kernel'),
    'conv3x3_dw': ('dw_tc_kernel', 'dw_reduce_kernel'),
    'instance_norm_bwd': ('in_bwd_plane_kernel', 'in_bwd_stats_kernel',
                          'in_bwd_apply_kernel'),
    'conv4s2': ('conv4s2_tc_kernel', 'conv4s2_reduce_kernel'),
    'conv3x3_in_stats': ('conv3x3_in_tc_kernel', 'conv3x3_in_fold_kernel'),
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
        # the kernel's name follows the first namespace; later ones are in
        # its template and parameter types
        sym = key.split('(anonymous namespace)::', 1)[-1].split('<')[0]
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


def phase_profile_step(device_kernels):
    """One bf16 step of the bench configuration, timed alone (wall, with a
    synchronize) and traced: device time per step by kernel, busy share.
    device_kernels: {wrapper: its device kernels a step}, checked against
    the trace."""
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
        for name, want in device_kernels.items():
            got = out['by_kernel'][name][1]
            check(got == want, 'profiled step: %s ran %s device kernels, '
                  'expected %d' % (name, got, want))
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


def phase_reference_step(gate=False, dtype='float32', no_pallas=False):
    """One step at 512 px on the card (kernels; with ``no_pallas`` the
    library calls) and on the CPU (plain versions), same weights, noise and
    batch, no pool, no dropout, in ``dtype`` (--compute_dtype) on both
    sides.  ``gate``: the region's gate on, on both sides (the biases it
    takes are checked for a gradient only: it is rounding noise, as around
    any norm).

    Tolerances, f32: each loss term within 1e-3 relative, each parameter's
    gradient within 5e-2 relative in L2.  bf16 (gate on, the README step):
    each loss term within 1e-2 relative, and each parameter's gradient
    within the larger of 5e-2 and twice that parameter's measured noise
    floor (below: the relative L2 change it makes to the parameter's
    gradient) relative in L2.  In bf16 both sides round every activation
    to bf16 after the same f32 arithmetic, so they differ where an f32 sum
    in another order crosses a bf16 rounding boundary: rare one-ulp flips
    of 2^-8, which the step then carries as it carries the floor's flips.

    Adam's first step moves every parameter by about lr * sign(g), so a D
    entry whose gradient is rounding-sized lands 2 lr apart on the two
    sides, and the G update that follows sees two different D banks.  So
    the CPU's D banks take the card's updated parameters before its G
    update.  What is left is rounding, which this step amplifies (IN over
    the 8^2-16^2 planes of the deep D and F2 layers, activation kinks, real
    against fake in the D losses).  For scale, the phase also runs the CPU
    step with every weight scaled by 1 + 1e-6 N(0, 1), a few f32 ulps (in
    bf16 it flips the rounding of the weights that lie that close to a bf16
    boundary), and prints how far that moves each gradient: the noise
    floor."""
    bf16 = dtype == 'bfloat16'
    tag = '_ref%s%s%s' % ('_gated' if gate else '', '_bf16' if bf16 else '',
                          '_no_pallas' if no_pallas else '')
    with region_gate(gate):
        return _reference_step(REGION_BIASES if gate else (), tag, dtype,
                               loss_tol=1e-2 if bf16 else 1e-3,
                               grad_tol=5e-2, floor_factor=2 if bf16 else 0,
                               card_flags=['--no_pallas'] if no_pallas
                               else [])


def _reference_step(noise_only, tag, dtype, loss_tol, grad_tol,
                    floor_factor, card_flags):
    extra = ['--compute_dtype', dtype, '--pool_size', '0', '--no_dropout2']
    # the CPU models, built after the card's step, turn the kernels back on
    card = create_model(train_opt(extra + card_flags
                                  + ['--name', TRAIN_NAME + tag]))
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
    K.reset_launch_counts()
    t = time.perf_counter()
    m_card = _step_in_parts(card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    card_launches = K.launch_counts()
    check(not card_flags or not any(card_launches.values()),
          'reference step %s: the library route launched %s'
          % (card_flags, card_launches))
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
    floor = {n: a for a, _, n in _grad_diffs(noisy, cpu, noise_only)}
    del noisy
    # per parameter: (card vs CPU, its floor, its limit), nearest the limit
    # first
    held = sorted(((a, floor[n], max(grad_tol, floor_factor * floor[n]), n)
                   for a, _, n in worst),
                  key=lambda h: h[0] / h[2], reverse=True)
    by_noise = sorted(n for _, f, lim, n in held if lim > grad_tol)
    print('  %s: card step %.3f s, CPU step %.3f s; losses card %s cpu %s; '
          'worst loss rel diff %.2e (limit %g)' % (
              dtype, card_s, cpu_s, m_card, m_cpu, worst_metric, loss_tol))
    print('  gradients, card vs CPU (L2 rel, max-entry rel): %s'
          % [(round(a, 6), round(b, 6), n) for a, b, n in worst[:5]])
    print('  noise floor, CPU with weights x (1 + 1e-6 N) vs CPU: %s'
          % [(round(f, 6), n) for f, n in sorted(
              ((f, n) for n, f in floor.items()), reverse=True)[:5]])
    print('  nearest their limit max(%g, %g x own floor), (card vs CPU, '
          'floor, limit): %s' % (grad_tol, floor_factor, [
              (round(a, 6), round(f, 6), round(lim, 6), n)
              for a, f, lim, n in held[:5]]))
    print('  %d of %d limits set by the floor' % (len(by_noise), len(held)))
    check(worst_metric <= loss_tol, 'reference step %s: loss terms differ by '
          '%.3g' % (dtype, worst_metric))
    a, f, lim, n = held[0]
    check(a <= lim, 'reference step %s: %s gradient differs by %.3g relative '
          'in L2 (floor %.3g, limit %.3g)' % (dtype, n, a, f, lim))
    out = dict(dtype=dtype, card_flags=card_flags,
               card_launches=card_launches, card_s=card_s, cpu_s=cpu_s,
               losses_card=m_card,
               losses_cpu=m_cpu, worst_loss_rel=worst_metric,
               loss_tol=loss_tol, grad_tol=grad_tol,
               floor_factor=floor_factor, worst_grads=worst[:10],
               held=held, limits_by_floor=by_noise, params=len(worst))
    del card, cpu
    torch.cuda.empty_cache()
    return out


# The bench entry point's arms, run in turns: (name, flags after its
# DSGAN_ARGS).  Its command line runs 3 windows of 30 steps and a 12-step
# trace; here the windows are BENCH_WINDOW_STEPS steps and the trace
# BENCH_TRACE_STEPS, which keeps this script within twice its time before
# the phase was added.
BENCH_ARMS = (('kernels bf16', []),
              ('no_pallas bf16', ['--no_pallas']),
              ('no_pallas f32', ['--no_pallas', '--compute_dtype', 'float32']),
              ('kernels f32', ['--compute_dtype', 'float32']))
BENCH_WINDOWS = 3
BENCH_WINDOW_STEPS = 10
BENCH_TRACE_STEPS = 4
BENCH_DEVICE_FIELDS = ('device_ms_per_step', 'device_kernels_per_step',
                       'busy_share', 'host_gap_ms', 'device_rate_img_s',
                       'device', 'trace_primer_records_lost', 'chunked_img_s',
                       'chunked_device_ms_per_step',
                       'chunked_device_kernels_per_step',
                       'chunked_busy_share', 'graph_kernels',
                       'chunked_kernels_outside_graph_per_step')


def phase_bench():
    """supervised_gan_tpu_torch.bench.main on each arm in turn, its record
    printed as a line.  Checked: finite losses, value > 0, three windows
    each way (per step and chunked), every device field set (bench.main
    fails when a launch lost its device record), the gates, the wrappers'
    launches a step: the train phase's on the kernels' route (0 for the
    region's two), every one 0 under --no_pallas; and the chunked step's
    traced device kernels a step, and its graph's kernel nodes, equal to
    the eager step's: the graph runs every kernel of the step."""
    out = {}
    for name, flags in BENCH_ARMS:
        kernels = '--no_pallas' not in flags
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec = bench.main(flags + [
                '--checkpoints_dir', CKPT_DIR,
                '--name', '%s_bench_%s' % (NAME, name.replace(' ', '_'))],
                windows=BENCH_WINDOWS, window_steps=BENCH_WINDOW_STEPS,
                trace_steps=BENCH_TRACE_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        print('  bench %s: %s' % (name, buf.getvalue().splitlines()[-1]))
        check(rec['finite'] and rec['value'] > 0
              and len(rec['windows_img_s']) == BENCH_WINDOWS
              and len(rec['chunked_windows_img_s']) == BENCH_WINDOWS,
              'bench %s: not finite or no rate' % name)
        check(all(rec[k] is not None for k in BENCH_DEVICE_FIELDS),
              'bench %s: a device field is null' % name)
        check(rec['gates']['kernels'] == kernels
              and rec['gates']['tf32'] == {'cudnn': False, 'matmul': False},
              'bench %s: gates %s' % (name, rec['gates']))
        check(rec['graph_kernels'] == rec['device_kernels_per_step']
              and rec['chunked_device_kernels_per_step']
              == rec['graph_kernels']
              + rec['chunked_kernels_outside_graph_per_step'],
              'bench %s: the chunked step ran %s device kernels a step (%s '
              'beside its replay), its graph holds %s, the eager step ran %s'
              % (name, rec['chunked_device_kernels_per_step'],
                 rec['chunked_kernels_outside_graph_per_step'],
                 rec['graph_kernels'], rec['device_kernels_per_step']))
        want = {k: float(v) for k, v in expected(
            LAUNCHES_PER_STEP if kernels else {}, 1).items()}
        check(rec['launches_per_step'] == want, 'bench %s: launches a step '
              '%s, expected %s' % (name, rec['launches_per_step'], want))
        out[name] = rec
    K.set_kernels_enabled(True)
    return out


PROFILE_STEPS, PROFILE_IMAGES = 20, 4


def phase_profile_dir():
    """The train entry point with --profile_dir: 20 f32 steps of the bench
    configuration (5 epochs of 4 images).  Checked: one *.pt.trace.json
    written, the line printed, and the file's device kernels: as many as
    the trace counted (every launch of steps 10-20 with its record), at
    least 11 x the wrappers' launches a step."""
    d = os.path.join(RESULTS_DIR, 'profile')
    name = TRAIN_NAME + '_profile_dir'
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = trainer.main(TRAIN_FLAGS + ON_CARD + [
            '--compute_dtype', 'float32', '--name', name,
            '--niter', str(PROFILE_STEPS // PROFILE_IMAGES),
            '--niter_decay', '0', '--max_dataset_size', str(PROFILE_IMAGES),
            '--print_freq', '100', '--display_freq', '100',
            '--save_epoch_freq', '100', '--profile_dir', d])
    check('profiler trace written to %s' % d in buf.getvalue(),
          '--profile_dir: no "profiler trace written" line')
    t = r['trace']
    check(r['steps'] == PROFILE_STEPS and t is not None
          and os.listdir(d) == [os.path.basename(t['path'])]
          and t['path'].endswith('.pt.trace.json'),
          '--profile_dir: %d steps, trace %s, files %s'
          % (r['steps'], t, os.listdir(d)))
    with open(t['path']) as f:
        events = json.load(f)['traceEvents']
    kernels = sum(1 for e in events if e.get('cat') == 'kernel'
                  and 'spin_kernel' not in e.get('name', ''))
    floor = 11 * sum(LAUNCHES_PER_STEP.values())
    print('  %s: %d steps; the trace holds %d device kernels (counted %d, '
          '%d launches; %d of the %d primer records lost), %.1f MB'
          % (name, r['steps'], kernels, t['kernels'], t['launches'],
             t['primer_lost'], PRIMER_SPINS,
             os.path.getsize(t['path']) / 2 ** 20))
    check(kernels == t['kernels'] >= floor, '--profile_dir: %d device '
          'kernels in the file, %d counted, at least %d expected'
          % (kernels, t['kernels'], floor))
    del events
    return dict(t, file_kernels=kernels, steps=r['steps'])


# ------------------------------------------ the chunked (graphed) step -- #

def phase_sync_free(dtype='bfloat16'):
    """One eager step of the bench configuration after two warm-up steps,
    its set_input included, under torch.cuda.set_sync_debug_mode('error'):
    any synchronizing call (a pageable host copy, .item(), a host branch on
    a device value) raises.  What a captured step needs of the eager one."""
    model = create_model(train_opt(['--compute_dtype', dtype, '--name',
                                    TRAIN_NAME + '_sync_free']))
    for seed in range(2):
        model.set_input(fixed_batch(seed=seed))
        model.optimize_parameters()
    torch.cuda.synchronize()
    batch = fixed_batch(seed=2)
    torch.cuda.set_sync_debug_mode('error')
    try:
        model.set_input(batch)
        model.optimize_parameters()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    errors = model.get_current_errors()
    check(all(np.isfinite(v) for v in errors.values()),
          'sync-free step: non-finite losses %s' % errors)
    print('  %s step 3 (set_input + optimize_parameters) made no '
          'synchronizing call; losses %s' % (dtype, dict(errors)))
    del model
    torch.cuda.empty_cache()
    return dict(dtype=dtype, losses=dict(errors))


CHUNK_STEPS = 4
EAGER_RUNS = 3
# the losses the DSGAN step computes from the discriminators it has just
# updated (models/twostage_cycle.py: update_G after update_D1, update_D2)
LOSSES_AFTER_D_UPDATE = ('G1_GAN', 'G2_GAN')
# eager runs on an H100 were seen to differ there by 0, 1 or 2 units in the
# last place of the float32 loss: the least spread those terms are given
ULPS_AFTER_D_UPDATE = 2


def _model_state(model):
    """{name: tensor} of what a step moves, copied: parameters and buffers,
    Adam's moments and steps, the pools' images; and the last step's
    losses."""
    out = {}

    def keep(name, v):
        out[name] = v.detach().to(torch.float32, copy=True)
    for label, net in model.nets().items():
        for k, v in net.state_dict().items():
            keep('%s.%s' % (label, k), v)
    for label, opt in model.optimizers().items():
        for i, st in enumerate(opt.state.values()):
            for k, v in st.items():
                keep('adam.%s.%d.%s' % (label, i, k), v)
    for label, p in model.pools.items():
        if p is not None:
            keep('pool.%s' % label, p['images'])
    return out, dict(model.get_current_errors())


def _state_diff(a, b):
    """Two _model_state results apart: the largest relative L2 difference of
    a tensor and its name, the tensors that differ at all, the relative L2
    difference of the whole state, and each loss's absolute difference."""
    (ta, la), (tb, lb) = a, b
    check(ta.keys() == tb.keys(), 'chunked state: keys differ')
    worst, name, differ, num, den = 0.0, None, 0, 0.0, 0.0
    for k in ta:
        x, y = ta[k].double(), tb[k].double()
        d, n = float((x - y).norm()), float(x.norm())
        num, den = num + d * d, den + n * n
        if d:
            differ += 1
            rel = d / max(n, 1e-30)
            if rel > worst:
                worst, name = rel, k
    return dict(worst=worst, name=name, differ=differ,
                whole=(num / max(den, 1e-300)) ** 0.5,
                losses={k: abs(la[k] - lb[k]) for k in la})


def _train_model(dtype, label):
    return create_model(train_opt([
        '--compute_dtype', dtype, '--name',
        '%s_chunk_%s' % (TRAIN_NAME, label)]))


def _eager_steps(model, batches):
    for b in batches:
        model.set_input(b)
        model.optimize_parameters()


def _chunk_runs_deterministic(dtype):
    """Under torch.use_deterministic_algorithms (warn only), the states
    after CHUNK_STEPS steps of three models from one seed and one state (the
    bench configuration, pools and dropout on): A and A2 by eager steps on
    the same batches, B by one train_chunk of them (two eager steps, then
    its capture and two replays)."""
    batches = [fixed_batch(seed=10 + i) for i in range(CHUNK_STEPS)]
    states = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label in ('A', 'A2', 'B'):
            model = _train_model(dtype, label)
            if label == 'B':
                model.train_chunk(batches)
                check(model.graph_kernels() is not None
                      and model.steps_run == CHUNK_STEPS,
                      'train_chunk did not capture its step')
                graph_kernels = model.graph_kernels()
            else:
                _eager_steps(model, batches)
            torch.cuda.synchronize()
            states[label] = _model_state(model)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    spread = _state_diff(states['A'], states['A2'])
    chunked = _state_diff(states['A'], states['B'])
    print('  %s, %d steps, deterministic: eager vs eager: %d of %d tensors '
          'differ, losses %s; chunked vs eager: %d differ (worst %s), losses '
          '%s; the graph holds %d kernels'
          % (dtype, CHUNK_STEPS, spread['differ'], len(states['A'][0]),
             spread['losses'], chunked['differ'], chunked['name'],
             chunked['losses'], graph_kernels))
    return dict(eager_spread=spread, chunked=chunked,
                graph_kernels=graph_kernels, tensors=len(states['A'][0]))


def _chunk_runs_default(dtype):
    """One step under the default algorithms from one state: EAGER_RUNS
    eager models A0.. and a chunked model B each take CAPTURE_AFTER eager
    steps under deterministic algorithms (their states and losses then
    bitwise equal, checked), then one more step on the same batch, an eager
    one in A0.., in B the first replay of the step it captures there (its
    train_chunk of that batch).  The states and losses after it, each A
    against each other A (the eager spread) and B against each A."""
    batches = [fixed_batch(seed=10 + i) for i in range(CAPTURE_AFTER + 1)]
    eager = ['A%d' % i for i in range(EAGER_RUNS)]
    prefix, finals = None, {}
    for label in eager + ['B']:
        model = _train_model(dtype, label)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            if label == 'B':
                model.train_chunk(batches[:CAPTURE_AFTER])
            else:
                _eager_steps(model, batches[:CAPTURE_AFTER])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        state = _model_state(model)
        if prefix is None:
            prefix = state
        else:
            d = _state_diff(prefix, state)
            check(d['differ'] == 0 and not any(d['losses'].values()),
                  '%s %s: after %d deterministic steps %d tensors differ '
                  'from A0 (worst %s), losses %s' % (
                      dtype, label, CAPTURE_AFTER, d['differ'], d['name'],
                      d['losses']))
        del state
        if label == 'B':
            model.train_chunk(batches[CAPTURE_AFTER:])
            check(model.graph_kernels() is not None
                  and model.steps_run == CAPTURE_AFTER + 1,
                  'train_chunk did not capture its step')
            graph_kernels = model.graph_kernels()
        else:
            _eager_steps(model, batches[CAPTURE_AFTER:])
        torch.cuda.synchronize()
        finals[label] = _model_state(model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    pairs = {'%s-%s' % (a, b): _state_diff(finals[a], finals[b])
             for i, a in enumerate(eager) for b in eager[i + 1:]}
    chunked = {'B-%s' % a: _state_diff(finals[a], finals['B'])
               for a in eager}
    return dict(eager_spread=pairs, chunked=chunked, losses=finals['A0'][1],
                graph_kernels=graph_kernels, tensors=len(finals['A0'][0]))


def phase_chunk_equals_eager(dtype):
    """Chunked (replays of the captured step) against eager steps: every
    parameter and buffer, Adam moment and step, the pools' images and the
    last losses.

    Under deterministic algorithms (_chunk_runs_deterministic, CHUNK_STEPS
    steps, two of them replays) the eager runs are bitwise equal, and the
    chunked run must be too: the exact check of the noise draws' offsets,
    Adam's path, the pool rows, the inputs and the outputs' binding.

    With the default algorithms (the graph a run captures) cuDNN's weight
    gradients and index_select's backward sum in another order on each
    run, so eager runs differ; over several GAN steps the difference grows
    and the distance of two runs is a draw that one pair cannot bound.  So
    _chunk_runs_default takes one default step from a state the runs share
    bitwise, and holds B against each eager run within twice the largest
    of the eager pairs: the whole state's relative L2 difference, the
    largest of one tensor, and each loss.  A loss the eager runs agree on
    (those of the step's starting state) must agree bitwise; the G terms
    read the discriminators this step updated, where a rounding flip of
    their float32 value is part of the eager spread, so their spread is at
    least ULPS_AFTER_D_UPDATE units in its last place."""
    det = _chunk_runs_deterministic(dtype)
    spread, chunked = det['eager_spread'], det['chunked']
    check(spread['differ'] == 0 and not any(spread['losses'].values()),
          'deterministic eager %s runs differ (%s)' % (dtype, spread['name']))
    check(chunked['differ'] == 0 and not any(chunked['losses'].values()),
          'chunked %s differs from eager under deterministic algorithms (%d '
          'tensors, worst %s, losses %s)' % (dtype, chunked['differ'],
                                             chunked['name'],
                                             chunked['losses']))
    default = _chunk_runs_default(dtype)
    pairs, chunked = default['eager_spread'], default['chunked']
    limits = {m: 2 * max(p[m] for p in pairs.values())
              for m in ('whole', 'worst')}
    for k, v in default['losses'].items():
        s = max(p['losses'][k] for p in pairs.values())
        if k in LOSSES_AFTER_D_UPDATE:
            s = max(s, ULPS_AFTER_D_UPDATE
                    * float(np.spacing(np.float32(abs(v)))))
        limits[k] = 2 * s
    print('  %s, one step from a shared state, default algorithms: eager vs '
          'eager %s; chunked vs eager %s; limits %s; the graph holds %d '
          'kernels' % (
              dtype,
              {n: ('%.4g' % p['whole'], '%.4g' % p['worst'], p['differ'],
                   p['losses']) for n, p in pairs.items()},
              {n: ('%.4g' % c['whole'], '%.4g' % c['worst'], c['differ'],
                   c['losses']) for n, c in chunked.items()},
              {m: '%.4g' % v for m, v in limits.items()},
              default['graph_kernels']))
    for n, c in chunked.items():
        over = [m for m in ('whole', 'worst') if c[m] > limits[m]]
        over += [k for k, v in c['losses'].items() if v > limits[k]]
        check(not over, 'chunked %s, %s: %s beyond twice the eager spread '
              '(%s)' % (dtype, n, over,
                        {m: (c[m] if m in c else c['losses'][m], limits[m])
                         for m in over}))
    return dict(dtype=dtype, steps=CHUNK_STEPS, deterministic=det,
                default=default, limits=limits)


DRIVER_CHUNK, DRIVER_PRINT = 4, 6


def phase_chunked_driver():
    """The train entry point with --steps_per_dispatch 4 on the bench
    configuration, bf16, one epoch of the 8 synthetic images with a print at
    step 6: chunks of 4 (two eager steps, the capture, two replays), 2 (the
    print's flush) and 2 (the epoch's last batch), each printed; finite
    losses at step 6; latest_net_*.pth and latest_state.pt written."""
    name = TRAIN_NAME + '_chunked'
    buf = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        r = trainer.main(TRAIN_FLAGS + ON_CARD + [
            '--compute_dtype', 'bfloat16', '--name', name, '--niter', '1',
            '--niter_decay', '0', '--max_dataset_size', str(TRAIN_IMAGES),
            '--print_freq', str(DRIVER_PRINT), '--display_freq', '100',
            '--save_epoch_freq', '1',
            '--steps_per_dispatch', str(DRIVER_CHUNK)])
    counts = K.launch_counts()
    out = buf.getvalue()
    chunk_lines = [l for l in out.splitlines()
                   if l.startswith('dispatched a chunk')]
    want = [DRIVER_CHUNK, DRIVER_PRINT - DRIVER_CHUNK,
            TRAIN_IMAGES - DRIVER_PRINT]
    check(r['steps'] == TRAIN_IMAGES and r['chunks'] == want
          and len(chunk_lines) == len(want),
          'chunked driver: %d steps in chunks %s (%d lines), expected %s'
          % (r['steps'], r['chunks'], len(chunk_lines), want))
    losses = [l for l in out.splitlines() if l.startswith('(epoch')]
    vals = [float(v) for v in re.findall(r': (-?[\d.]+|nan|inf)',
                                         losses[0].split(')', 1)[1])]
    check(len(losses) == 1 and all(np.isfinite(vals)),
          'chunked driver: loss lines %s' % losses)
    run_dir = os.path.join(CKPT_DIR, name)
    files = set(os.listdir(run_dir))
    nets = ('G1', 'G2', 'F2', 'D1_0', 'D1_1', 'D2_0', 'D2_1', 'D2_2', 'D2_3')
    missing = ({'latest_net_%s.pth' % n for n in nets} | {'latest_state.pt'}
               ) - files
    check(not missing, 'chunked driver: missing %s' % sorted(missing))
    print('  chunks %s (%s); step 6 losses %s; wall a dispatch %s ms; '
          'wrapper launches %s (the eager steps and the capture: replays '
          'run no wrapper)' % (r['chunks'], '; '.join(chunk_lines),
                               losses[0], ['%.1f' % (1e3 * t)
                                           for t in r['step_seconds']],
                               counts))
    return dict(chunks=r['chunks'], step_seconds=r['step_seconds'],
                launches=counts, losses=losses[0])


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

    hmma = {}
    spills = {}
    for name in ('conv3x3', 'conv3x3_dw', 'conv4s2', 'convt4s2',
                 'conv3x3_in'):
        hmma[name] = sass_hmma(name)
        spills[name] = ptxas_spills(name)
        print('%s SASS: %d HMMA instructions %s; ptxas spills %d bytes'
              % (name, sum(hmma[name].values()), hmma[name], spills[name]))
        for op in ('HMMA.16816.F32.BF16', 'HMMA.1688.F32.TF32'):
            check(hmma[name].get(op, 0) > 0, '%s: no %s in its SASS'
                  % (name, op))
    check(spills['conv3x3_in'] == 0, 'conv3x3_in: ptxas reports %d bytes of '
          'spills' % spills['conv3x3_in'])

    print('== conv3x3 at ragged shapes, and two runs of one launch')
    conv3_shapes = phase_conv3x3_shapes()
    print('== conv3x3_dw at ragged shapes, and two runs of one launch')
    dw_shapes = phase_conv3x3_dw_shapes()
    print('== conv4s2 at ragged shapes, and two runs of one launch')
    c4_shapes = phase_conv4s2_shapes()
    print('== convt4s2 at ragged shapes, and two runs of one launch')
    ct_shapes = phase_convt4s2_shapes()
    print('== instance_norm_act and instance_norm_bwd at ragged shapes, at '
          'their routes\' thresholds, and two runs of one launch')
    in_shapes, in_shape_plans = phase_instance_norm_shapes()
    in_ptxas = ptxas_in_kernels()
    print('  one-launch kernels, [registers, spill bytes]: %s' % in_ptxas)
    check(in_ptxas and all(v[1] == 0 for v in in_ptxas.values()),
          'IN one-launch kernels spill or are missing: %s' % in_ptxas)

    print('== forward kernels vs plain versions at the 512 px sampler sites')
    per_site, agg = run_cases(sampler_cases())

    print('== the fused conv3x3 + IN region\'s kernels at the CRN trunk sites')
    per_site_r, agg_r = phase_region()
    print('== conv3x3_in_stats at ragged shapes and on constant planes')
    region_shapes = phase_region_shapes()
    agg.update(agg_r)

    print('== the train step\'s sites (one f32 step, bench.py configuration)')
    books = record_train_sites()
    for name, book in books.items():
        print('  %-17s %3d calls a step at %3d shapes' % (
            name, sum(book.values()), len(book)))
    dx_per_step = {
        'conv3x3_dx': LAUNCHES_PER_STEP['conv3x3'] - 2 * G2_CONV3,
        'conv4s2_dx': (LAUNCHES_PER_STEP['convt4s2'] - G1_CONVT
                       - 3 * F2_UP),
        'convt4s2_f2': 3 * F2_UP}
    for k, n in list(dx_per_step.items()) + [
            (k, LAUNCHES_PER_STEP[k])
            for k in ('conv3x3_dw', 'instance_norm_bwd', 'conv4s2')]:
        check(sum(books[k].values()) == n, 'recorded %s calls %d, expected '
              '%d a step' % (k, sum(books[k].values()), n))
    for (xs, co) in books['conv3x3_dw']:
        check_dw_plan(xs[0], xs[1], co, xs[2], xs[3])
    for (xs, ws, _) in books['conv4s2']:
        check_conv4s2_plan(xs[0], xs[1], ws[0], xs[2], xs[3])
    # convt4s2's sites, (N, Ci, Co, H, W): the sampler's, G1's and F2's
    # forwards in the step (ConvT4s2) and its dx launches
    ct_sites = collections.Counter()
    for (xs, ws, _), c in books['ConvT4s2'].items():
        ct_sites[(xs[0], xs[1], ws[1], xs[2], xs[3])] += c
    for (gs, ws), c in books['conv4s2_dx'].items():
        ct_sites[(gs[0], gs[1], ws[1], gs[2], gs[3])] += c
    check(sum(ct_sites.values()) == LAUNCHES_PER_STEP['convt4s2'],
          'recorded convt4s2 calls %d, expected %d a step'
          % (sum(ct_sites.values()), LAUNCHES_PER_STEP['convt4s2']))
    for site in list(ct_sites) + [(1, ci, co, s, s)
                                  for ci, co, s, _ in CONVT_SITES]:
        check_convt4s2_plan(*site)
    c4_sites = collections.Counter()
    for (xs, ws, _), c in books['conv4s2'].items():
        c4_sites[(xs[0], xs[1], ws[0], xs[2], xs[3])] += c
    # the IN kernels' plans at the sampler's and the train step's sites;
    # one device kernel a launch, two on the two-pass route (the profiled
    # step is bf16)
    check(sum(books['InstanceNormAct'].values())
          == LAUNCHES_PER_STEP['instance_norm_act'],
          'recorded InstanceNormAct calls %d, expected %d a step'
          % (sum(books['InstanceNormAct'].values()),
             LAUNCHES_PER_STEP['instance_norm_act']))
    in_site_plans = {}
    for shape in sorted({(1, c, s_, s_) for c, s_, _ in IN_SITES}
                        | {xs for xs, _ in books['instance_norm_bwd']}
                        | {xs for xs, _ in books['InstanceNormAct']}):
        plans = check_in_plan(*shape)
        in_site_plans[repr(shape)] = {
            '%s %s' % (dt, d): dict(plan._asdict(), active=a)
            for (dt, d), (plan, a) in plans.items()}
        print('  IN plan %-20s %s' % (shape, _plan_text(plans)))

    def two_pass(book, direction):
        return sum(c for (xs, _), c in book.items()
                   if IN_MODULE.in_plan(*xs, torch.bfloat16,
                                        direction).route == 'two_pass')
    device_kernels = {
        'convt4s2': (LAUNCHES_PER_STEP['convt4s2']
                     + split_launches(CT_MODULE, ct_sites)),
        'conv4s2': (LAUNCHES_PER_STEP['conv4s2']
                    + split_launches(C4_MODULE, c4_sites)),
        'instance_norm_act': (LAUNCHES_PER_STEP['instance_norm_act']
                              + two_pass(books['InstanceNormAct'],
                                         'forward')),
        'instance_norm_bwd': (LAUNCHES_PER_STEP['instance_norm_bwd']
                              + two_pass(books['instance_norm_bwd'],
                                         'backward'))}
    print('  device kernels a step (wrapper launches + reduces or second '
          'passes): %s'
          % device_kernels)

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
    print('== --no_pallas: one 512 px sample, card library calls vs CPU '
          'plain; 2 samples through the sampler, no kernel launched')
    phase_reference(g1, g2, card_kernels=False)
    r_np, counts_np = run_sampler(DSGAN_FLAGS + ['--no_pallas'], 2,
                                  os.path.join(RESULTS_DIR, 'no_pallas'), {})
    K.set_kernels_enabled(True)
    print('sampler --no_pallas: 2 samples in %.3f s; launches %s'
          % (r_np['loop_seconds'], counts_np))
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
    prof = phase_profile_step(device_kernels)
    print('== reference: one f32 train step at 512 px, card vs CPU plain')
    ref_step = phase_reference_step()
    print('== reference under --no_pallas: one f32 train step at 512 px, '
          'card library calls vs CPU plain')
    ref_step_np = phase_reference_step(no_pallas=True)
    print('== --profile_dir: a trace of steps 10-20 of a %d-step f32 run'
          % PROFILE_STEPS)
    profile_dir = phase_profile_dir()
    print('== the bench entry point: kernels and --no_pallas, bf16 and f32, '
          'in turns')
    bench_arms = phase_bench()
    print('== the step without a synchronize: one eager bf16 step under '
          'set_sync_debug_mode("error")')
    sync_free = phase_sync_free()
    print('== chunked == eager: %d steps, train_chunk (a captured step '
          'replayed) against eager steps, f32 and bf16, deterministic; one '
          'step with the default algorithms' % CHUNK_STEPS)
    chunk_eq = {dt: phase_chunk_equals_eager(dt)
                for dt in ('float32', 'bfloat16')}
    print('== the train entry point with --steps_per_dispatch %d'
          % DRIVER_CHUNK)
    chunked_driver = phase_chunked_driver()

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
    print('== reference: one bf16 train step with the region\'s gate on (the '
          'README step), card vs CPU plain, both in bf16')
    ref_step_bf16 = phase_reference_step(gate=True, dtype='bfloat16')

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
                  hmma=hmma, ptxas_spills=spills,
                  region_shapes=region_shapes, conv3x3_shapes=conv3_shapes,
                  conv3x3_dw_shapes=dw_shapes, conv4s2_shapes=c4_shapes,
                  convt4s2_shapes=ct_shapes, device_kernels=device_kernels,
                  instance_norm_shapes=in_shapes,
                  instance_norm_shape_plans=in_shape_plans,
                  instance_norm_site_plans=in_site_plans,
                  instance_norm_ptxas=in_ptxas,
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
                  bench=bench_arms, profile_dir=profile_dir,
                  chunked=dict(sync_free=sync_free, equals_eager=chunk_eq,
                               driver=chunked_driver),
                  no_pallas=dict(sampler_launches=counts_np,
                                 sampler_loop_seconds=r_np['loop_seconds'],
                                 reference_step=ref_step_np),
                  train=dict(bf16=train16, f32=train32, profile=prof,
                             reference_step=ref_step,
                             reference_step_gated=ref_step_gated,
                             reference_step_bf16=ref_step_bf16),
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
