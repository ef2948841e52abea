#!/usr/bin/env python3
"""Drive the PyTorch port's DSGAN sampler, DSGAN train step (per step and
chunked, --steps_per_dispatch, as a CUDA graph of the step), stage-1 label
GAN, the README DSGAN workflow, SGAN step 2 (--model cgan: training,
chunked, its conditional sampler), the segmentation gate (train_ss,
test_ss), the rest of the two-stage family (--model twostage and
twostage_factd, the DSGAN's training options), latent inversion (recon),
the cgan family (cgan_cycle, cgan2, cgan2_cycle, cgan_causal),
segmentation_cycle, --model test (resnet_9blocks), the rest of the
network zoo (fcgan_star, the autoencoder, n_layers_sep, the dcgan G and D)
on the recipes that select them, the native PNG decoder and the loader,
the quality gate (quality_eval), data parallelism (--data_mesh), spatial
parallelism (--spatial_mesh), and the bench entry points on one CUDA card, on the hand-written kernels and under
--no_pallas, and hold every hand-written kernel against its plain PyTorch
version.

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
     every parameter's gradient within 5e-2 relative in L2 (the bf16
     step's limits also take the noise floor of a CPU step with weights
     scaled by 1 + 1e-6 N(0, 1); see phase_reference_step); then the same
     with the card's step under
     --no_pallas (library calls, no launch); then the train entry point
     with --profile_dir, 20 f32 steps, its trace of steps 10-20 written
     with every launch's device record (phase_profile_dir); then the bench
     entry point (supervised_gan_tpu_torch.bench.main) in turns: kernels
     bf16, --no_pallas bf16, --no_pallas f32, kernels f32, each BENCH_WINDOWS
     windows
     of BENCH_WINDOW_STEPS steps per step and chunked (one chunk of
     BENCH_CHUNK) and a BENCH_TRACE_STEPS-step trace (one chunk traced), its
     record printed, finite, its device fields set, its wrappers' launches
     a step those of this phase (all 0 under --no_pallas; phase_bench);
     Then the chunked dispatch (--steps_per_dispatch, a CUDA graph of the
     step, models/graph.py): one eager bf16 step of the bench configuration,
     set_input included, under torch.cuda.set_sync_debug_mode("error")
     (phase_sync_free); train_chunk of 4 batches against 4 eager steps in
     f32 and bf16, every parameter, Adam moment and pool image and the last
     losses, bitwise under deterministic algorithms; and one step under the
     default algorithms, a replay against eager steps from a state they
     share bitwise, within twice the spread of three eager runs, at least
     SPREAD_FLOOR (phase_chunk_equals_eager); in each bench arm
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
 14. phase 10 in bf16 on both sides with the region's gate on (see
     phase_reference_step for its tolerances; the gated f32 step, which
     the bf16 one covers, was cut to make room for phase 22);
 15. SGAN step 2 and the segmentation gate: a synthetic set of 512^2 PNGs
     (train 4, val 2, test 4; discs in R, their complement in G, an image
     of them in B); the kernel sites of one f32 cgan step (CGAN_FLAGS,
     tools/bench_extra.py:54-68) and of one segmentation step and val
     forward (SEG_ARCH, tools/quality_eval.py:94-104 at 512 px), their
     totals against the launch counts written from the networks' structure
     (CGAN_PER_STEP, SEG_PER_STEP, SEG_PER_FORWARD), and the sites the DSGAN
     step does not have, printed, each with its tc_plan or in_plan checked;
     conv4s2, convt4s2 (forward and as dx) and the IN kernels (forward and
     backward) there as in 3 and 6, f32 and bf16, with device times
     against the library calls; the train entry point on the cgan command,
     8 bf16 steps with exact launch counts, and with --steps_per_dispatch
     10 over two epochs (chunks 8 and 8; the wrappers see 3 steps); 4
     chunked cgan steps bitwise equal to 4 eager ones under deterministic
     algorithms (pools, dropout and the Gaussian noise on); one f32 cgan
     iteration card vs CPU as in 10 (losses 1e-3, gradients within
     max(5e-2, 2 x floor) in L2); the conditional sampler on the trained G
     over 4 test images (launches, images/s); bench_extra's
     cgan_pix2pix_512 on the kernels and under --no_pallas, held as the
     bench's arms; train_ss (4 steps, validation, the best checkpoint) and
     test_ss on it: exact launch counts, RandScore and meanIU finite and
     within [0, 1], the step time and the test images/s; the segmentation
     step through bench.main on both routes, f32, held as the bench's arms;
 16. the rest of the two-stage family and latent inversion: the kernel
     sites of one f32 step of twostage and twostage_factd (the README
     command with --model changed, F2's flags dropped) and of the bench
     configuration with --use_multi_class_GAN, with the fake_fake pairs
     and --use_fixed_noise1, and with --no_cgan, and of one evaluation of
     the inversion's objective with its gradient on stage 1's G; their
     totals against TS_PER_STEP (written from the nets' structure), the
     sites the DSGAN step does not have held against their plain versions
     as in 3 and 6; each path TS_STEPS bf16 steps through the train entry
     point (exact launches, finite losses) and a --steps_per_dispatch
     chunk (the wrappers see 3 steps); twostage and twostage_factd also
     the bench entry point on their command (bf16, kernels; held as the
     bench phase's arms), CHUNK_STEPS chunked steps bitwise equal to
     eager ones under deterministic algorithms, and one
     f32 iteration card vs CPU as in 10 (losses 1e-3, gradients within
     max(5e-2, 2 x floor) in L2), as the fake_fake run has; then recon on
     stage 1's G at 512 px: the objective and its gradient in the noise
     card vs CPU (1e-4 relative, 5e-2 in L2), and the recon entry point on
     RECON_IMAGES images (each fit no worse than its start, launches from
     the objective's evaluations, seconds an image, its last line);
 17. the last recipes: the cgan family (cgan_cycle, cgan2, cgan2_cycle,
     cgan_causal; CGAN_FLAGS' nets, the cycle's in the suffixed flags
     with a unet_256 G2 from the image back to the label) on the
     synthetic set and on an unaligned one (trainA: its images, trainB:
     4 fake labels), segmentation_cycle (SEG_ARCH's G with a G2 and a
     1-scale D2, f32) and --model test (resnet_9blocks ngf 64): the
     kernel sites of one f32 step of each recipe, of one
     segmentation_cycle val forward and of one resnet forward, their
     totals against the launches written from the nets' structure
     (FAMILY_PER_STEP, SEGC_PER_STEP, SEGC_PER_FORWARD,
     RESNET_PER_FORWARD), the sites no earlier phase has held against
     their plain versions as in 3 and 6; each cgan family recipe LAST_STEPS
     bf16 steps through the train entry point (exact launches, finite
     losses, its checkpoints), the bench entry point on its command (bf16,
     kernels; held as the bench phase's arms) and one f32 iteration card
     vs CPU as in 10 (cgan2_cycle at full width, the others at ngf / ndf
     16); cgan_cycle also CHUNK_STEPS chunked steps bitwise equal to eager
     ones (deterministic algorithms) and its conditional sampler on the
     trained run; segmentation_cycle train_ss (LAST_STEPS steps,
     validation, the best checkpoint) and test_ss on it (exact launches,
     RandScore and meanIU within [0, 1]), its step through bench.main
     (f32, kernels) and one f32 iteration card vs CPU; TestModel's resnet
     forward card vs CPU in f32 (2e-3), then its images/s in f32 and bf16
     with exact launches;
 18. the rest of the zoo, each net on the README command that selects
     it, changed in its nets alone (ZOO): Z1 stage 1 with fcgan_star, Z2
     SGAN step 2 with the autoencoder G and n_layers_sep, Z3 JointGAN with
     the dcgan G and D at their fixed 128 px: the kernel sites of one f32
     step of each, their totals against the launches written from the
     nets' structure (ZOO per_step), the sites no earlier phase has held
     against their plain versions as in 3 and 6; each path LAST_STEPS
     bf16 steps through the train entry point (exact launches, finite
     losses, its checkpoints loaded back strictly by --continue_train),
     its sampler on the trained run (exact launches a sample), the bench
     entry point on its command (bf16, kernels; per step and chunked, a
     CUDA graph of the step; held as the bench phase's arms) and one f32
     iteration card vs CPU as in 10 (losses 1e-3, gradients within
     max(5e-2, 2 x floor) in L2; Z2 at ngf / ndf 16);
 19. the host image path: the native PNG decoder (supervised_gan_tpu_torch/
     csrc/dataio.cpp, built with g++ into supervised_gan_tpu_torch/build/
     beside the kernels; a failed build fails the run) against PIL on the
     1024^2 training set and the gate's 512^2 set, pixel for pixel, and
     load_rgb's host ms an image each way, in turns; the cgan command's
     input path stage by stage (load_rgb, dataset.get, the loader's
     collate, the model's set_input to a synchronize) and the loader alone,
     each way; the train entry point on the cgan command per step and
     chunked (--steps_per_dispatch), with the decoder and with
     --no_native_io (exact launches);
 20. the quality gate (supervised_gan_tpu_torch/quality_eval.py) at its
     full width, 512 px, ngf 16, and a smoke's depth (GATE_ARGS): the
     kernel sites of one f32 step of its GAN (conv3x3 included) and of
     one segmentation step and val forward, their totals against the
     launches written from the nets' structure (GATE_PER_STEP, SEG_PER_STEP,
     SEG_PER_FORWARD), the sites no earlier phase has held against their
     plain versions as in 3 and 6; then the gate itself, every driver in
     turn in-process with its exact launches (gate_launches), its sampled
     *AB* pairs decoded natively, RandScore and meanIU within [0, 1] and
     every metric finite for the GAN pairs, the real-pairs bound and the
     label-shuffled control;
 21. data parallelism (supervised_gan_tpu_torch/parallel/): train
     --data_mesh 2 on this one-card machine raises the fewer-cards error;
     two gloo ranks sharing cuda:0 (parallel.init_distributed with an
     explicit backend; NCCL refuses two ranks a card), one row each of the
     bench DSGAN configuration's global batch 2 in f32, DM_STEPS steps,
     against DM_RUNS one-process runs of the batch: each rank's launches
     the batch-1 step's, the ranks' states bitwise equal, the losses and
     every parameter, Adam moment and pool within twice the one-process
     runs' spread, at least twice DM_SPREAD_FLOOR (dm_limits); each rank's
     ms a step beside the one process's, on the card line; an NCCL group of
     one: one step with the gradient hook and the BatchNorm all-reduce on,
     bitwise equal to the step without a group (deterministic algorithms);
 22. spatial parallelism (supervised_gan_tpu_torch/parallel/spatial.py):
     the row-split IN entries (instance_norm_partial_stats,
     instance_norm_bwd_partial_stats, instance_norm_bwd_apply) against
     their plain versions at a rank's half of a 512^2 plane, 64 channels,
     f32 and bf16, two runs bitwise identical; train --spatial_mesh 2 on
     this one-card machine raises the fewer-cards error; two gloo ranks
     sharing cuda:0 split the height of the bench DSGAN configuration (f32,
     batch 1), SP_STEPS steps, against SP_RUNS one-process runs: each
     rank's launches sp_per_step's (rehearsed on the CPU: every conv site
     on its kernel, every IN plane of 16 rows or more on the row-split
     entries), the ranks' states bitwise equal, the losses and every
     parameter, Adam moment and pool (gathered whole) within dm_limits of
     SP_SPREAD_FLOOR; each rank's ms a step and its halo exchanges',
     all-reduces' and all-gathers' ms, on the card line;
 23. a JSON line of per-kernel results (launches: the DSGAN train step's;
     the row-split IN entries': phase 22's sharded step's), the card line,
     and the last line {"ok": true, "device": {...}}.

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
from supervised_gan_tpu_torch import bench_extra  # noqa: E402
from supervised_gan_tpu_torch import recon  # noqa: E402
from supervised_gan_tpu_torch import nn as tnn  # noqa: E402
from supervised_gan_tpu_torch import parallel  # noqa: E402
from supervised_gan_tpu_torch import quality_eval  # noqa: E402
from supervised_gan_tpu_torch import test as sampler  # noqa: E402
from supervised_gan_tpu_torch import test_ss  # noqa: E402
from supervised_gan_tpu_torch import train as trainer  # noqa: E402
from supervised_gan_tpu_torch import train_ss  # noqa: E402
from supervised_gan_tpu_torch.data import CreateDataLoader  # noqa: E402
from supervised_gan_tpu_torch.data import loader as data_loader  # noqa: E402
from supervised_gan_tpu_torch.data import native_io  # noqa: E402
from supervised_gan_tpu_torch.data import transforms  # noqa: E402
from supervised_gan_tpu_torch.models import create_model  # noqa: E402
from supervised_gan_tpu_torch.models.base import CAPTURE_AFTER  # noqa: E402
from supervised_gan_tpu_torch.models.fcgan import FCGANModel  # noqa: E402
from supervised_gan_tpu_torch.nn import core as nn_core  # noqa: E402
from supervised_gan_tpu_torch.ops import bilinear_upsample  # noqa: E402
from supervised_gan_tpu_torch.ops import conv as ops_conv  # noqa: E402
from supervised_gan_tpu_torch.ops import kernels as K  # noqa: E402
from supervised_gan_tpu_torch.ops import norm as ops_norm  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import build  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import common  # noqa: E402
from supervised_gan_tpu_torch.ops.kernels import functions  # noqa: E402
from supervised_gan_tpu_torch.options import TestOptions  # noqa: E402
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
                'convt4s2_f2', 'convt4s2_fwd', 'conv3x3_dw', 'conv4s2',
                'conv3x3_in_stats')

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


def two_stage_per_step(f2=True, d2_fakes=1, g2_pairs=1,
                       d1=(D1_CONV, D1_STEMS), d2=(D2_CONV, D2_STEMS)):
    """Launches a step of a two-stage recipe at n_update 1: with F2 (the
    cycle) or without (twostage), D2 updated on ``d2_fakes`` fake pairs and
    the real one and judging ``g2_pairs`` pairs in the G update.  G2 on the
    fake label has a backward with F2, whose cycle term consumes it; without
    F2 (and without a fake_fake G2 pair) it feeds no loss.  ``d1``, ``d2``:
    each D bank's (k4 s2 convs, stems), one IN a conv."""
    d2_passes = d2_fakes + 1 + g2_pairs
    f2 = int(f2)
    (d1_conv, d1_stems), (d2_conv, d2_stems) = d1, d2
    return {
        'conv3x3': (2 * G2_CONV3 + (G2_CONV3 - G2_LABEL_SIDE)
                    + f2 * G2_CONV3),
        'conv3x3_dw': (1 + f2) * G2_CONV3,
        'instance_norm_act': (2 * G2_IN + 3 * F2_IN * f2 + 3 * d1_conv
                              + d2_passes * d2_conv),
        'instance_norm_bwd': ((1 + f2) * G2_IN + 3 * F2_IN * f2
                              + 3 * d1_conv + d2_passes * d2_conv),
        'conv4s2': (3 * F2_DOWN * f2 + 3 * d1_conv + d2_passes * d2_conv
                    + 3 * F2_UP * f2 + (G1_CONVT - 1)),
        'convt4s2': (G1_CONVT + 3 * F2_UP * f2
                     + 2 * (d1_conv - d1_stems)
                     + (d2_fakes + 1) * (d2_conv - d2_stems)
                     + d1_conv + g2_pairs * d2_conv
                     + f2 * ((F2_DOWN - 1) + 2 * F2_DOWN)),
    }


LAUNCHES_PER_STEP = two_stage_per_step()

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
    'instance_norm_partial_stats': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:297'),
    'instance_norm_bwd_partial_stats': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:319'),
    'instance_norm_bwd_apply': dict(
        source='supervised_gan_tpu_torch/csrc/instance_norm.cu',
        replaces='supervised_gan_tpu/ops/pallas/instance_norm.py:337'),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


T_START = time.time()


def heading(msg):
    """A phase's heading, with the seconds since the script started (where
    the run's time goes)."""
    print('%s  [%.1f s]' % (msg, time.time() - T_START), flush=True)


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


def _ms(t):
    return 'none' if t is None else '%.4f' % t


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
        # the bf16 yardstick: the same library call on the bf16 inputs
        # (cuDNN on the tensor cores; aten's instance norm and its backward);
        # None where no one library call computes the function
        t_l = t_l16 = None
        if c.lib is not None:
            t_l = device_ms(lambda: c.lib(*args))
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
              '(bf16 %.4f, eager call %.4f) plain %.4f library %s (bf16 '
              '%s) bound %.4f (%s; bf16 %.4f)' % (
                  c.kernel, c.label, c.count, e32, e16, t_k, t_k16, t_call,
                  t_p, _ms(t_l), _ms(t_l16), b_ms, b_by, b16_ms))
        a = agg.setdefault(c.kernel, dict(
            max_abs_err=0.0, ms=0.0, ms_bf16=0.0, plain_ms=0.0,
            library_ms=0.0, library_ms_bf16=0.0, bound_ms=0.0,
            bound_ms_cuda_core=0.0, bound_ms_bf16=0.0, flops=0.0, bytes=0.0,
            bytes16=0.0, sites=0, peak_flops=peak))
        a['max_abs_err'] = max(a['max_abs_err'], e32)
        if t_l is None:
            a['library_ms'] = a['library_ms_bf16'] = None
        for k, v in (('ms', t_k), ('ms_bf16', t_k16), ('plain_ms', t_p),
                     ('library_ms', t_l), ('library_ms_bf16', t_l16),
                     ('bound_ms', b_ms), ('bound_ms_cuda_core', b_cc),
                     ('bound_ms_bf16', b16_ms), ('flops', c.flops),
                     ('bytes', c.nbytes), ('bytes16', c.nbytes16)):
            if a[k] is not None and v is not None:
                a[k] += v * c.count
        a['sites'] += c.count
    for name, a in agg.items():
        _, a['bound_by'] = bound_ms(a['flops'], a['bytes'], a['peak_flops'])
        print('  %-17s over %d launches: kernel f32 %.4f ms, bf16 %.4f; '
              'library f32 %s, bf16 %s; bound f32 %.4f (%s), bf16 %.4f; '
              'f32 CUDA-core bound %.4f' % (
                  name, a['sites'], a['ms'], a['ms_bf16'],
                  _ms(a['library_ms']), _ms(a['library_ms_bf16']),
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
    against fake in the D losses).  Where the limits take it (bf16), the
    phase also runs the CPU step with every weight scaled by 1 + 1e-6 N(0,
    1), a few f32 ulps (in bf16 it flips the rounding of the weights that
    lie that close to a bf16 boundary), and prints how far that moves each
    gradient: the noise floor.  The f32 steps' limits do not take it, so
    they skip that second CPU step (~20 s each)."""
    bf16 = dtype == 'bfloat16'
    tag = '_ref%s%s%s' % ('_gated' if gate else '', '_bf16' if bf16 else '',
                          '_no_pallas' if no_pallas else '')
    with region_gate(gate):
        return _reference_step(REGION_BIASES if gate else (), tag, dtype,
                               loss_tol=1e-2 if bf16 else 1e-3,
                               grad_tol=5e-2, floor_factor=2 if bf16 else 0,
                               card_flags=['--no_pallas'] if no_pallas
                               else [])


def _dsgan_draws(model):
    """The DSGAN step's noises, the same on every model: drawn once on the
    CPU from seed 11, on the model's device."""
    gen = torch.Generator().manual_seed(11)
    noises = {k: torch.randn(v, generator=gen)
              for k, v in model._noise_shapes().items()}
    model.draw_noises = lambda: {k: v.to(model.device)
                                 for k, v in noises.items()}


# what _reference_step needs of a recipe: its flags and run name, the flags
# that take out its pools and dropout, a hook that gives every model the
# same draws, and its step in parts (models/twostage_cycle.py)
Recipe = collections.namedtuple('Recipe', 'flags name extra draws parts')
DSGAN_RECIPE = Recipe(TRAIN_FLAGS, TRAIN_NAME, ['--pool_size', '0',
                                                '--no_dropout2'],
                      _dsgan_draws, lambda m, d_from=None:
                      _step_in_parts(m, d_from))


def _reference_step(noise_only, tag, dtype, loss_tol, grad_tol,
                    floor_factor, card_flags, recipe=DSGAN_RECIPE,
                    batch=None):
    extra = ['--compute_dtype', dtype] + recipe.extra
    # the CPU models, built after the card's step, turn the kernels back on
    card = create_model(TrainOptions().parse(
        recipe.flags + ON_CARD + extra + card_flags
        + ['--name', recipe.name + tag]))
    recipe.draws(card)
    if batch is None:
        batch = fixed_batch(seed=5)
    weights = {label: {k: v.cpu().clone()
                        for k, v in net.state_dict().items()}
               for label, net in card.nets().items()}

    def cpu_model(tag):
        m = create_model(TrainOptions().parse(recipe.flags + extra + [
            '--gpu_ids', '-1', '--name', recipe.name + tag]))
        for label, net in m.nets().items():
            net.load_state_dict(weights[label])
        recipe.draws(m)
        m.set_input(batch)
        return m

    card.set_input(batch)
    K.reset_launch_counts()
    t = time.perf_counter()
    m_card = recipe.parts(card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    card_launches = K.launch_counts()
    check(not card_flags or not any(card_launches.values()),
          'reference step %s: the library route launched %s'
          % (card_flags, card_launches))
    cpu = cpu_model(tag + '_cpu')
    t = time.perf_counter()
    m_cpu = recipe.parts(cpu, d_from=card)
    cpu_s = time.perf_counter() - t
    worst_metric = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                       for k in m_cpu)
    worst = _grad_diffs(card, cpu, noise_only)
    # the noise floor, where the limits take it; else not measured (0)
    floor = {n: 0.0 for _, _, n in worst}
    if floor_factor:
        noisy = cpu_model(tag + '_cpu_noisy')
        pg = torch.Generator().manual_seed(12)
        with torch.no_grad():
            for net in noisy.nets().values():
                for p in net.parameters():
                    p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=pg))
        recipe.parts(noisy, d_from=card)
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
    if floor_factor:
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
               held=held, limits_by_floor=by_noise, params=len(worst),
               floor_measured=bool(floor_factor))
    del card, cpu
    torch.cuda.empty_cache()
    return out


# The bench entry point's arms, run in turns: (name, flags after its
# DSGAN_ARGS).  Its command line runs 3 windows of 30 steps in chunks of 10
# and a 12-step trace; here the windows are BENCH_WINDOW_STEPS steps in
# chunks of BENCH_CHUNK and the trace BENCH_TRACE_STEPS, which keeps this
# script inside its time limit (14 bench runs over the paths; with 10-step
# windows the script took over 1100 s of its 1200 on a slow host, and two
# windows a run, not three, make room for the spatial-mesh phase).
BENCH_ARMS = (('kernels bf16', []),
              ('no_pallas bf16', ['--no_pallas']),
              ('no_pallas f32', ['--no_pallas', '--compute_dtype', 'float32']),
              ('kernels f32', ['--compute_dtype', 'float32']))
BENCH_WINDOWS = 2
BENCH_WINDOW_STEPS = 5
BENCH_CHUNK = 5
BENCH_TRACE_STEPS = 4
BENCH_DEVICE_FIELDS = ('device_ms_per_step', 'device_kernels_per_step',
                       'busy_share', 'host_gap_ms', 'device_rate_img_s',
                       'device', 'trace_primer_records_lost', 'chunked_img_s',
                       'chunked_device_ms_per_step',
                       'chunked_device_kernels_per_step',
                       'chunked_busy_share', 'graph_kernels',
                       'chunked_kernels_outside_graph_per_step')


def _bench_arm(name, run, kernels, per_step):
    """One bench record, ``run()`` printing it, held as phase_bench holds
    its arms; ``per_step``: the wrappers' launches a step on the kernels'
    route."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = run()
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
        per_step if kernels else {}, 1).items()}
    check(rec['launches_per_step'] == want, 'bench %s: launches a step '
          '%s, expected %s' % (name, rec['launches_per_step'], want))
    return rec


def phase_bench():
    """supervised_gan_tpu_torch.bench.main on each arm in turn, its record
    printed as a line.  Checked (_bench_arm): finite losses, value > 0,
    BENCH_WINDOWS windows each way (per step and chunked), every device field set
    (bench.main fails when a launch lost its device record), the gates, the
    wrappers' launches a step: the train phase's on the kernels' route (0
    for the region's two), every one 0 under --no_pallas; and the chunked
    step's traced device kernels a step, and its graph's kernel nodes, equal
    to the eager step's: the graph runs every kernel of the step."""
    return _bench_arms(BENCH_ARMS, bench.main, LAUNCHES_PER_STEP)


def _bench_arms(arms, bench_fn, per_step):
    """``bench_fn(flags, **windows)`` on each arm in turn, each record held
    by _bench_arm, with ``per_step`` launches a step on the kernels'
    route."""
    out = {}
    for name, flags in arms:
        out[name] = _bench_arm(
            name, lambda flags=flags, name=name: bench_fn(
                flags + ['--checkpoints_dir', CKPT_DIR, '--name',
                         '%s_bench_%s' % (NAME, name.replace(' ', '_'))],
                windows=BENCH_WINDOWS, window_steps=BENCH_WINDOW_STEPS,
                chunk=BENCH_CHUNK, trace_steps=BENCH_TRACE_STEPS),
            '--no_pallas' not in flags, per_step)
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
# The least spread of the whole state and of its worst tensor after the
# default-algorithm step.  Its f32 eager runs do not spread evenly: G2's
# update reads D2 as this step updated it, and where D2's float32 rounding
# moves an activation across a LeakyReLU's kink, G2's gradient takes the
# other slope there.  So two eager runs land apart by one of a few discrete
# distances (whole 3.4e-9, 1.4e-7, 2.9e-7, 3.2e-7 or 5.03e-6, only G2 and
# its Adam moments beyond 3.4e-9), and three runs often miss the largest:
# in 8 rounds of 4 eager runs on an H100 (scripts/chunk_spread.py), an
# eager run held in the chunked run's place failed twice the other three's
# spread in 5 of 32 cases.  The largest pair seen there (whole 5.034e-6,
# worst tensor 4.847e-3, f32; bf16 pairs 7.8e-6 to 8.5e-6, 9.2e-3) is the
# floor; the factor of 2 stays above it.
SPREAD_FLOOR = {'whole': 5.1e-6, 'worst': 4.9e-3}


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


def _state_group(name):
    """The net, optimizer or pool a _model_state tensor belongs to: 'D1_0',
    'adam.G', 'pool.fake_B'."""
    parts = name.split('.')
    return '.'.join(parts[:2]) if parts[0] in ('adam', 'pool') else parts[0]


def _state_diff(a, b):
    """Two _model_state results apart: the largest relative L2 difference of
    a tensor and its name, the tensors that differ at all, the relative L2
    difference of the whole state and of each group (_state_group) that
    differs, and each loss's absolute difference."""
    (ta, la), (tb, lb) = a, b
    check(ta.keys() == tb.keys(), 'chunked state: keys differ')
    worst, name, differ = 0.0, None, 0
    sums = collections.defaultdict(lambda: [0.0, 0.0])
    for k in ta:
        x, y = ta[k].double(), tb[k].double()
        d, n = float((x - y).norm()), float(x.norm())
        for g in (None, _state_group(k)):
            sums[g][0] += d * d
            sums[g][1] += n * n
        if d:
            differ += 1
            rel = d / max(n, 1e-30)
            if rel > worst:
                worst, name = rel, k
    rel = {g: (num / max(den, 1e-300)) ** 0.5
           for g, (num, den) in sums.items()}
    return dict(worst=worst, name=name, differ=differ, whole=rel.pop(None),
                groups={g: v for g, v in sorted(rel.items()) if v},
                losses={k: abs(la[k] - lb[k]) for k in la})


def _train_model(dtype, label):
    return create_model(train_opt([
        '--compute_dtype', dtype, '--name',
        '%s_chunk_%s' % (TRAIN_NAME, label)]))


def _eager_steps(model, batches):
    for b in batches:
        model.set_input(b)
        model.optimize_parameters()


def _chunk_runs_deterministic(dtype, make=_train_model):
    """Under torch.use_deterministic_algorithms (warn only), the states
    after CHUNK_STEPS steps of three models from one seed and one state
    (``make(dtype, label)``; by default the bench configuration, pools and
    dropout on): A and A2 by eager steps on the same batches, B by one
    train_chunk of them (two eager steps, then its capture and two
    replays)."""
    batches = [fixed_batch(seed=10 + i) for i in range(CHUNK_STEPS)]
    states = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label in ('A', 'A2', 'B'):
            model = make(dtype, label)
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


def _default_limits(pairs, losses, floor=SPREAD_FLOOR):
    """Twice the largest of the eager pairs (_state_diff results): the whole
    state's and the worst tensor's relative L2, at least ``floor``, and each
    loss's difference, the terms of LOSSES_AFTER_D_UPDATE at least
    ULPS_AFTER_D_UPDATE units in the last place of their float32 value
    (``losses``)."""
    limits = {m: 2 * max([p[m] for p in pairs.values()] + [floor.get(m, 0)])
              for m in ('whole', 'worst')}
    for k, v in losses.items():
        s = max(p['losses'][k] for p in pairs.values())
        if k in LOSSES_AFTER_D_UPDATE:
            s = max(s, ULPS_AFTER_D_UPDATE
                    * float(np.spacing(np.float32(abs(v)))))
        limits[k] = 2 * s
    return limits


def _over_limits(diff, limits):
    """The measures of one _state_diff result beyond ``limits``."""
    over = [m for m in ('whole', 'worst') if diff[m] > limits[m]]
    return over + [k for k, v in diff['losses'].items() if v > limits[k]]


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
    least ULPS_AFTER_D_UPDATE units in its last place.  For the same reason
    the state's eager runs land apart by a few discrete distances, which
    three runs often miss, so its spread is at least SPREAD_FLOOR."""
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
    limits = _default_limits(pairs, default['losses'])
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
        over = _over_limits(c, limits)
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


# --------------------- SGAN step 2 (cgan) and the segmentation gate -- #

CGAN_NAME = 'chip_smoke_cgan'
SEG_NAME = 'chip_smoke_seg'
SEG_DATA = os.path.join(RESULTS_DIR, 'seg_data')
SEG_SPLITS = (('train', 4), ('val', 2), ('test', 4))


def _with(args, **values):
    """``args`` with the value of each --flag named in ``values``
    replaced."""
    out = list(args)
    for flag, value in values.items():
        out[out.index('--' + flag) + 1] = value
    return out


# The cgan step: tools/bench_extra.py:54-68 (the README's SGAN step 2,
# unet_256 ngf 64 with dropout and injected Gaussian noise, a 2-scale D bank
# ndf 64, 512 px, bf16), as supervised_gan_tpu_torch/bench_extra.py copies
# it, on the synthetic 1024^2 set; and its sampler's flags (the architecture
# ones) on the segmentation set's 512^2 test images.
CGAN_FLAGS = _with(bench_extra.CGAN_ARGS, dataroot=DATA_DIR, name=CGAN_NAME,
                   checkpoints_dir=CKPT_DIR)
CGAN_SAMPLER = [
    '--dataroot', SEG_DATA, '--model', 'cgan', '--which_direction', 'AtoB',
    '--dataset_mode', 'single', '--loadSize', '512', '--fineSize', '512',
    '--input_nc', '2', '--output_nc', '1', '--which_model_netG', 'unet_256',
    '--ngf', '64', '--noise_nc', '8', '--noiseSize', '4', '--norm',
    'instance', '--add_gaussian_noise', '--which_channel', 'rg_b',
    '--manualSeed', '0', '--compute_dtype', 'bfloat16', '--checkpoints_dir',
    CKPT_DIR, '--display_id', '0']
# The segmentation gate: tools/quality_eval.py:94-104 (unet_128 with
# dropout, InstanceNorm, b -> the rg classes, no D, RandScore and meanIU)
# at 512 px with ngf 16, the scale of its 512 px run (QUALITY_r04_512.json)
SEG_ARCH = [
    '--dataroot', SEG_DATA, '--name', SEG_NAME, '--model', 'segmentation',
    '--which_direction', 'AtoB', '--dataset_mode', 'single',
    '--loadSize', '512', '--fineSize', '512', '--batchSize', '1',
    '--which_channel', 'b_rg', '--which_model_netG', 'unet_128',
    '--ngf', '16', '--noise_nc', '4', '--noiseSize', '4', '--norm',
    'instance', '--which_metric', 'RandScore', 'meanIU',
    '--which_model_netD', 'None', '--manualSeed', '0', '--display_id', '0',
    '--checkpoints_dir', CKPT_DIR]
SEG_TRAIN = ['--lambda_A', '1', '--cache_data']
SEG_BENCH = ['--lambda_A', '1']     # bench.main feeds a fixed batch

# Kernel launches of one cgan step (n_update_D 1, n_update_G 2), from the
# networks' structure.  G (unet_256) runs 3 times (the first forward, then
# one recorded after each G update, the last without a graph): 8 conv4s2
# (the stem sees the label), 8 convt4s2 and 13 IN each.  The D bank
# (n_layers 3 and 4, both at scale 1) has 7 conv4s2 (2 stems) and 7 IN; the
# D update runs it on the pooled fake and on the real pair (detached: no
# stem dx, every dW), each G update once (D held fixed: every dx).  Each G
# update backpropagates through its recorded G: the dx of its 7 conv4s2 past
# the stem (convt4s2) and of its 8 convt4s2 (conv4s2).  Every IN forward
# with a gradient has its backward.
G256_DOWN, G256_UP, G256_IN = 8, 8, 13
CG_D_CONV, CG_D_STEMS, CG_G_RUNS, CG_G_UPDATES = 7, 2, 3, 2
CGAN_PER_STEP = {
    'conv4s2': (CG_G_RUNS * G256_DOWN + (2 + CG_G_UPDATES) * CG_D_CONV
                + CG_G_UPDATES * G256_UP),
    'convt4s2': (CG_G_RUNS * G256_UP + 2 * (CG_D_CONV - CG_D_STEMS)
                 + CG_G_UPDATES * CG_D_CONV
                 + CG_G_UPDATES * (G256_DOWN - 1)),
    'instance_norm_act': CG_G_RUNS * G256_IN + (2 + CG_G_UPDATES) * CG_D_CONV,
    'instance_norm_bwd': (2 + CG_G_UPDATES) * CG_D_CONV
                         + CG_G_UPDATES * G256_IN,
}
CGAN_PER_SAMPLE = {'conv4s2': G256_DOWN, 'convt4s2': G256_UP,
                   'instance_norm_act': G256_IN}
# one segmentation step (no D, n_update_G 1): its unet_128, F2's structure,
# forward and backward (no dx of the stem); a val or test forward: once
SEG_PER_STEP = {'conv4s2': F2_DOWN + F2_UP, 'convt4s2': F2_UP + F2_DOWN - 1,
                'instance_norm_act': F2_IN, 'instance_norm_bwd': F2_IN}
SEG_PER_FORWARD = {'conv4s2': F2_DOWN, 'convt4s2': F2_UP,
                   'instance_norm_act': F2_IN}
NEW_KINDS = ('conv4s2', 'ConvT4s2', 'conv4s2_dx', 'InstanceNormAct',
             'instance_norm_bwd', 'Conv3x3', 'conv3x3_dx', 'conv3x3_dw')


def _plus(*counts):
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


def write_seg_set():
    """SEG_SPLITS 512^2 RGB PNGs: a foreground of random discs in R, its
    complement in G, an image in B that shows the foreground through
    noise."""
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[:512, :512]
    for split, n in SEG_SPLITS:
        d = os.path.join(SEG_DATA, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            fg = np.zeros((512, 512), bool)
            for _ in range(24):
                cy, cx = rng.randint(0, 512, 2)
                fg |= (yy - cy) ** 2 + (xx - cx) ** 2 < rng.randint(8, 40) ** 2
            a = np.zeros((512, 512, 3), np.uint8)
            a[..., 0] = fg * 255
            a[..., 1] = 255 - a[..., 0]
            a[..., 2] = np.clip(80 + 100 * fg + rng.normal(0, 30, fg.shape),
                                0, 255)
            Image.fromarray(a).save(os.path.join(d, '%03d.png' % i))


def record_step_sites(run):
    """``run()`` with the kernel wrappers and Functions wrapped to count
    their calls by signature: conv4s2 (forward and as convt4s2's dx), the
    ConvT4s2 forwards, convt4s2's launches as conv4s2's dx (those outside a
    ConvT4s2 forward), InstanceNormAct, instance_norm_bwd, the Conv3x3
    forwards, conv3x3's dx and conv3x3_dw; as record_train_sites keys
    them."""
    books = {k: collections.Counter() for k in NEW_KINDS}
    saved, in_convt = [], []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    patch(functions, 'conv4s2', _recorder(
        K.conv4s2, lambda x, w, b=None: (_shape(x), _shape(w), b is not None),
        books['conv4s2']))
    patch(functions, 'instance_norm_bwd', _recorder(
        K.instance_norm_bwd, lambda x, g, m, r, slope=None: (_shape(x), slope),
        books['instance_norm_bwd']))

    def convt4s2(x, w, b=None):
        if not in_convt:
            books['conv4s2_dx'][(_shape(x), _shape(w))] += 1
        return K.convt4s2(x, w, b)
    patch(functions, 'convt4s2', convt4s2)

    class ConvT:
        @staticmethod
        def apply(x, w, b):
            books['ConvT4s2'][(_shape(x), _shape(w), b is not None)] += 1
            in_convt.append(True)
            try:
                return K.ConvT4s2.apply(x, w, b)
            finally:
                in_convt.pop()

    class INAct:
        @staticmethod
        def apply(x, eps, slope):
            books['InstanceNormAct'][(_shape(x), slope)] += 1
            return K.InstanceNormAct.apply(x, eps, slope)

    patch(ops_conv, 'ConvT4s2', ConvT)
    patch(ops_norm, 'InstanceNormAct', INAct)
    patch(functions, 'conv3x3_dw', _recorder(
        K.conv3x3_dw, lambda x, g: (_shape(x), g.shape[1]),
        books['conv3x3_dw']))
    patch(functions, '_conv3x3_dx', _recorder(
        functions._conv3x3_dx, lambda g, w: (_shape(g), _shape(w)),
        books['conv3x3_dx']))

    class Conv3:
        @staticmethod
        def apply(x, w, b):
            books['Conv3x3'][(_shape(x), _shape(w), b is not None)] += 1
            return K.Conv3x3.apply(x, w, b)
    patch(ops_conv, 'Conv3x3', Conv3)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
    return books


def _in_key(kv):
    return (kv[0][0], str(kv[0][1]))


def _sites_got(b):
    """A record_step_sites book's calls by wrapper, as the launch counts
    name them."""
    return {'conv4s2': sum(b['conv4s2'].values()),
            'convt4s2': sum(b['ConvT4s2'].values())
            + sum(b['conv4s2_dx'].values()),
            'instance_norm_act': sum(b['InstanceNormAct'].values()),
            'instance_norm_bwd': sum(b['instance_norm_bwd'].values()),
            'conv3x3': sum(b['Conv3x3'].values())
            + sum(b['conv3x3_dx'].values()),
            'conv3x3_dw': sum(b['conv3x3_dw'].values())}


def report_sites(paths, want_of, known):
    """Each path's recorded calls (``paths``: record_step_sites books)
    against ``want_of[path]``, the launches written from the nets'
    structure; then the sites no book of ``known`` has, printed, each conv
    site with its tc_plan checked (the kernel's split and route) and each
    IN shape with its in_plan (both dtypes and directions).  Returns those
    sites' books in train_cases' keys."""
    width = max(len(p) for p in paths)
    for path, b in paths.items():
        got = _sites_got(b)
        want = {k: want_of[path].get(k, 0) for k in got}
        check(got == want, '%s: recorded calls %s, expected %s'
              % (path, got, want))
        print('  %-*s calls %s' % (width, path, got))
    new = {k: collections.Counter() for k in NEW_KINDS}
    for b in paths.values():
        for kind in NEW_KINDS:
            for key, c in b[kind].items():
                if not any(key in k[kind] for k in known):
                    new[kind][key] += c
    for (xs, ws, has_b), c in sorted(new['Conv3x3'].items()):
        print('  new site conv3x3      %d->%d @%dx%d%s x%d' % (
            xs[1], ws[0], xs[2], xs[3], ' +b' if has_b else '', c))
    for (gs, ws), c in sorted(new['conv3x3_dx'].items()):
        print('  new site conv3x3 dx   %d->%d @%dx%d x%d' % (
            gs[1], ws[1], gs[2], gs[3], c))
    for (xs, co), c in sorted(new['conv3x3_dw'].items()):
        check_dw_plan(xs[0], xs[1], co, xs[2], xs[3])
        print('  new site conv3x3_dw   %d->%d @%dx%d x%d' % (
            xs[1], co, xs[2], xs[3], c))
    for (xs, ws, has_b), c in sorted(new['conv4s2'].items()):
        check_conv4s2_plan(xs[0], xs[1], ws[0], xs[2], xs[3])
        print('  new site conv4s2      %d->%d @%dx%d%s x%d' % (
            xs[1], ws[0], xs[2], xs[3], ' +b' if has_b else '', c))
    for (xs, ws, has_b), c in sorted(new['ConvT4s2'].items()):
        check_convt4s2_plan(xs[0], xs[1], ws[1], xs[2], xs[3])
        print('  new site convt4s2     %d->%d @%dx%d%s x%d' % (
            xs[1], ws[1], xs[2], xs[3], ' +b' if has_b else '', c))
    for (gs, ws), c in sorted(new['conv4s2_dx'].items()):
        check_convt4s2_plan(gs[0], gs[1], ws[1], gs[2], gs[3])
        print('  new site convt4s2 dx  %d->%d @%dx%d x%d' % (
            gs[1], ws[1], gs[2], gs[3], c))
    for kind in ('InstanceNormAct', 'instance_norm_bwd'):
        for (xs, slope), c in sorted(new[kind].items(), key=_in_key):
            print('  new site %-17s %d @%dx%d slope %s x%d' % (
                kind, xs[1], xs[2], xs[3], slope, c))
    for shape in sorted({xs for kind in ('InstanceNormAct',
                                         'instance_norm_bwd')
                         for xs, _ in new[kind]}):
        print('  IN plan %-20s %s' % (shape, _plan_text(
            check_in_plan(*shape))))
    return {'conv3x3_dw': new['conv3x3_dw'], 'conv3x3_dx': new['conv3x3_dx'],
            'Conv3x3': new['Conv3x3'], 'conv4s2': new['conv4s2'],
            'convt4s2_f2': new['ConvT4s2'], 'conv4s2_dx': new['conv4s2_dx'],
            'InstanceNormAct': new['InstanceNormAct'],
            'instance_norm_bwd': new['instance_norm_bwd']}


def phase_new_sites(dsgan_books):
    """The kernel sites of one f32 cgan step (CGAN_FLAGS) and of one
    segmentation step and val forward (SEG_ARCH), recorded as the DSGAN
    step's are; their totals against CGAN_PER_STEP, SEG_PER_STEP and
    SEG_PER_FORWARD; the sites the DSGAN step does not have (the new
    sites), printed, with each one's tc_plan (conv4s2, convt4s2 forward and
    dx: the kernel's split and route) or in_plan (the IN kernels, both
    dtypes and directions) checked against the library.  Returns (the new
    sites' books, counted over one cgan step and one segmentation step and
    forward, in train_cases' keys; the per-path books)."""
    paths = {}
    cg = create_model(TrainOptions().parse(CGAN_FLAGS + ON_CARD + [
        '--compute_dtype', 'float32', '--name', CGAN_NAME + '_sites']))
    cg.set_input(fixed_batch())
    paths['cgan step'] = record_step_sites(cg.optimize_parameters)
    del cg
    seg = create_model(TrainOptions().parse(SEG_ARCH + SEG_TRAIN + ON_CARD + [
        '--name', SEG_NAME + '_sites']))
    seg.set_input(fixed_batch())
    paths['segmentation step'] = record_step_sites(seg.optimize_parameters)
    paths['segmentation forward'] = record_step_sites(
        lambda: seg.forward(val_mode=True))
    del seg
    gc.collect()
    torch.cuda.empty_cache()
    want_of = {'cgan step': CGAN_PER_STEP, 'segmentation step': SEG_PER_STEP,
               'segmentation forward': SEG_PER_FORWARD}
    return report_sites(paths, want_of, [dsgan_books]), paths


def new_site_cases(books):
    """train_cases at the new sites, the generators' transposed-conv
    forwards named convt4s2_fwd, and conv3x3's forwards as sampler_cases
    holds them."""
    cases = [c._replace(kernel='convt4s2_fwd') if c.kernel == 'convt4s2_f2'
             else c for c in train_cases(books)]
    for (xs, ws, has_b), count in sorted(books['Conv3x3'].items()):
        n, ci, h, w = xs
        co = ws[0]

        def mk(gen, xs=xs, ws=ws, has_b=has_b):
            return (randn(xs, gen), randn(ws, gen, (9 * ws[1]) ** -0.5),
                    randn((ws[0],), gen, 0.1) if has_b else None)
        elems = n * (ci + co) * h * w + co * ci * 9
        cases.append(Case(
            'conv3x3', '%d->%d @%dx%d%s' % (ci, co, h, w,
                                            ' +b' if has_b else ''),
            count, K.conv3x3, K.conv3x3_plain,
            lambda x, w_, b: F.conv2d(x, w_, b, 1, 1),
            2.0 * co * ci * 9 * n * h * w, 4.0 * elems + 4.0 * co * has_b,
            2.0 * elems + 4.0 * co * has_b, mk, within))
    return cases


def cgan_train(dtype, steps):
    """The cgan step's recipe command through the train entry point."""
    name = '%s_%s' % (CGAN_NAME, dtype)
    return run_train(
        CGAN_FLAGS + ON_CARD + _epoch_flags(name, dtype, steps)
        + ['--display_freq', str(steps), '--save_epoch_freq', '1'],
        name, steps, CGAN_PER_STEP, ('G', 'D_0', 'D_1'))


CGAN_CHUNK, CGAN_CHUNK_EPOCHS = 10, 2


def cgan_chunked_train(extra=(), name=CGAN_NAME + '_chunked'):
    """The train entry point with --steps_per_dispatch 10, bf16, two epochs
    of the 8 synthetic images, no print or save inside: one chunk an epoch
    (flushed at its last batch), the first two steps eager, then the
    capture and replays.  The wrappers see the eager steps and the capture,
    no replay: 3 steps' launches.  The second chunk is all replays: its wall
    time a step (from its first batch's arrival, so it waits on the loader
    for the rest).  ``extra``: flags after the command's."""
    buf = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        r = trainer.main(CGAN_FLAGS + ON_CARD + list(extra) + [
            '--compute_dtype', 'bfloat16', '--name', name,
            '--niter', str(CGAN_CHUNK_EPOCHS), '--niter_decay', '0',
            '--max_dataset_size', str(TRAIN_IMAGES), '--print_freq', '100',
            '--display_freq', '100', '--save_epoch_freq', '100',
            '--steps_per_dispatch', str(CGAN_CHUNK)])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(r['steps'] == CGAN_CHUNK_EPOCHS * TRAIN_IMAGES
          and r['chunks'] == [TRAIN_IMAGES] * CGAN_CHUNK_EPOCHS,
          'cgan chunked: %d steps in chunks %s' % (r['steps'], r['chunks']))
    want = expected(CGAN_PER_STEP, CAPTURE_AFTER + 1)
    check(counts == want, 'cgan chunked: launches %s, expected %s (the eager '
          'steps and the capture)' % (counts, want))
    replay_ms = 1e3 * r['step_seconds'][-1] / TRAIN_IMAGES
    print('  chunks %s, wall a chunk %s ms, %.2f ms a replayed step; wrapper '
          'launches %s' % (r['chunks'], ['%.1f' % (1e3 * t)
                                        for t in r['step_seconds']],
                           replay_ms, counts))
    return dict(chunks=r['chunks'], step_seconds=r['step_seconds'],
                replay_ms_per_step=replay_ms, launches=counts)


def phase_cgan_sampler(trained, samples=4, flags=CGAN_SAMPLER,
                       label='cgan', per_sample=CGAN_PER_SAMPLE):
    """The conditional sampler entry point on a trained run of a cgan
    recipe (``flags``: its architecture; the generator from the label,
    ``per_sample`` launches a sample) over the segmentation set's test
    images (bf16): launch counts, finite outputs, real_A and fake_B
    written per input, images/s."""
    d = os.path.join(RESULTS_DIR, label + '_sampler')
    K.reset_launch_counts()
    r = sampler.main(flags + ON_CARD + [
        '--name', trained, '--how_many', str(samples), '--results_dir', d])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(counts == expected(per_sample, samples),
          '%s sampler: launches %s, expected %s' % (
              label, counts, expected(per_sample, samples)))
    check(r['samples'] == samples and r['nonfinite'] == 0,
          '%s sampler: %d samples, %d non-finite' % (
              label, r['samples'], r['nonfinite']))
    names = sorted(os.listdir(os.path.join(r['web_dir'], 'images')))
    want = sorted('%03d_%s.png' % (i, v) for i in range(samples)
                  for v in ('real_A', 'fake_B'))
    check(names == want, '%s sampler: images %s' % (label, names))
    out = dict(samples=samples, launches=counts,
               images_per_second=samples / r['loop_seconds'],
               drawing_images_per_second=samples / r['sample_seconds'],
               loop_seconds=r['loop_seconds'],
               sample_seconds=r['sample_seconds'])
    print('  %d samples in %.3f s = %.3f images/s (drawing alone %.3f '
          'images/s); launches %s' % (
              samples, r['loop_seconds'], out['images_per_second'],
              out['drawing_images_per_second'], counts))
    return out


def _gauss_draws(model):
    """Every GaussianNoise of every G draws from one CPU generator of seed
    13, on the model's device: the same draws, call by call, on every
    model."""
    gen = torch.Generator().manual_seed(13)

    def draw(shape, dtype, device):
        return torch.randn(shape, generator=gen).to(device=device,
                                                     dtype=dtype)
    for net in model.nets().values():
        for m in net.modules():
            if isinstance(m, tnn.GaussianNoise):
                m.draw = draw


def _d_g_step_in_parts(model, d_from=None):
    """One iteration's first G update of a recipe with a D update and a G
    update (update_D / update_D2, update_G): the recorded forward, the D
    update, then (with ``d_from``, every D bank taking d_from's parameters)
    the G update.  Returns the loss terms."""
    taps = model._record()
    update_d = getattr(model, 'update_D2', None) or model.update_D
    d = update_d(taps)
    if d_from is not None:
        with torch.no_grad():
            for label, net in model.nets().items():
                if label.startswith('D'):
                    for p, q in zip(net.parameters(),
                                    d_from.nets()[label].parameters()):
                        p.copy_(q)
    g = model.update_G(taps)
    out = {}
    for side, v in (('D', d), ('G', g)):
        if isinstance(v, dict):
            out.update({k: float(x) for k, x in v.items()})
        elif isinstance(v, tuple):
            out.update({'%s%d' % (side, i): float(x)
                        for i, x in enumerate(v)})
        elif v is not None:
            out[side] = float(v)
    return out


CGAN_RECIPE = Recipe(CGAN_FLAGS, CGAN_NAME, ['--pool_size', '0',
                                             '--no_dropout'],
                     _gauss_draws, _d_g_step_in_parts)


def phase_cgan_reference_step():
    """One f32 cgan iteration (its D update and first G update) at 512 px on
    the card through the kernels and on the CPU through the plain versions,
    as phase_reference_step holds the DSGAN step: same weights, batch and
    Gaussian draws, no pool, no dropout; each loss term within 1e-3
    relative, each gradient within the larger of 5e-2 and twice its noise
    floor relative in L2."""
    return _reference_step((), '_ref', 'float32', loss_tol=1e-3,
                           grad_tol=5e-2, floor_factor=2, card_flags=[],
                           recipe=CGAN_RECIPE)


def phase_cgan_chunk_equals_eager(dtype='bfloat16'):
    """CHUNK_STEPS cgan steps (pools, dropout and the Gaussian noise on),
    train_chunk against eager steps under deterministic algorithms: every
    parameter, Adam moment and step, the pool's images and the last losses
    bitwise equal (_chunk_runs_deterministic)."""
    det = _chunk_runs_deterministic(dtype, make=lambda dt, label: create_model(
        TrainOptions().parse(CGAN_FLAGS + ON_CARD + [
            '--compute_dtype', dt, '--name',
            '%s_chunk_%s' % (CGAN_NAME, label)])))
    spread, chunked = det['eager_spread'], det['chunked']
    check(spread['differ'] == 0 and not any(spread['losses'].values()),
          'deterministic eager cgan %s runs differ (%s)' % (dtype,
                                                             spread['name']))
    check(chunked['differ'] == 0 and not any(chunked['losses'].values()),
          'chunked cgan %s differs from eager under deterministic algorithms '
          '(%d tensors, worst %s, losses %s)' % (
              dtype, chunked['differ'], chunked['name'], chunked['losses']))
    return dict(det, dtype=dtype, steps=CHUNK_STEPS)


CGAN_BENCH_ARMS = (('cgan kernels bf16', []),
                   ('cgan no_pallas bf16', ['--no_pallas']))
SEG_BENCH_ARMS = (('segmentation kernels f32', []),
                  ('segmentation no_pallas f32', ['--no_pallas']))


def phase_cgan_bench():
    """supervised_gan_tpu_torch.bench_extra's cgan_pix2pix_512 on each
    route."""
    return _bench_arms(CGAN_BENCH_ARMS, lambda flags, **kw: bench_extra.run(
        'cgan_pix2pix_512', flags, **kw), CGAN_PER_STEP)


def phase_seg_bench():
    """The segmentation step (SEG_ARCH, f32) through bench.main on each
    route: per step and chunked rates, device time and busy share."""
    return _bench_arms(SEG_BENCH_ARMS, lambda flags, **kw: bench.main(
        flags, base=SEG_ARCH + SEG_BENCH, metric_name='segmentation_unet128',
        **kw), SEG_PER_STEP)


def _accs_in_range(accs, what):
    check(set(accs) == {'RandScore', 'meanIU'} and all(
        np.isfinite(v) and 0 <= v <= 1 for v in accs.values()),
        '%s: accuracies %s' % (what, accs))


def phase_segmentation():
    """train_ss at SEG_ARCH for one epoch of the 4 training images with
    validation on the 2 val images and the best meanIU checkpoint, then
    test_ss on it over the 4 test images: launch counts (4 steps and 2
    forwards; 4 forwards), RandScore and meanIU finite and within [0, 1],
    the cross entropy finite; the train step's median wall time (a step up
    to its metrics on the host) and test_ss's images/s."""
    K.reset_launch_counts()
    r = train_ss.main(SEG_ARCH + SEG_TRAIN + ON_CARD + [
        '--niter', '1', '--niter_decay', '0', '--print_freq', '1',
        '--display_freq', '100', '--save_epoch_freq', '1',
        '--best_metric', 'meanIU'])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    n_train, n_val = SEG_SPLITS[0][1], SEG_SPLITS[1][1]
    want = expected(_plus(*[SEG_PER_STEP] * n_train
                          + [SEG_PER_FORWARD] * n_val), 1)
    check(counts == want, 'train_ss: launches %s, expected %s'
          % (counts, want))
    check(r['steps'] == n_train and len(r['val_accs']) == 1,
          'train_ss: %d steps, val %s' % (r['steps'], r['val_accs']))
    _accs_in_range(r['val_accs'][0], 'train_ss val')
    run_dir = os.path.join(CKPT_DIR, SEG_NAME)
    check({'best_net_G.pth', 'latest_net_G.pth', '1_net_G.pth'}
          <= set(os.listdir(run_dir)), 'train_ss: checkpoints missing')
    step_ms = [1e3 * t for t in r['step_seconds']]
    K.reset_launch_counts()
    t = test_ss.main(SEG_ARCH + ON_CARD + [
        '--which_epoch', 'best', '--results_dir',
        os.path.join(RESULTS_DIR, 'seg_test')])
    torch.cuda.synchronize()
    test_counts = K.launch_counts()
    n_test = SEG_SPLITS[2][1]
    check(test_counts == expected(SEG_PER_FORWARD, n_test),
          'test_ss: launches %s, expected %s' % (
              test_counts, expected(SEG_PER_FORWARD, n_test)))
    check(t['images'] == n_test and np.isfinite(t['ce_mean']),
          'test_ss: %d images, cross entropy %s' % (t['images'],
                                                     t['ce_mean']))
    _accs_in_range(t['accs'], 'test_ss')
    out = dict(train_steps=r['steps'], train_step_ms=step_ms,
               median_train_step_ms=statistics.median(step_ms[1:]),
               val_accs=r['val_accs'], best=r['best'], train_launches=counts,
               test_images=t['images'], test_accs=t['accs'],
               ce_mean=t['ce_mean'], ce_std=t['ce_std'],
               test_images_per_second=n_test / t['test_seconds'],
               test_loop_images_per_second=n_test / t['loop_seconds'],
               test_launches=test_counts)
    print('  train_ss: %d steps, first %.1f ms, median of the rest %.1f ms; '
          'val %s; test_ss: %d images, %.3f images/s (%.3f with the images '
          'written), %s, cross entropy %.4f +- %.4f' % (
              r['steps'], step_ms[0], out['median_train_step_ms'],
              r['val_accs'][0], n_test, out['test_images_per_second'],
              out['test_loop_images_per_second'], t['accs'], t['ce_mean'],
              t['ce_std']))
    return out

# ----------- the rest of the two-stage family and latent inversion -- #

TS_NAME = 'chip_smoke_ts'
# the README command's flags that only F2 (the cycle) reads
F2_ONLY = ('--which_model_netF2', '--nff2', '--lambda_B', '--lambda_A_cycle',
           '--lambda_fake_cycle')
PAIRS = ['--GAN_losses_D2', 'real_fake', 'fake_fake',
         '--GAN_losses_G2', 'real_fake', 'fake_fake']
# the three runs of the DSGAN's training options, each on the bench
# configuration: (a) the 3-class D2, (b) the fake_fake pairs with the
# fixed-noise pool, (c) D2 on the image alone
FLAG_RUNS = (('multi_class', ['--use_multi_class_GAN']),
             ('pairs_fixed_noise', PAIRS + ['--use_fixed_noise1']),
             ('no_cgan', ['--no_cgan']))
# Launches a step (n_update 1, the README's real_fake pairs; the runs (a)
# and (b) add one D2 pass in its update, (b) one in the G update too).
# twostage: G1 once, G2 twice, no F2; G2 on the fake label feeds no loss.
# twostage_factd: D2's loss takes D1_i x D2_i at the 2 paired scales, so
# D2_2 and D2_3 never run; D1's bank runs without a graph in each of those
# predictions in the D2 update (on the pooled fake and the real pair), and
# in the G update's real_fake term (its label part is the real label): a
# forward each, no backward.  The two paired Ds (n_layers 3 and 4) hold 7
# k4 s2 convs, 2 of them stems, and 7 IN.
FD2_CONV, FD2_STEMS = 7, 2
TS_PER_STEP = {
    'twostage': two_stage_per_step(f2=False),
    'twostage_factd': {
        'conv3x3': 2 * G2_CONV3 + (G2_CONV3 - G2_LABEL_SIDE),
        'conv3x3_dw': G2_CONV3,
        'instance_norm_act': (2 * G2_IN + 2 * D1_CONV
                              + 2 * (D1_CONV + FD2_CONV) + D1_CONV
                              + (D1_CONV + FD2_CONV)),
        'instance_norm_bwd': (G2_IN + 2 * D1_CONV + 2 * FD2_CONV + D1_CONV
                              + FD2_CONV),
        'conv4s2': (2 * D1_CONV + 2 * (D1_CONV + FD2_CONV) + D1_CONV
                    + (D1_CONV + FD2_CONV) + (G1_CONVT - 1)),
        'convt4s2': (G1_CONVT + 2 * (D1_CONV - D1_STEMS)
                     + 2 * (FD2_CONV - FD2_STEMS) + D1_CONV + FD2_CONV)},
    'multi_class': two_stage_per_step(d2_fakes=2),
    'pairs_fixed_noise': two_stage_per_step(d2_fakes=2, g2_pairs=2),
    'no_cgan': two_stage_per_step()}
# latent inversion, stage 1's G (6 transposed convs, BatchNorm): each
# evaluation of the objective runs G forward; with a gradient, each
# transposed conv's dx too (the noise is the variable: the first one's as
# well), and no dW (G is frozen)
RECON_PER_EVAL = {'convt4s2': G1_CONVT}
RECON_PER_GRAD_EVAL = {'convt4s2': G1_CONVT, 'conv4s2': G1_CONVT}
TS_STEPS, TS_CHUNK = 2, 4
RECON_IMAGES = 2


def _without(args, *flags):
    """``args`` without each --flag in ``flags`` and its values."""
    out, keep = [], True
    for a in args:
        if a.startswith('--'):
            keep = a not in flags
        if keep:
            out.append(a)
    return out


def ts_args(model, name, dtype, steps):
    """The README DSGAN command (readme_args) with --model ``model`` and
    F2's flags dropped: the same G1, G2, D1 and D2, stage 1's G1 and D1
    loaded."""
    args = _without(readme_args(name, dtype, steps), *F2_ONLY)
    args[args.index('--model') + 1] = model
    return args


def path_args(path, name, dtype, steps):
    """The command of a path of this phase: the README's for twostage and
    twostage_factd, the bench configuration with its flags for a flag
    run."""
    if path in ('twostage', 'twostage_factd'):
        return ts_args(path, name, dtype, steps)
    return (TRAIN_FLAGS + dict(FLAG_RUNS)[path] + ON_CARD
            + _epoch_flags(name, dtype, steps))


def phase_ts_sites(dsgan_books, stage1_name):
    """The kernel sites of one f32 step of each path (recorded as
    record_step_sites does) and of one evaluation of the inversion's
    objective with its gradient (stage 1's G at 512 px), their totals
    against TS_PER_STEP and RECON_PER_GRAD_EVAL, and the sites the DSGAN
    step does not have, printed, each with its plan checked.  Returns (the
    new sites' books, in train_cases' keys; the per-path books)."""
    paths = {}
    for path in TS_PER_STEP:
        m = create_model(TrainOptions().parse(path_args(
            path, '%s_%s_sites' % (TS_NAME, path), 'float32', 1)))
        m.set_input(fixed_batch())
        paths[path] = record_step_sites(m.optimize_parameters)
        del m
        gc.collect()
    g = create_model(TestOptions().parse(recon_args(stage1_name)))
    g.set_input(fixed_batch())
    z = torch.randn(g._noise_shape(), device=DEV,
                    generator=torch.Generator(DEV).manual_seed(21))
    paths['recon'] = record_step_sites(
        lambda: g.recon_objective(z.requires_grad_(True), g.input).backward())
    del g
    torch.cuda.empty_cache()
    want_of = dict(TS_PER_STEP, recon=RECON_PER_GRAD_EVAL)
    return report_sites(paths, want_of, [dsgan_books]), paths


def chunk_driver(path):
    """The train entry point on a path's command with --steps_per_dispatch
    TS_CHUNK, bf16, one epoch of TS_CHUNK images, no print or save inside:
    one chunk, its first two steps eager, then the capture and a replay.
    The wrappers see CAPTURE_AFTER + 1 steps."""
    name = '%s_%s_chunked' % (TS_NAME, path)
    buf = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        r = trainer.main(path_args(path, name, 'bfloat16', TS_CHUNK) + [
            '--print_freq', '100', '--display_freq', '100',
            '--save_epoch_freq', '100', '--steps_per_dispatch',
            str(TS_CHUNK)])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(r['chunks'] == [TS_CHUNK], '%s chunked: chunks %s'
          % (path, r['chunks']))
    want = expected(TS_PER_STEP[path], CAPTURE_AFTER + 1)
    check(counts == want, '%s chunked: launches %s, expected %s (the eager '
          'steps and the capture)' % (path, counts, want))
    print('  %s chunked: chunks %s, wall %.1f ms' % (
        path, r['chunks'], 1e3 * r['step_seconds'][0]))
    return dict(chunks=r['chunks'], step_seconds=r['step_seconds'],
                launches=counts)


def ts_bench(path):
    """The bench entry point on a recipe's README command (bf16, kernels):
    per step and chunked rates, device ms, busy share, held as the bench
    phase's arms with TS_PER_STEP's launches."""
    base = ts_args(path, '%s_%s_bench' % (TS_NAME, path), 'bfloat16', 1)
    return _bench_arms(((path + ' kernels bf16', []),),
                       lambda flags, **kw: bench.main(
                           flags, base=base, metric_name='dsgan_' + path,
                           **kw), TS_PER_STEP[path])


def _ts_model(path):
    return lambda dt, label: create_model(TrainOptions().parse(path_args(
        path, '%s_%s_chunk_%s' % (TS_NAME, path, label), dt, CHUNK_STEPS)))


def ts_reference_step(path):
    """One f32 iteration of a path at 512 px, card (kernels) vs CPU (plain
    versions), as phase_reference_step holds the DSGAN's: losses 1e-3,
    gradients within max(5e-2, 2 x floor) in L2; no pool, no dropout."""
    flags = _without(path_args(path, TS_NAME + '_ref', 'float32', 1),
                     '--gpu_ids')
    return _reference_step((), '_%s' % path, 'float32', loss_tol=1e-3,
                           grad_tol=5e-2, floor_factor=2, card_flags=[],
                           recipe=Recipe(flags, '%s_%s' % (TS_NAME, path),
                                         ['--pool_size', '0',
                                          '--no_dropout2'],
                                         _dsgan_draws, _step_in_parts))


def phase_two_stage():
    """twostage and twostage_factd on the README command (bf16): TS_STEPS
    eager steps through the train entry point (launches, finite losses),
    one chunk through it, the bench's record, CHUNK_STEPS chunked steps
    bitwise equal to eager ones (deterministic algorithms), and one f32
    iteration card vs CPU; each flag run TS_STEPS eager steps and one
    chunk, (b) the card-vs-CPU iteration too."""
    out = {}
    for path in TS_PER_STEP:
        name = '%s_%s' % (TS_NAME, path)
        r = dict(train=run_train(path_args(path, name, 'bfloat16', TS_STEPS),
                                 name, TS_STEPS, TS_PER_STEP[path]))
        full = path in ('twostage', 'twostage_factd')
        r['chunked'] = chunk_driver(path)
        if full:
            r['bench'] = ts_bench(path)
            det = _chunk_runs_deterministic('bfloat16', make=_ts_model(path))
            for what in ('eager_spread', 'chunked'):
                d = det[what]
                check(d['differ'] == 0 and not any(d['losses'].values()),
                      '%s: %s under deterministic algorithms: %d tensors '
                      'differ (worst %s), losses %s' % (
                          path, what, d['differ'], d['name'], d['losses']))
            r['chunk_equals_eager'] = det
        if full or path == 'pairs_fixed_noise':
            print('  %s: one f32 iteration, card vs CPU' % path)
            r['reference_step'] = ts_reference_step(path)
        out[path] = r
    return out


def recon_args(stage1_name):
    """recon.py's flags for stage 1's run: its architecture, the synthetic
    training set, on the card."""
    return (STAGE1_ARCH + ON_CARD + ['--name', stage1_name, '--phase', 'train',
                                     '--results_dir',
                                     os.path.join(RESULTS_DIR, 'recon')])


def phase_recon(stage1_name):
    """fcgan latent inversion on stage 1's G (512 px, f32): the objective
    and its gradient in the noise at one draw, card (kernels) vs CPU (plain
    versions), 1e-4 relative and 5e-2 in L2; then the recon entry point
    for RECON_IMAGES images: each fit no worse than its start, launches =
    those of the objective's evaluations counted as they run, seconds an
    image, and the entry point's last line."""
    card = create_model(TestOptions().parse(recon_args(stage1_name)))
    cpu = create_model(TestOptions().parse(recon_args(stage1_name)
                                           + ['--gpu_ids', '-1']))
    batch = fixed_batch(seed=7)
    card.set_input(batch)
    cpu.set_input(batch)
    z = torch.randn(card._noise_shape(), generator=torch.Generator()
                    .manual_seed(22))
    grads = []
    for m in (card, cpu):
        zz = z.to(m.device, copy=True).requires_grad_(True)
        loss = m.recon_objective(zz, m.input)
        loss.backward()
        grads.append((float(loss.detach()), zz.grad.cpu().double()))
    (lc, gc_), (lp, gp) = grads
    loss_rel = abs(lc - lp) / abs(lp)
    grad_l2 = float((gc_ - gp).norm() / gp.norm())
    print('  objective card %.8f cpu %.8f (rel %.2e, limit 1e-4); gradient '
          'in z L2 rel %.2e (limit 5e-2)' % (lc, lp, loss_rel, grad_l2))
    check(loss_rel <= 1e-4 and grad_l2 <= 5e-2, 'recon objective: card vs '
          'CPU loss rel %.3g, gradient %.3g' % (loss_rel, grad_l2))
    del card, cpu
    evals = collections.Counter()
    generate = FCGANModel._recon_generate

    def counted(self, noise):
        evals['grad' if torch.is_grad_enabled() else 'no_grad'] += 1
        return generate(self, noise)

    FCGANModel._recon_generate = counted
    K.reset_launch_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            r = recon.main(recon_args(stage1_name)
                           + ['--how_many', str(RECON_IMAGES)])
    finally:
        FCGANModel._recon_generate = generate
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = expected({}, 0)
    n = evals['grad'] + evals['no_grad']
    want.update(convt4s2=RECON_PER_EVAL['convt4s2'] * n,
                conv4s2=RECON_PER_GRAD_EVAL['conv4s2'] * evals['grad'])
    check(counts == want, 'recon: launches %s, expected %s (%s evaluations)'
          % (counts, want, dict(evals)))
    line = buf.getvalue().strip().splitlines()[-1]
    check(r['images'] == RECON_IMAGES and line.startswith('BCE: mean ')
          and all(np.isfinite(r[k]).all() for k in ('bce', 'nll', 'nll_init')),
          'recon: %d images, last line %r' % (r['images'], line))
    check(all(e <= e0 for e, e0 in zip(r['bce'], r['bce_init'])),
          'recon: a fit worse than its start: %s vs %s' % (r['bce'],
                                                          r['bce_init']))
    print('  %s' % line)
    print('  %d images, %s s an image; BCE %s from %s; %s objective '
          'evaluations; launches %s' % (
              r['images'], ['%.2f' % t for t in r['seconds']], r['bce'],
              r['bce_init'], dict(evals), counts))
    return dict(loss_card=lc, loss_cpu=lp, loss_rel=loss_rel,
                grad_l2_rel=grad_l2, images=r['images'],
                seconds=r['seconds'], bce=r['bce'], bce_init=r['bce_init'],
                nll=r['nll'], nll_init=r['nll_init'], evals=dict(evals),
                launches=counts, line=line)



# ------ the last recipes: the cgan family, segmentation_cycle, TestModel -- #

LAST_NAME = 'chip_smoke_last'
UNALIGNED_DATA = os.path.join(RESULTS_DIR, 'unaligned_data')
FAKE_LABELS = 4
LAST_STEPS = 2
FAMILY_ROOTS = collections.OrderedDict([
    ('cgan_cycle', ('single', DATA_DIR)),
    ('cgan2', ('unaligned', UNALIGNED_DATA)),
    ('cgan2_cycle', ('unaligned', UNALIGNED_DATA)),
    ('cgan_causal', ('unaligned', UNALIGNED_DATA))])


def cycle_nets(width='64'):
    """The cycle recipes' nets in the suffixed flags at CGAN_FLAGS' widths
    (tools/bench_extra.py:54-68): G1 its unet_256 (dropout; the injected
    Gaussian noise, which --add_gaussian_noise gives every G), D1 its
    2-scale bank (n_layers 3 and 4, BCE), G2 (and cgan_causal's LG) a
    unet_256 from the image back to the label, at its lr."""
    return ['--which_model_netG1', 'unet_256', '--ngf1', width,
            '--which_model_netG2', 'unet_256', '--ngf2', width,
            '--which_model_netD1', 'n_layers', '--n_layers_D1', '3', '4',
            '--ndf1', width, '--scale_factor1', '1', '1',
            '--lambda_D1', '0.5', '0.5', '--no_lsgan1',
            '--lr1', '0.00002', '--lr2', '0.00002']


def family_args(model, width='64'):
    """CGAN_FLAGS with --model ``model`` on its dataset (the synthetic set,
    or the unaligned one); cgan2 keeps the plain flags' nets, the cycle
    recipes take cycle_nets.  ``width``: every net's ngf / ndf."""
    mode, root = FAMILY_ROOTS[model]
    args = _with(CGAN_FLAGS, model=model, dataset_mode=mode, dataroot=root,
                 name='%s_%s' % (LAST_NAME, model), ngf=width, ndf=width)
    return args if model == 'cgan2' else args + cycle_nets(width)


def family_per_step(runs, records, g_updates, backprop, stem_dx):
    """Launches of one step of a cgan family recipe, from the nets'
    structure (G256_* and the D bank's CG_D_*, as CGAN_PER_STEP): each of
    ``records`` recorded forwards runs ``runs`` unet_256s (the first, one
    after each of the ``g_updates`` G updates, the last without a graph);
    the D update as cgan's; a G update runs the bank once with every dx,
    then backpropagates through the ``backprop`` G runs its loss reaches:
    the dx of each one's convt4s2 (conv4s2) and of its conv4s2 past the
    stem (convt4s2), plus the stem's for the ``stem_dx`` runs whose input
    came from G1, and every IN backward."""
    fwd = runs * records
    return {'conv4s2': (fwd * G256_DOWN + 2 * CG_D_CONV
                        + g_updates * (CG_D_CONV + backprop * G256_UP)),
            'convt4s2': (fwd * G256_UP + 2 * (CG_D_CONV - CG_D_STEMS)
                         + g_updates * (CG_D_CONV + backprop * (G256_DOWN - 1)
                                        + stem_dx)),
            'instance_norm_act': (fwd * G256_IN + 2 * CG_D_CONV
                                  + g_updates * CG_D_CONV),
            'instance_norm_bwd': (2 * CG_D_CONV + g_updates * (
                CG_D_CONV + backprop * G256_IN))}


# n_update_G 2 (CGAN_FLAGS), cgan_causal's updates fixed at 1.  A forward:
# cgan_cycle G1(A), G2(B), G2(G1(A)); cgan2 G(A) and G(fake A), its loss
# reaching G(A) alone; cgan2_cycle and cgan_causal G1 on both labels, G2 on
# B and on both of G1's images (LG never runs).
FAMILY_PER_STEP = {'cgan_cycle': family_per_step(3, 3, 2, 3, 1),
                   'cgan2': family_per_step(2, 3, 2, 1, 0),
                   'cgan2_cycle': family_per_step(5, 3, 2, 5, 2),
                   'cgan_causal': family_per_step(5, 1, 1, 5, 2)}
FAMILY_NETS = {'cgan_cycle': ('G1', 'G2', 'D1_0', 'D1_1'),
               'cgan2': ('G', 'D_0', 'D_1'),
               'cgan2_cycle': ('G1', 'G2', 'D1_0', 'D1_1'),
               'cgan_causal': ('G1', 'G2', 'LG', 'D1_0', 'D1_1')}

# segmentation_cycle: SEG_ARCH's G (unet_128 ngf 16, b -> the rg classes)
# as G1, the same unet back to the image as G2, and a 1-scale D2 ndf 16 of
# n_layers 2 on (label, image) pairs, __graft_entry__.py:245-262's pairing
# and lambdas at 512 px and SEG_ARCH's widths; f32
SEGC_NAME = 'chip_smoke_segc'
SEGC_ARCH = _with(SEG_ARCH, model='segmentation_cycle', name=SEGC_NAME) + [
    '--which_model_netG1', 'unet_128', '--ngf1', '16', '--noise_nc1', '4',
    '--noiseSize1', '4', '--which_model_netG2', 'unet_128', '--ngf2', '16',
    '--noise_nc2', '4', '--noiseSize2', '4']
SEGC_TRAIN = ['--which_model_netD2', 'n_layers', '--n_layers_D2', '2',
              '--ndf2', '16', '--scale_factor2', '1', '--lambda_D2', '0.5',
              '--no_lsgan2', '--lambda_A', '10', '--lambda_B', '1',
              '--lambda_A_cycle', '1', '--cache_data']
# one step: G1(A), G2(B), G2(G1(A)) forward (F2_* is a unet_128's); D2
# (2 k4 s2 convs, 1 a stem, 2 IN) on the pooled fake and the real pair;
# the G update: D2 once with every dx, then back through the three runs
# (the stem's dx for G2(G1(A)) alone).  A val or test forward: G1 once.
D2C_CONV, D2C_STEMS = 2, 1
SEGC_PER_STEP = {
    'conv4s2': 3 * F2_DOWN + 2 * D2C_CONV + D2C_CONV + 3 * F2_UP,
    'convt4s2': (3 * F2_UP + 2 * (D2C_CONV - D2C_STEMS) + D2C_CONV
                 + 3 * (F2_DOWN - 1) + 1),
    'instance_norm_act': 3 * F2_IN + 2 * D2C_CONV + D2C_CONV,
    'instance_norm_bwd': 2 * D2C_CONV + D2C_CONV + 3 * F2_IN}
SEGC_PER_FORWARD = SEG_PER_FORWARD

# --model test: resnet_9blocks ngf 64 (the option default), without
# dropout (a Dropout shifts the blocks' state_dict keys), at 512 px; its
# convolutions (7x7, 3x3 s2 and reflect-padded 3x3 p0, k3 transposed) take
# the library, as they take XLA in the JAX package: the IN kernels alone,
# the stem's, the two downsamples', two in each of the 9 blocks and the two
# upsamples'
RESNET_NAME = 'chip_smoke_resnet'
RESNET_PER_FORWARD = {'instance_norm_act': 1 + 2 + 2 * 9 + 2}
RESNET_ARCH = ['--dataroot', SEG_DATA, '--name', RESNET_NAME, '--model',
               'test', '--dataset_mode', 'single', '--which_model_netG',
               'resnet_9blocks', '--ngf', '64', '--norm', 'instance',
               '--no_dropout', '--loadSize', '512', '--fineSize', '512',
               '--manualSeed', '0', '--checkpoints_dir', CKPT_DIR,
               '--display_id', '0']
RESNET_FORWARDS = 8


def write_unaligned_set():
    """UNALIGNED_DATA/trainA: the synthetic set's TRAIN_IMAGES label and
    image PNGs; trainB: FAKE_LABELS 1024^2 fake labels (sparse binary
    maps in R and G, as a stage-1 G would write them)."""
    a_dir = os.path.join(UNALIGNED_DATA, 'trainA')
    b_dir = os.path.join(UNALIGNED_DATA, 'trainB')
    os.makedirs(a_dir, exist_ok=True)
    os.makedirs(b_dir, exist_ok=True)
    src = os.path.join(DATA_DIR, 'train')
    for name in sorted(os.listdir(src)):
        shutil.copy(os.path.join(src, name), a_dir)
    rng = np.random.RandomState(2)
    for i in range(FAKE_LABELS):
        a = np.zeros((1024, 1024, 3), np.uint8)
        a[..., 0] = (rng.rand(1024, 1024) > 0.6) * 255
        a[..., 1] = (rng.rand(1024, 1024) > 0.85) * 255
        Image.fromarray(a).save(os.path.join(b_dir, 'fake_%03d.png' % i))


def save_resnet_weights():
    """resnet_9blocks ngf 64 (3 -> 3, no dropout) from seed 3 as
    RESNET_NAME's latest_net_G.pth."""
    net = tnn.define_G(3, 3, 64, 'resnet_9blocks', 'instance', False,
                       generator=torch.Generator().manual_seed(3))
    d = os.path.join(CKPT_DIR, RESNET_NAME)
    os.makedirs(d, exist_ok=True)
    pth.save_pth(os.path.join(d, 'latest_net_G.pth'), net)


def unaligned_batch(seed=0):
    """fixed_batch with a B image: another label pair in R and G."""
    b = fixed_batch(seed=seed)
    b['B'] = fixed_batch(seed=seed + 100)['A']
    b['B_paths'] = ['synthetic_B.png']
    return b


def phase_last_sites(known):
    """The kernel sites of one f32 step of each cgan family recipe (full
    width), of one segmentation_cycle step and val forward, and of one
    resnet_9blocks forward through TestModel, recorded as
    record_step_sites does; their totals against FAMILY_PER_STEP,
    SEGC_PER_STEP, SEGC_PER_FORWARD and RESNET_PER_FORWARD; the sites no
    earlier path has (``known``: their books), printed, each with its plan
    checked.  Returns (those sites' books in train_cases' keys, the
    per-path books)."""
    paths, want_of = {}, {}
    for model, per in FAMILY_PER_STEP.items():
        m = create_model(TrainOptions().parse(family_args(model) + ON_CARD + [
            '--compute_dtype', 'float32', '--name',
            '%s_%s_sites' % (LAST_NAME, model)]))
        m.set_input(unaligned_batch())
        paths[model] = record_step_sites(m.optimize_parameters)
        want_of[model] = per
        del m
        gc.collect()
    m = create_model(TrainOptions().parse(SEGC_ARCH + SEGC_TRAIN + ON_CARD + [
        '--name', SEGC_NAME + '_sites']))
    m.set_input(fixed_batch())
    paths['segmentation_cycle step'] = record_step_sites(
        m.optimize_parameters)
    paths['segmentation_cycle forward'] = record_step_sites(
        lambda: m.forward(val_mode=True))
    want_of['segmentation_cycle step'] = SEGC_PER_STEP
    want_of['segmentation_cycle forward'] = SEGC_PER_FORWARD
    del m
    m = create_model(TestOptions().parse(RESNET_ARCH + ON_CARD))
    m.set_input(fixed_batch())
    paths['resnet forward'] = record_step_sites(m.test)
    want_of['resnet forward'] = RESNET_PER_FORWARD
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return report_sites(paths, want_of, known), paths


def family_reference_step(model):
    """One f32 iteration of a cgan family recipe at 512 px, card (kernels)
    vs CPU (plain versions), as phase_cgan_reference_step holds cgan's:
    losses 1e-3, gradients within max(5e-2, 2 x floor) in L2; no pool, no
    dropout.  cgan2_cycle at CGAN_FLAGS' widths, the others at ngf / ndf
    16."""
    width = '64' if model == 'cgan2_cycle' else '16'
    recipe = Recipe(family_args(model, width), '%s_%s' % (LAST_NAME, model),
                    ['--pool_size', '0', '--no_dropout', '--no_dropout1',
                     '--no_dropout2'], _gauss_draws, _d_g_step_in_parts)
    return _reference_step((), '_ref', 'float32', loss_tol=1e-3,
                           grad_tol=5e-2, floor_factor=2, card_flags=[],
                           recipe=recipe, batch=unaligned_batch(seed=5))


def family_bench(model):
    """The bench entry point on a recipe's command (bf16, kernels): per
    step and chunked rates, device ms, busy share, held as the bench
    phase's arms with FAMILY_PER_STEP's launches."""
    base = family_args(model)
    return _bench_arms(((model + ' kernels bf16', []),),
                       lambda flags, **kw: bench.main(
                           flags, base=base, metric_name=model, **kw),
                       FAMILY_PER_STEP[model])


def phase_cgan_family():
    """Each cgan family recipe on its command (bf16): LAST_STEPS steps
    through the train entry point (exact launches, finite losses, its
    checkpoints), the bench's record, one f32 iteration card vs CPU; for
    cgan_cycle also CHUNK_STEPS chunked steps bitwise equal to eager ones
    under deterministic algorithms and the conditional sampler on the
    trained run."""
    out = {}
    for model, per in FAMILY_PER_STEP.items():
        name = '%s_%s_bfloat16' % (LAST_NAME, model)
        r = dict(train=run_train(
            family_args(model) + ON_CARD + _epoch_flags(
                name, 'bfloat16', LAST_STEPS)
            + ['--display_freq', str(LAST_STEPS), '--save_epoch_freq', '1'],
            name, LAST_STEPS, per, FAMILY_NETS[model]))
        r['bench'] = family_bench(model)
        if model == 'cgan_cycle':
            det = _chunk_runs_deterministic(
                'bfloat16', make=lambda dt, label: create_model(
                    TrainOptions().parse(family_args(model) + ON_CARD + [
                        '--compute_dtype', dt, '--name',
                        '%s_chunk_%s' % (LAST_NAME, label)])))
            for what in ('eager_spread', 'chunked'):
                d = det[what]
                check(d['differ'] == 0 and not any(d['losses'].values()),
                      'cgan_cycle: %s under deterministic algorithms: %d '
                      'tensors differ (worst %s), losses %s' % (
                          what, d['differ'], d['name'], d['losses']))
            r['chunk_equals_eager'] = det
            r['sampler'] = phase_cgan_sampler(
                name, flags=_with(CGAN_SAMPLER, model='cgan_cycle')
                + cycle_nets()[:8], label='cgan_cycle')
        print('  %s: one f32 iteration, card vs CPU' % model)
        r['reference_step'] = family_reference_step(model)
        out[model] = r
    return out


def phase_segmentation_cycle():
    """train_ss at SEGC_ARCH for LAST_STEPS steps with validation on the 2
    val images and the best meanIU checkpoint, then test_ss on it over the
    4 test images: exact launch counts, RandScore and meanIU finite and
    within [0, 1], the cross entropy finite, the step time and the test
    images/s; the step through bench.main (f32, kernels), held as the
    bench's arms; one f32 iteration card vs CPU (losses 1e-3, gradients
    within max(5e-2, 2 x floor) in L2; no pool, no dropout)."""
    K.reset_launch_counts()
    r = train_ss.main(SEGC_ARCH + SEGC_TRAIN + ON_CARD + [
        '--niter', '1', '--niter_decay', '0', '--print_freq', '1',
        '--display_freq', '100', '--save_epoch_freq', '1',
        '--best_metric', 'meanIU', '--max_dataset_size', str(LAST_STEPS)])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    n_val = SEG_SPLITS[1][1]
    want = expected(_plus(*[SEGC_PER_STEP] * LAST_STEPS
                          + [SEGC_PER_FORWARD] * n_val), 1)
    check(counts == want, 'segmentation_cycle train_ss: launches %s, '
          'expected %s' % (counts, want))
    check(r['steps'] == LAST_STEPS and len(r['val_accs']) == 1,
          'segmentation_cycle train_ss: %d steps, val %s'
          % (r['steps'], r['val_accs']))
    _accs_in_range(r['val_accs'][0], 'segmentation_cycle train_ss val')
    run_dir = os.path.join(CKPT_DIR, SEGC_NAME)
    check({'best_net_G1.pth', 'best_net_G2.pth', 'best_net_D2_0.pth',
           'latest_state.pt'} <= set(os.listdir(run_dir)),
          'segmentation_cycle train_ss: checkpoints missing')
    step_ms = [1e3 * t for t in r['step_seconds']]
    K.reset_launch_counts()
    t = test_ss.main(SEGC_ARCH + ON_CARD + [
        '--which_epoch', 'best', '--results_dir',
        os.path.join(RESULTS_DIR, 'segc_test')])
    torch.cuda.synchronize()
    test_counts = K.launch_counts()
    n_test = SEG_SPLITS[2][1]
    check(test_counts == expected(SEGC_PER_FORWARD, n_test),
          'segmentation_cycle test_ss: launches %s, expected %s' % (
              test_counts, expected(SEGC_PER_FORWARD, n_test)))
    check(t['images'] == n_test and np.isfinite(t['ce_mean']),
          'segmentation_cycle test_ss: %d images, cross entropy %s'
          % (t['images'], t['ce_mean']))
    _accs_in_range(t['accs'], 'segmentation_cycle test_ss')
    print('  train_ss: %d steps, first %.1f ms, median of the rest %.1f ms; '
          'val %s; test_ss: %d images, %.3f images/s, %s, cross entropy '
          '%.4f' % (r['steps'], step_ms[0], statistics.median(step_ms[1:]),
                    r['val_accs'][0], n_test, n_test / t['test_seconds'],
                    t['accs'], t['ce_mean']))
    bench_rec = _bench_arms(
        (('segmentation_cycle kernels f32', []),),
        lambda flags, **kw: bench.main(
            flags, base=SEGC_ARCH + SEGC_TRAIN,
            metric_name='segmentation_cycle_unet128', **kw), SEGC_PER_STEP)
    print('  one f32 iteration, card vs CPU')
    ref = _reference_step((), '_ref', 'float32', loss_tol=1e-3,
                          grad_tol=5e-2, floor_factor=2, card_flags=[],
                          recipe=Recipe(SEGC_ARCH + SEGC_TRAIN, SEGC_NAME, [
                              '--pool_size', '0', '--no_dropout1',
                              '--no_dropout2'], lambda m: None,
                              _d_g_step_in_parts))
    return dict(train_steps=r['steps'], train_step_ms=step_ms,
                median_train_step_ms=statistics.median(step_ms[1:]),
                val_accs=r['val_accs'], best=r['best'], train_launches=counts,
                test_images=t['images'], test_accs=t['accs'],
                ce_mean=t['ce_mean'], ce_std=t['ce_std'],
                test_images_per_second=n_test / t['test_seconds'],
                test_launches=test_counts, reference_step=ref,
                bench=bench_rec,
                launches_per_step=SEGC_PER_STEP,
                launches_per_forward=SEGC_PER_FORWARD)


def phase_resnet_test():
    """TestModel with resnet_9blocks ngf 64 at 512 px: one forward card
    (kernels) vs CPU (plain versions) in f32, within 2e-3 of the output;
    then RESNET_FORWARDS forwards in f32 and in bf16: launches
    (RESNET_PER_FORWARD a forward), finite outputs, images/s to a
    synchronize."""
    batch = fixed_batch(seed=8)
    outs = []
    for dev in (ON_CARD, ['--gpu_ids', '-1']):
        m = create_model(TestOptions().parse(RESNET_ARCH + dev))
        m.set_input(batch)
        m.test()
        outs.append(m.fake_B.float().cpu())
        del m
    diff = float((outs[0] - outs[1]).abs().max())
    print('  f32 forward, card vs CPU: max abs diff %.2e (limit 2e-3)'
          % diff)
    check(diff <= 2e-3, 'resnet_9blocks: card vs CPU differ by %.3g' % diff)
    out = dict(card_vs_cpu_max_abs=diff)
    for dtype in ('float32', 'bfloat16'):
        m = create_model(TestOptions().parse(RESNET_ARCH + ON_CARD + [
            '--compute_dtype', dtype]))
        m.set_input(batch)
        m.test()                      # cuDNN's choices, the IN libraries
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        finite = True
        for _ in range(RESNET_FORWARDS):
            m.test()
            finite = finite and bool(torch.isfinite(m.fake_B).all())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
        want = expected(RESNET_PER_FORWARD, RESNET_FORWARDS)
        check(counts == want and finite, 'resnet_9blocks %s: launches %s, '
              'expected %s; finite %s' % (dtype, counts, want, finite))
        out[dtype] = dict(images_per_second=RESNET_FORWARDS / secs,
                          launches=counts)
        print('  %s: %d forwards in %.3f s = %.3f images/s; launches %s'
              % (dtype, RESNET_FORWARDS, secs, RESNET_FORWARDS / secs,
                 counts))
        del m
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- the zoo -- #

ZOO_NAME = 'chip_smoke_zoo'
# Each path is a README command with the nets changed and nothing else:
# Z1 the stage-1 label GAN (tools/recipe_r05.py:71-84, README.md:274-280;
# STAGE1_ARCH + STAGE1_TRAIN) with the factorized G; Z2 SGAN step 2
# (CGAN_FLAGS, README.md:345-352) with the autoencoder G (5 levels) and the
# separable D; Z3 JointGAN (bench_extra.JOINTGAN_ARGS, tools/
# bench_extra.py:71-77) with the DCGAN pair at its fixed 128 px from 100 x
# 1^2 noise, one D.  ``arch``: the sampler's flags (the architecture ones).
Zoo = collections.namedtuple('Zoo', 'flags arch px per_step per_sample nets '
                                    'visuals')
_ZOO_TRAIN_ONLY = ('--which_model_netD', '--n_layers_D', '--ndf',
                   '--scale_factor', '--lambda_D', '--n_update_G',
                   '--no_lsgan', '--lr')
Z1_ARCH = _with(STAGE1_ARCH, which_model_netG='fcgan_star',
                name=ZOO_NAME + '_z1') + ['--compute_dtype', 'bfloat16']
Z2_FLAGS = _with(CGAN_FLAGS, which_model_netG='autoencoder',
                 which_model_netD='n_layers_sep',
                 name=ZOO_NAME + '_z2') + ['--n_layers_G', '5']
Z3_FLAGS = _with(_without(bench_extra.JOINTGAN_ARGS, '--n_layers_D',
                          '--scale_factor', '--lambda_D'),
                 dataroot=DATA_DIR, checkpoints_dir=CKPT_DIR,
                 name=ZOO_NAME + '_z3', which_model_netG='dcgan',
                 which_model_netD='dcgan', loadSize='128', fineSize='128',
                 noiseSize='1', noise_nc='100', ngf='64', ndf='64') + [
    '--n_layers_D', '3', '--scale_factor', '1', '--lambda_D', '1']

# Kernel launches a step, from the nets' structure.  Z1: stage 1's D bank
# and update schedule (S1_*: G runs 3 times, the D bank 4), G two towers of
# 6 k4 s2 ConvTs whose 2 stems see the noise (no dx).  Z2: cgan's schedule
# (CG_*); the autoencoder 6 k4 s2 convs (5 levels and the latent; the stem
# sees the label), 6 k4 s2 ConvTs and 10 IN; the separable D of n_layers 3
# 5 k4 s2 convs (the two towers' 2 each, 1 in the trunk) and 4 IN, of
# n_layers 4 6 and 5, 4 stems in all (the towers' first: on the detached
# pairs of the D update they need no dx; in the G update the label tower's
# does, as its input is a slice of a pair that needs a gradient).  Z3: the
# same schedule as Z1, the dcgan G 5 k4 s2 ConvTs after its 4-1-0 one (a
# library call), the dcgan D 5 k4 s2 convs (1 stem) and no IN (BatchNorm).
Z1_G_CONVT, Z1_G_STEMS = 12, 2
AE_DOWN, AE_UP, AE_IN = 6, 6, 10
SEP_CONV, SEP_STEMS, SEP_IN = 5 + 6, 4, 4 + 5
DC_G_CONVT, DC_D_CONV = 5, 5


def fcgan_zoo_per_step(g_convt, g_stems, n_ds, d_conv, d_in):
    """A --model fcgan step (n_update_D 1, n_update_G 2) with a G of
    ``g_convt`` k4 s2 ConvTs (``g_stems`` of them on the noise) and ``n_ds``
    Ds of ``d_conv`` k4 s2 convs (1 stem) and ``d_in`` IN each."""
    return {'convt4s2': (S1_G_RUNS * g_convt + 2 * n_ds * (d_conv - 1)
                         + S1_G_UPDATES * n_ds * d_conv),
            'conv4s2': (S1_D_PASSES * n_ds * d_conv
                        + S1_G_UPDATES * (g_convt - g_stems)),
            'instance_norm_act': S1_D_PASSES * n_ds * d_in,
            'instance_norm_bwd': S1_D_PASSES * n_ds * d_in}


ZOO = collections.OrderedDict([
    ('z1_fcgan_star', Zoo(
        Z1_ARCH + STAGE1_TRAIN, Z1_ARCH, 512,
        fcgan_zoo_per_step(Z1_G_CONVT, Z1_G_STEMS, S1_DS, S1_D_CONV,
                           S1_D_IN),
        {'convt4s2': Z1_G_CONVT}, ('G', 'D_0', 'D_1', 'D_2'), ('fake',))),
    ('z2_autoencoder_sep', Zoo(
        Z2_FLAGS, _with(CGAN_SAMPLER, which_model_netG='autoencoder')
        + ['--n_layers_G', '5'], 512,
        {'conv4s2': (CG_G_RUNS * AE_DOWN + (2 + CG_G_UPDATES) * SEP_CONV
                     + CG_G_UPDATES * AE_UP),
         'convt4s2': (CG_G_RUNS * AE_UP + 2 * (SEP_CONV - SEP_STEMS)
                      + CG_G_UPDATES * SEP_CONV
                      + CG_G_UPDATES * (AE_DOWN - 1)),
         'instance_norm_act': CG_G_RUNS * AE_IN + (2 + CG_G_UPDATES) * SEP_IN,
         'instance_norm_bwd': ((2 + CG_G_UPDATES) * SEP_IN
                               + CG_G_UPDATES * AE_IN)},
        {'conv4s2': AE_DOWN, 'convt4s2': AE_UP, 'instance_norm_act': AE_IN},
        ('G', 'D_0', 'D_1'), None)),
    ('z3_dcgan', Zoo(
        Z3_FLAGS, _without(Z3_FLAGS, *_ZOO_TRAIN_ONLY), 128,
        fcgan_zoo_per_step(DC_G_CONVT, 0, 1, DC_D_CONV, 0),
        {'convt4s2': DC_G_CONVT}, ('G', 'D_0'),
        ('fake_label', 'fake_image')))])


def phase_zoo_sites(known):
    """The kernel sites of one f32 step of each zoo path (full width),
    recorded as record_step_sites does; their totals against ZOO's
    per_step; the sites no earlier path has (``known``: their books),
    printed, each with its plan checked.  Returns (those sites' books in
    train_cases' keys, the per-path books)."""
    paths, want_of = {}, {}
    for path, z in ZOO.items():
        m = create_model(TrainOptions().parse(z.flags + ON_CARD + [
            '--compute_dtype', 'float32', '--name',
            '%s_%s_sites' % (ZOO_NAME, path)]))
        m.set_input(fixed_batch(px=z.px))
        paths[path] = record_step_sites(m.optimize_parameters)
        want_of[path] = z.per_step
        del m
        gc.collect()
    torch.cuda.empty_cache()
    return report_sites(paths, want_of, known), paths


def _fcgan_draws(model):
    """One noise for every --model fcgan model, drawn once on the CPU from
    seed 11, on the model's device."""
    noise = torch.randn(model._noise_shape(),
                        generator=torch.Generator().manual_seed(11))
    model.draw_noise = lambda: noise.to(model.device)


def _fcgan_step_in_parts(model, d_from=None):
    """A --model fcgan iteration's D update and first G update on one fake
    (with ``d_from``, the D bank takes d_from's parameters between them).
    Returns the loss terms."""
    fake = model._generate(model.draw_noise())
    d_real, d_fake = model.update_D(fake)
    if d_from is not None:
        with torch.no_grad():
            for p, q in zip(model.netD.parameters(),
                            d_from.netD.parameters()):
                p.copy_(q)
    g = model.update_G(fake)
    return {'D_real': float(d_real), 'D_fake': float(d_fake),
            'G_GAN': float(g)}


def zoo_reference_step(path):
    """One f32 iteration of a zoo path at its size, card (kernels) vs CPU
    (plain versions), as family_reference_step holds the cgan family's:
    losses 1e-3, gradients within max(5e-2, 2 x floor) in L2; no pool, no
    dropout; Z2 at ngf / ndf 16 (its CPU steps), the others at full
    width."""
    z = ZOO[path]
    if path.startswith('z2'):
        recipe = Recipe(_with(z.flags, ngf='16', ndf='16'),
                        '%s_%s' % (ZOO_NAME, path),
                        ['--pool_size', '0', '--no_dropout'], lambda m: None,
                        _d_g_step_in_parts)
    else:
        recipe = Recipe(z.flags, '%s_%s' % (ZOO_NAME, path),
                        ['--pool_size', '0', '--no_dropout'], _fcgan_draws,
                        _fcgan_step_in_parts)
    return _reference_step((), '_ref', 'float32', loss_tol=1e-3,
                           grad_tol=5e-2, floor_factor=2, card_flags=[],
                           recipe=recipe, batch=fixed_batch(px=z.px, seed=5))


def _check_reload(path, name):
    """The run's latest checkpoints into a fresh model of its command with
    --continue_train: every net loads strictly (and the full state), and
    each equals its file."""
    m = create_model(TrainOptions().parse(ZOO[path].flags + ON_CARD + [
        '--name', name, '--continue_train', '--which_epoch', 'latest']))
    nets = {'G': m.netG}
    nets.update(('D_%d' % i, d) for i, d in enumerate(m.netD))
    check(sorted(nets) == sorted(ZOO[path].nets),
          '%s: nets %s' % (path, sorted(nets)))
    for label, net in nets.items():
        saved = torch.load(os.path.join(CKPT_DIR, name, 'latest_net_%s.pth'
                                        % label), weights_only=True)
        ours = net.state_dict()
        check(set(ours) == set(saved) and all(
            torch.equal(ours[k].cpu(), v) for k, v in saved.items()),
            '%s: latest_net_%s.pth did not load back' % (path, label))
    del m


def phase_zoo():
    """Each zoo path on its command (bf16): LAST_STEPS steps through the
    train entry point (exact launches, finite losses, its checkpoints,
    loaded back strictly), its sampler on the trained run (exact launches),
    the bench's record (per step and chunked: a CUDA graph of the step;
    held as the bench phase's arms), one f32 iteration card vs CPU."""
    out = {}
    for path, z in ZOO.items():
        name = '%s_%s_bfloat16' % (ZOO_NAME, path)
        r = dict(train=run_train(
            z.flags + ON_CARD + _epoch_flags(name, 'bfloat16', LAST_STEPS)
            + ['--display_freq', str(LAST_STEPS), '--save_epoch_freq', '1'],
            name, LAST_STEPS, z.per_step, z.nets))
        _check_reload(path, name)
        if z.visuals is None:
            r['sampler'] = phase_cgan_sampler(name, flags=z.arch,
                                              label=path,
                                              per_sample=z.per_sample)
        else:
            t0 = time.perf_counter()
            rs, counts = run_sampler(
                z.arch + ['--name', name], 4,
                os.path.join(RESULTS_DIR, path + '_sampler'), z.per_sample,
                z.visuals)
            r['sampler'] = dict(samples=4, launches=counts,
                                loop_seconds=rs['loop_seconds'],
                                sample_seconds=rs['sample_seconds'],
                                images_per_second=4 / rs['loop_seconds'])
            print('  %s sampler: 4 samples in %.3f s (drawing %.3f s); '
                  'launches %s (%.1f s with the set-up)' % (
                      path, rs['loop_seconds'], rs['sample_seconds'], counts,
                      time.perf_counter() - t0))
        r['bench'] = _bench_arms(
            ((path + ' kernels bf16', ['--compute_dtype', 'bfloat16']),),
            lambda flags, z=z, path=path, **kw: bench.main(
                flags, base=z.flags, metric_name=path, **kw), z.per_step)
        print('  %s: one f32 iteration, card vs CPU' % path)
        r['reference_step'] = zoo_reference_step(path)
        out[path] = r
    return out


# ------------------------- the host image path and the quality gate -- #

GATE_NAME = 'chip_smoke_gate'
GATE_WORK = os.path.join(RESULTS_DIR, 'gate')
# the gate's real set as supervised_gan_tpu_torch/quality_eval.py makes it
# for the smoke's run below (512 px, train / val / test 4 / 2 / 4)
GATE_PX, GATE_NGF, GATE_COUNTS = 512, 16, (4, 2, 4)
GATE_SET = os.path.join(RESULTS_DIR, 'gate_set')
GATE_SAMPLES = 4
# the gate at its full width (quality_eval.build_args(512, 16): fcgan G1
# ngf 16 x 5 layers, CRN G2 ngf 16, unet_128 F2 nff 16, one n_layers 3 D a
# bank at scale 1, f32) and a smoke's depth: 1 + 1 epochs of each training
GATE_ARGS = ['--px', str(GATE_PX), '--ngf', str(GATE_NGF),
             '--train_n', str(GATE_COUNTS[0]), '--val_n', str(GATE_COUNTS[1]),
             '--test_n', str(GATE_COUNTS[2]), '--epochs_gan', '1',
             '--epochs_ss', '1', '--samples', str(GATE_SAMPLES),
             '--negative_control', '--gpu_ids', '0', '--work', GATE_WORK]
# its GAN step: the DSGAN's nets with each D bank one n_layers-3 D (3 k4 s2
# convs, 1 stem, 3 IN); its sampler runs G1 and G2 as the README's does
GATE_PER_STEP = two_stage_per_step(d1=(3, 1), d2=(3, 1))
GATE_PER_SAMPLE = SAMPLER_PER_SAMPLE
DRIVER_MAINS = {'train': trainer.main, 'test': sampler.main,
                'train_ss': train_ss.main, 'test_ss': test_ss.main}
DECODE_ROUNDS = 3
SPLIT_NAME = CGAN_NAME + '_split'


def _host_ms(fn, items, rounds=DECODE_ROUNDS):
    """The median host ms of fn(item) over ``rounds`` passes of items."""
    ts = []
    for _ in range(rounds):
        for it in items:
            t0 = time.perf_counter()
            fn(it)
            ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


@contextlib.contextmanager
def native_decode(on):
    """The decoder's process-wide switch (--no_native_io clears it) set to
    ``on`` inside, put back after."""
    saved = transforms._NATIVE_IO
    transforms._NATIVE_IO = on
    try:
        yield
    finally:
        transforms._NATIVE_IO = saved


def _pngs(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith('.png'))


def phase_decode():
    """The native PNG decoder on the card's host: its pixels against PIL's
    on the 1024^2 training set and the gate's 512^2 set, load_rgb's ms an
    image each way; the cgan train command's input path split by stage
    (load_rgb, dataset.get, the loader's collate, the model's set_input to
    a synchronize), the loader alone, and the train entry point per step
    and chunked, with the decoder and with --no_native_io."""
    quality_eval.make_dataset(GATE_SET, px=GATE_PX, counts=GATE_COUNTS)
    out = dict(library=str(native_io.build()))
    sets = (('1024^2 training set', _pngs(os.path.join(DATA_DIR, 'train'))),
            ('512^2 gate set', _pngs(GATE_SET)))
    for label, paths in sets:
        for p in paths:
            ours = native_io.decode_png(p)
            check(ours is not None and np.array_equal(
                ours, np.asarray(Image.open(p).convert('RGB'))),
                'native decode of %s differs from PIL' % p)
        row = {}
        for on in (True, False, False, True):
            with native_decode(on):
                row.setdefault('native' if on else 'pil', []).append(
                    _host_ms(transforms.load_rgb, paths))
        out[label] = dict(images=len(paths), **row)
        print('  load_rgb, %s (%d images, %d rounds, in turns): native %s '
              'ms an image, PIL %s' % (label, len(paths), DECODE_ROUNDS,
                                       ['%.2f' % v for v in row['native']],
                                       ['%.2f' % v for v in row['pil']]))

    # the cgan command's input path, stage by stage
    opt = TrainOptions().parse(CGAN_FLAGS + ON_CARD + [
        '--compute_dtype', 'bfloat16', '--name', SPLIT_NAME,
        '--max_dataset_size', str(TRAIN_IMAGES)])
    model = create_model(opt)
    split = {}
    for on in (True, False):
        with native_decode(on):
            loader = CreateDataLoader(opt)
            ds = loader.dataset
            idx = list(range(len(loader)))
            rng = np.random.default_rng(0)
            st = dict(
                decode=_host_ms(lambda i: transforms.load_rgb(
                    ds.A_paths[i]), idx),
                get=_host_ms(lambda i: ds.get(i, rng), idx))
            sample = ds.get(0, rng)
            st['resize_augment'] = st['get'] - st['decode']
            st['collate'] = _host_ms(
                lambda _: data_loader._collate([sample]), idx)
            batch = data_loader._collate([sample])

            def set_input(_):
                model.set_input(batch)
                torch.cuda.synchronize()
            st['set_input'] = _host_ms(set_input, idx)
            t0 = time.perf_counter()
            n = sum(1 for _ in loader.load_data())
            st['loader_ms_a_batch'] = 1e3 * (time.perf_counter() - t0) / n
            split['native' if on else 'pil'] = st
            print('  cgan input path, %s: load_rgb %.2f ms, dataset.get %.2f '
                  '(resize and augmentation %.2f), collate %.3f, set_input '
                  '%.3f; the loader alone (%d threads) %.2f ms a batch' % (
                      'native' if on else '--no_native_io', st['decode'],
                      st['get'], st['resize_augment'], st['collate'],
                      st['set_input'], opt.nThreads,
                      st['loader_ms_a_batch']))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out['cgan_split'] = split

    # the train entry point on the cgan command, per step and chunked
    runs = {}
    for on in (True, False):
        tag = 'native' if on else 'pil'
        extra = [] if on else ['--no_native_io']
        with native_decode(True):
            name = '%s_%s' % (SPLIT_NAME, tag)
            runs[tag] = dict(per_step=run_train(
                CGAN_FLAGS + ON_CARD + extra
                + _epoch_flags(name, 'bfloat16', TRAIN_IMAGES),
                name, TRAIN_IMAGES, CGAN_PER_STEP))
            check(transforms._NATIVE_IO is on, 'the train entry point left '
                  'the decoder %s' % ('off' if on else 'on'))
            runs[tag]['chunked'] = cgan_chunked_train(
                extra, '%s_chunked_%s' % (SPLIT_NAME, tag))
        print('  cgan train, %s: per step %.1f ms (median), chunked %.2f ms '
              'a replayed step' % (tag, runs[tag]['per_step'][
                  'median_step_ms'], runs[tag]['chunked'][
                      'replay_ms_per_step']))
    out['cgan_train'] = runs
    return out


def phase_gate_sites(known):
    """The kernel sites of one f32 step of the gate's GAN (GATE_ARGS'
    widths: its CRN is 16 channels wide) and of one
    segmentation step and val forward, recorded as record_step_sites does;
    their totals against GATE_PER_STEP, SEG_PER_STEP and SEG_PER_FORWARD;
    the sites no earlier path has, printed, each with its plan checked."""
    _, gan_train, _, ss_train = quality_eval.build_args(GATE_PX, GATE_NGF)
    common = ['--dataroot', GATE_SET, '--checkpoints_dir', CKPT_DIR]
    paths = {}
    m = create_model(TrainOptions().parse(gan_train + common + ON_CARD + [
        '--name', GATE_NAME + '_sites']))
    check(m.opt.compute_dtype == 'float32', 'the gate runs in %s'
          % m.opt.compute_dtype)
    m.set_input(fixed_batch(px=GATE_PX))
    paths['gate GAN step'] = record_step_sites(m.optimize_parameters)
    del m
    seg = create_model(TrainOptions().parse(ss_train + common + ON_CARD + [
        '--name', GATE_NAME + '_seg_sites']))
    seg.set_input(fixed_batch(px=GATE_PX))
    paths['gate segmentation step'] = record_step_sites(
        seg.optimize_parameters)
    paths['gate segmentation forward'] = record_step_sites(
        lambda: seg.forward(val_mode=True))
    del seg
    gc.collect()
    torch.cuda.empty_cache()
    want_of = {'gate GAN step': GATE_PER_STEP,
               'gate segmentation step': SEG_PER_STEP,
               'gate segmentation forward': SEG_PER_FORWARD}
    return report_sites(paths, want_of, known), paths


def gate_launches():
    """The launches each of the smoke gate's driver runs must make:
    GATE_PER_STEP a GAN step (2 epochs of the train split), GATE_PER_SAMPLE
    a sample, SEG_PER_STEP a segmentation step and SEG_PER_FORWARD a val or
    test forward (train_ss validates after each of its 2 epochs)."""
    n_train, n_val, n_test = GATE_COUNTS
    ss = expected(_plus(*[SEG_PER_STEP] * GATE_SAMPLES
                        + [SEG_PER_FORWARD] * n_val), 2)
    ss_ub = expected(_plus(*[SEG_PER_STEP] * n_train
                           + [SEG_PER_FORWARD] * n_val), 2)
    test = expected(SEG_PER_FORWARD, n_test)
    return {'gan_train': expected(GATE_PER_STEP, 2 * n_train),
            'gan_sample': expected(GATE_PER_SAMPLE, GATE_SAMPLES),
            'ss_train': ss, 'ss_test': test, 'ss_ub_train': ss_ub,
            'ss_ub_test': test, 'ss_neg_train': ss, 'ss_neg_test': test}


def phase_gate():
    """The port's quality gate (supervised_gan_tpu_torch/quality_eval.py,
    GATE_ARGS) on the card, each driver run in-process with the launch
    counts set to 0 just before and read just after: every run completes
    with its exact launches, the sampler's *AB* pairs decode natively,
    the three rows' RandScore and meanIU lie in [0, 1] and every metric
    is finite.  Random-start weights trained for 2 epochs: quality is not
    measured here."""
    counts = {}

    def in_process(driver, args, log):
        K.reset_launch_counts()
        with open(log, 'w') as f, contextlib.redirect_stdout(f):
            DRIVER_MAINS[driver](args)
        torch.cuda.synchronize()
        counts[os.path.basename(log)[:-len('.log')]] = K.launch_counts()
        return 0

    with native_decode(True):
        result, gate = quality_eval.evaluate(
            quality_eval.parser().parse_args(GATE_ARGS), in_process)
    want = gate_launches()
    check(set(counts) == set(want), 'gate runs %s' % sorted(counts))
    for tag, c in counts.items():
        check(c == want[tag], 'gate %s: launches %s, expected %s'
              % (tag, c, want[tag]))
    pairs = _pngs(os.path.join(gate.gen, 'train'))
    check(len(pairs) == GATE_SAMPLES and all('AB' in p for p in pairs),
          'gate pairs %s' % pairs)
    for p in pairs:
        a = native_io.decode_png(p)
        check(a is not None and a.shape == (GATE_PX, GATE_PX, 3),
              'gate pair %s does not decode natively' % p)
    for row in ('ours', 'real_pairs_upper_bound',
                'negative_control_label_shuffled'):
        m = result[row]
        check(set(m) == {'RandScore', 'meanIU', 'CE_mean', 'CE_std'}
              and all(np.isfinite(v) for v in m.values())
              and 0 <= m['RandScore'] <= 1 and 0 <= m['meanIU'] <= 1,
              'gate %s: metrics %s' % (row, m))
    print('  gate runs (s): %s' % ', '.join(
        '%s %.1f' % kv for kv in gate.seconds.items()))
    print('  gate rows (2 + 2 epochs, random start; not a quality number): '
          'ours %s, bound %s, control %s' % (
              result['ours'], result['real_pairs_upper_bound'],
              result['negative_control_label_shuffled']))
    return dict(result=result, run_seconds=gate.seconds, launches=counts,
                launches_expected=want)


# Data parallelism (--data_mesh, supervised_gan_tpu_torch/parallel/): the
# bench DSGAN configuration in f32 at the global batch DM_BATCH, DM_STEPS
# steps.  The sharded run and the one-process runs part by rounding (each
# rank's kernels run at batch 1, with their own plans and sums; the
# library's nondeterministic backward), which the GAN step amplifies: on an
# H100 the sharded run lands 1.17-1.21e-3 (whole state, relative L2) from
# one process, two one-process runs 0.4-2.8e-4 from each other (8 rounds
# of scripts/data_mesh_spread.py and 3 runs of this phase; PERF.md).
# DM_SPREAD_FLOOR, the largest sharded-vs-one-process distances of those
# rounds and of the phase's own first runs (whole state, worst tensor, a
# loss relative to its value), rounded up, floors the check's limits:
# twice the largest one-process pair, at least twice the floor
# (dm_limits).  On the CPU the same split agrees with one process within
# 1e-12 in float64 (tests/test_torch_parallel.py).
DM_NAME = 'chip_smoke_dm'
DM_BATCH = 2
DM_STEPS = 2
DM_RUNS = 2
DM_JOIN_TIMEOUT = 300
DM_SPREAD_FLOOR = {'whole': 1.21e-3, 'worst': 0.171, 'loss': 7.1e-5}


def _dm_batches():
    """The global batch of each step: DM_BATCH rows of fixed_batch."""
    out = []
    for s_ in range(DM_STEPS):
        rows = [fixed_batch(seed=20 + DM_BATCH * s_ + i)
                for i in range(DM_BATCH)]
        out.append({'A': np.concatenate([r['A'] for r in rows]),
                    'A_paths': ['%d_%d.png' % (s_, i)
                                for i in range(DM_BATCH)]})
    return out


def _dm_model(label, extra=()):
    return create_model(train_opt(
        ['--compute_dtype', 'float32', '--batchSize', str(DM_BATCH),
         '--name', '%s_%s' % (DM_NAME, label)] + list(extra)))


def _dm_steps(model):
    """DM_STEPS steps on _dm_batches, each timed to a synchronize, launch
    counts set to 0 just before and read just after; then the state on the
    host."""
    K.reset_launch_counts()
    ms = []
    for b in _dm_batches():
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = K.launch_counts()
    state, losses = _model_state(model)
    return dict(ms=ms, counts=counts, losses=parallel.mean_values(losses),
                state={k: v.cpu() for k, v in state.items()})


def _dm_rank(rank, port, out):
    """One of two gloo ranks sharing cuda:0 (spawned): the sharded steps,
    written to ``out``/dm_rank<rank>.pt, with the wall ms of each all-reduce
    (BatchNorm's statistics, the gradients), each timed from an idle
    device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inner, spans = parallel.mesh._all_reduce_sum_, []

    def timed(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_ = inner(t)
        torch.cuda.synchronize()
        spans.append(1e3 * (time.perf_counter() - t0))
        return out_
    parallel.mesh._all_reduce_sum_ = timed
    parallel.init_distributed('127.0.0.1:%d' % port, DM_BATCH, rank,
                              backend='gloo', device=DEV,
                              timeout_s=DM_JOIN_TIMEOUT)
    try:
        model = _dm_model('rank%d' % rank, ['--data_mesh', str(DM_BATCH)])
        r = _dm_steps(model)
        r['all_reduce_ms'] = spans
        torch.save(r, os.path.join(out, 'dm_rank%d.pt' % rank))
    finally:
        parallel.shutdown()
        parallel.mesh._all_reduce_sum_ = inner


def dm_sharded_run():
    """DM_BATCH gloo ranks on cuda:0, one row each: their results."""
    port = parallel.mesh.free_port()
    ctx = torch.multiprocessing.start_processes(
        _dm_rank, args=(port, RESULTS_DIR), nprocs=DM_BATCH, join=False,
        start_method='spawn')
    deadline = time.time() + DM_JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.time() < deadline, 'the data-mesh ranks did not end '
                  'within %d s' % DM_JOIN_TIMEOUT)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [torch.load(os.path.join(RESULTS_DIR, 'dm_rank%d.pt' % r),
                       weights_only=True) for r in range(DM_BATCH)]


def dm_limits(pairs, losses, floor=DM_SPREAD_FLOOR):
    """Twice the largest one-process pair (_state_diff results) of the whole
    state's and the worst tensor's relative L2 and of each loss, each at
    least twice ``floor`` (a loss's floor relative to its value)."""
    limits = {m: 2 * max([p[m] for p in pairs.values()] + [floor[m]])
              for m in ('whole', 'worst')}
    for k, v in losses.items():
        limits[k] = 2 * max([p['losses'][k] for p in pairs.values()]
                            + [floor['loss'] * abs(v)])
    return limits


def dm_compare():
    """DM_RUNS one-process runs and one sharded run of DM_STEPS steps from
    one seed: every state and loss, the distances, and the step times."""
    ones = []
    for i in range(DM_RUNS):
        model = _dm_model('one%d' % i)
        ones.append(_dm_steps(model))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    ranks = dm_sharded_run()

    def st(r):
        return r['state'], r['losses']
    pairs = {'one%d-one%d' % (i, j): _state_diff(st(ones[i]), st(ones[j]))
             for i in range(DM_RUNS) for j in range(i + 1, DM_RUNS)}
    sharded = {'rank0-one%d' % i: _state_diff(st(o), st(ranks[0]))
               for i, o in enumerate(ones)}
    return ones, ranks, pairs, sharded


def phase_data_mesh():
    """(c) train --data_mesh 2 on this one-card machine raises; (a) two gloo
    ranks on cuda:0 (one row each of the global batch DM_BATCH) against
    DM_RUNS one-process runs of the batch: losses and every parameter, Adam
    moment and pool within dm_limits, each rank's launches the batch-1
    step's, the ranks' states bitwise equal; (b) a process group of one
    (NCCL): one step with the gradient hook and the BatchNorm all-reduce on,
    bitwise equal to the step without a group (deterministic algorithms)."""
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    try:
        trainer.main(TRAIN_FLAGS + ON_CARD + [
            '--batchSize', '2', '--data_mesh', '2', '--name',
            DM_NAME + '_cards'])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and 'fewer cards than workers' in raised
          and 'has %d cards' % cards in raised,
          'train --data_mesh 2 on %d card(s) did not raise the fewer-cards '
          'error: %r' % (cards, raised))
    print('  --data_mesh 2 on %d card(s): %s' % (cards, raised))

    ones, ranks, pairs, sharded = dm_compare()
    expect = expected(LAUNCHES_PER_STEP, DM_STEPS)
    for i, r in enumerate(ones):
        check(r['counts'] == expect, 'one-process batch-%d run %d: launches '
              '%s, expected %s' % (DM_BATCH, i, r['counts'], expect))
    for rank, r in enumerate(ranks):
        check(r['counts'] == expect, 'data-mesh rank %d: launches %s, '
              'expected the batch-1 step\'s %s' % (rank, r['counts'], expect))
        d = _state_diff((ranks[0]['state'], ranks[0]['losses']),
                        (r['state'], r['losses']))
        check(d['differ'] == 0 and not any(d['losses'].values()),
              'data-mesh rank %d: %d tensors differ from rank 0 (%s), '
              'losses %s' % (rank, d['differ'], d['name'], d['losses']))
    limits = dm_limits(pairs, ones[0]['losses'])
    over = {n: _over_limits(d, limits) for n, d in sharded.items()}
    for n, d in sharded.items():
        print('  %s: whole %.3g, worst %.3g (%s), losses %s'
              % (n, d['whole'], d['worst'], d['name'], d['losses']))
    for n, d in pairs.items():
        print('  %s: whole %.3g, worst %.3g (%s)'
              % (n, d['whole'], d['worst'], d['name']))
    check(not any(over.values()), 'data-mesh steps beyond the limits %s: %s'
          % (limits, over))
    rank_ms = [statistics.median(r['ms'][1:]) for r in ranks]
    one_ms = statistics.median(o['ms'][-1] for o in ones)
    # the all-reduces of the last step (each step makes as many)
    per_step = len(ranks[0]['all_reduce_ms']) // DM_STEPS
    reduce_ms = [sum(r['all_reduce_ms'][-per_step:]) for r in ranks]
    print('data mesh on %s: %d gloo ranks on one card, batch 1 each: %s ms '
          'a step (rank 0, 1), %s ms of it in %d all-reduces through the '
          'host; one process, batch %d: %.1f ms a step'
          % (card_line(), DM_BATCH, ', '.join('%.1f' % m for m in rank_ms),
             ', '.join('%.1f' % m for m in reduce_ms), per_step, DM_BATCH,
             one_ms))

    world_one = phase_data_mesh_world_one()
    return dict(cards_error=raised, limits=limits, pairs=pairs,
                sharded=sharded, rank_step_ms=[r['ms'] for r in ranks],
                rank_all_reduce_ms=[r['all_reduce_ms'] for r in ranks],
                one_step_ms=[o['ms'] for o in ones],
                launches=ranks[0]['counts'], world_one=world_one)


def phase_data_mesh_world_one():
    """(b): the bench configuration, f32, batch 1, one step from seed 0
    under deterministic algorithms, in an NCCL group of one (the gradient
    hook and the BatchNorm all-reduce active) and with no group."""
    calls = collections.Counter()
    inner = parallel.mesh._all_reduce_sum_

    def counted(t):
        calls['all_reduce'] += 1
        return inner(t)
    results = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    parallel.mesh._all_reduce_sum_ = counted
    try:
        for label in ('group', 'none'):
            calls.clear()
            if label == 'group':
                parallel.init_distributed(
                    '127.0.0.1:%d' % parallel.mesh.free_port(), 1, 0,
                    backend='nccl', device=DEV, timeout_s=DM_JOIN_TIMEOUT)
            try:
                model = create_model(train_opt([
                    '--compute_dtype', 'float32', '--name',
                    '%s_one_%s' % (DM_NAME, label)]))
                hooks = [len(o._optimizer_step_pre_hooks)
                         for o in model.optimizers().values()]
                model.set_input(fixed_batch(seed=30))
                model.optimize_parameters()
                torch.cuda.synchronize()
                state, losses = _model_state(model)
                results[label] = dict(
                    state={k: v.cpu() for k, v in state.items()},
                    losses=losses, hooks=hooks,
                    all_reduces=calls['all_reduce'])
                del model
            finally:
                parallel.shutdown()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        parallel.mesh._all_reduce_sum_ = inner
        torch.use_deterministic_algorithms(False)
    g, n = results['group'], results['none']
    check(all(h == 1 for h in g['hooks']) and g['all_reduces'] > 0,
          'in the group of one: hooks %s, %d all-reduces'
          % (g['hooks'], g['all_reduces']))
    check(not any(n['hooks']) and n['all_reduces'] == 0,
          'without a group: hooks %s, %d all-reduces'
          % (n['hooks'], n['all_reduces']))
    d = _state_diff((n['state'], n['losses']), (g['state'], g['losses']))
    check(d['differ'] == 0 and not any(d['losses'].values()),
          'the step in a group of one differs from the step without one: '
          '%d tensors (%s), losses %s' % (d['differ'], d['name'], d['losses']))
    print('  NCCL group of one: %d all-reduces in the step (BatchNorm and '
          'the gradient hook), %d tensors and the losses bitwise equal to '
          'the step without a group' % (g['all_reduces'], len(g['state'])))
    return dict(all_reduces=g['all_reduces'], tensors=len(g['state']),
                hooks=g['hooks'])

# ------------------------------------------------ spatial parallelism -- #
# --spatial_mesh 2 (parallel/spatial.py): two gloo ranks on cuda:0 split the
# height of the bench DSGAN configuration (512 px, batch 1, f32), held
# against SP_RUNS one-process batch-1 runs of the same SP_STEPS steps.  The
# limits follow dm_limits with SP_SPREAD_FLOOR: twice the largest
# one-process pair, at least twice the floor, which is the
# sharded-vs-one-process distance, rounded: over 11 runs on an H100 (this
# phase's and 6 rounds of scripts/data_mesh_spread.py --spatial_mesh) the
# whole state 2.40-2.51e-3, worst tensor 0.297-0.306, a loss up to 2.39e-4
# of its value, against 2.2e-4-1.01e-3, 0.063-0.134 and 5.8e-5 between two
# one-process runs (PERF.md): each rank's kernels run on half planes, with
# their own plans and sums, so the split lands further from one process
# than two one-process runs land apart, by a steady amount.  Planted faults
# land past the limits (the script's --plants): halo gradients dropped,
# whole 1.33e-2 and worst 0.668; IN statistics from a rank's own rows,
# 0.110 and 1.32.
# On the CPU the same split agrees with one process within 1e-9 in float64
# (tests/test_torch_spatial_steps.py).
SP_NAME = 'chip_smoke_sp'
SP_STEPS = 2
SP_RUNS = 2
SP_JOIN_TIMEOUT = 300
SP_SPREAD_FLOOR = {'whole': 2.5e-3, 'worst': 0.31, 'loss': 2.3e-4}
# the row-split IN entries' sites: a 512^2 plane's half, 64 channels
SP_IN_SHAPE = (1, 64, 256, 512)
SP_IN_SLOPE = 0.2
SP_IN_KERNELS = ('instance_norm_partial_stats',
                 'instance_norm_bwd_partial_stats', 'instance_norm_bwd_apply')


def sp_per_step(books):
    """Each rank's wrapper launches a step at --spatial_mesh 2 (rehearsed on
    the CPU at narrow widths): every conv site as the one-process step's
    (LAUNCHES_PER_STEP); each IN site whose plane has 16 rows or more
    (spatial.MIN_ROWS a rank) takes the row-split route, forward
    partial_stats + apply, backward bwd_partial_stats + bwd_apply, the
    others the one-launch kernels.  ``books``: the one-process step's
    recorded IN sites."""
    split_h = 2 * parallel.spatial.MIN_ROWS
    f = sum(c for (xs, _), c in books['InstanceNormAct'].items()
            if xs[2] >= split_h)
    b = sum(c for (xs, _), c in books['instance_norm_bwd'].items()
            if xs[2] >= split_h)
    per = dict(LAUNCHES_PER_STEP)
    per.update(instance_norm_act=per['instance_norm_act'] - f,
               instance_norm_bwd=per['instance_norm_bwd'] - b,
               instance_norm_partial_stats=f, instance_norm_apply=f,
               instance_norm_bwd_partial_stats=b, instance_norm_bwd_apply=b)
    return per


def spatial_in_cases():
    """The row-split IN entries at SP_IN_SHAPE (a rank's half of a 512^2
    plane), against their plain versions; their statistics and sums stay
    float32 in the bf16 runs.  No one PyTorch call computes any of them."""
    n = 1
    for d in SP_IN_SHAPE:
        n *= d
    count = float(SP_IN_SHAPE[2] * 2 * SP_IN_SHAPE[3])
    nc = SP_IN_SHAPE[0] * SP_IN_SHAPE[1]

    def stats(gen):
        return (randn(SP_IN_SHAPE, gen, 2.0) + 0.5,
                torch.rand((SP_IN_SHAPE[0], SP_IN_SHAPE[1]), generator=gen,
                           device=DEV) + 0.5,
                torch.rand((SP_IN_SHAPE[0], SP_IN_SHAPE[1]), generator=gen,
                           device=DEV) * 0.5 + 0.5)

    def mk_x(gen):
        return (randn(SP_IN_SHAPE, gen, 2.0) + 0.5,)

    def mk_bwd(gen):
        x, mean, rstd = stats(gen)
        return (x, randn(SP_IN_SHAPE, gen), mean, rstd)

    def mk_apply(gen):
        x, g, mean, rstd = mk_bwd(gen)
        sums = K.instance_norm_bwd_partial_stats_plain(x, g, mean, rstd,
                                                       SP_IN_SLOPE) * 2.0
        return (x, g, mean, rstd, sums.contiguous())

    def to16(args):
        return tuple(a.to(torch.bfloat16) if i < 2 and a.dim() == 4 else a
                     for i, a in enumerate(args))

    return [
        Case('instance_norm_partial_stats', 'half plane %s' % (SP_IN_SHAPE,),
             1, K.instance_norm_partial_stats,
             K.instance_norm_partial_stats_plain, None, 3.0 * n, 4.0 * n
             + 8.0 * nc, 2.0 * n + 8.0 * nc, mk_x, within_sum, to16),
        Case('instance_norm_bwd_partial_stats',
             'half plane %s slope %s' % (SP_IN_SHAPE, SP_IN_SLOPE), 1,
             lambda x, g, m, r: K.instance_norm_bwd_partial_stats(
                 x, g, m, r, SP_IN_SLOPE),
             lambda x, g, m, r: K.instance_norm_bwd_partial_stats_plain(
                 x, g, m, r, SP_IN_SLOPE), None, 7.0 * n,
             8.0 * n + 16.0 * nc, 4.0 * n + 16.0 * nc, mk_bwd, within_sum,
             to16),
        Case('instance_norm_bwd_apply',
             'half plane %s slope %s' % (SP_IN_SHAPE, SP_IN_SLOPE), 1,
             lambda x, g, m, r, s_: K.instance_norm_bwd_apply(
                 x, g, m, r, s_, count, SP_IN_SLOPE),
             lambda x, g, m, r, s_: K.instance_norm_bwd_apply_plain(
                 x, g, m, r, s_, count, SP_IN_SLOPE), None, 8.0 * n,
             12.0 * n + 16.0 * nc, 6.0 * n + 16.0 * nc, mk_apply, within,
             to16)]


def phase_spatial_in():
    """The row-split IN entries vs their plain versions (run_cases: f32 and
    bf16, device times), then each kernel twice on one input, f32 and
    bf16: the two results bitwise equal."""
    cases = spatial_in_cases()
    per_site, agg = run_cases(cases)
    gen = torch.Generator(device=DEV).manual_seed(77)
    for c in cases:
        args = c.mk(gen)
        for a in (args, c.to16(args)):
            y1, y2 = c.kern(*a), c.kern(*a)
            torch.cuda.synchronize()
            check(torch.equal(y1, y2), '%s: two runs differ' % c.kernel)
    print('  %s: two runs of one launch bitwise equal, f32 and bf16'
          % ', '.join(c.kernel for c in cases))
    return per_site, agg


def _sp_batches():
    return [fixed_batch(seed=40 + s_) for s_ in range(SP_STEPS)]


def _sp_model(label, extra=()):
    return create_model(train_opt(
        ['--compute_dtype', 'float32', '--name', '%s_%s' % (SP_NAME, label)]
        + list(extra)))


def _sp_steps(model, after_step=None):
    """SP_STEPS steps on _sp_batches, each timed to a synchronize (then
    ``after_step()``), launch counts set to 0 just before and read just
    after; then the state on the host, the pools whole (every sp rank
    gathers them)."""
    K.reset_launch_counts()
    ms = []
    for b in _sp_batches():
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if after_step is not None:
            after_step()
    counts = K.launch_counts()
    with parallel.spatial.whole_pools(model.pools):
        state, losses = _model_state(model)
    return dict(ms=ms, counts=counts, losses=parallel.mean_values(losses),
                state={k: v.cpu() for k, v in state.items()})


def _timed_calls(spans, key, fn):
    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_ = fn(*a, **kw)
        torch.cuda.synchronize()
        spans[key].append(1e3 * (time.perf_counter() - t0))
        return out_
    return timed


def _plant_local_in_stats():
    """A planted fault: each rank's IN planes normalized by the statistics
    of its own rows (the all-reduce of the partial sums taken as twice the
    rank's own: its half of a 512-row plane)."""
    parallel.spatial.sp_sum_ = lambda t: t.mul_(2)


def _plant_no_halo_grad():
    """A planted fault: each halo's gradient dropped instead of sent back
    to the rank that owns its rows."""
    sp = parallel.spatial

    def backward(ctx, g):
        own, win = ctx.own[sp.index()], ctx.ranges[sp.index()]
        with sp.quiet():
            dx = g.new_zeros(ctx.shape)
            o = sp._overlap(*own, *win)
            if o:
                dx.narrow(-2, o[0] - own[0], o[1] - o[0]).copy_(
                    g.narrow(-2, o[0] - win[0], o[1] - o[0]))
        return dx, None, None
    sp._Fetch.backward = staticmethod(backward)


# faults a sharded run can be given (sp_sharded_run's ``plant``), to show
# how far beyond the check's limits such a fault lands
# (scripts/data_mesh_spread.py --spatial_mesh --plants)
SP_PLANTS = {'local_in_stats': _plant_local_in_stats,
             'no_halo_grad': _plant_no_halo_grad}


def _sp_rank(rank, port, out, plant=None):
    """One of two gloo sp ranks sharing cuda:0 (spawned): the sharded steps,
    written to ``out``/sp_rank<rank>.pt, with the wall ms of each halo
    exchange, all-reduce and all-gather, each timed from an idle device;
    ``plant``: the name of an SP_PLANTS fault to run them with."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sp, mesh = parallel.spatial, parallel.mesh
    spans = collections.defaultdict(list)
    saved = (sp._exchange, mesh.all_reduce_sum_in_,
             torch.distributed.all_gather)
    sp._exchange = _timed_calls(spans, 'halo', saved[0])
    mesh.all_reduce_sum_in_ = _timed_calls(spans, 'all_reduce', saved[1])
    torch.distributed.all_gather = _timed_calls(spans, 'all_gather',
                                                saved[2])
    parallel.init_distributed('127.0.0.1:%d' % port, 2, rank,
                              backend='gloo', device=DEV,
                              timeout_s=SP_JOIN_TIMEOUT, n_sp=2)
    if plant is not None:
        SP_PLANTS[plant]()
    try:
        model = _sp_model('rank%d' % rank, ['--spatial_mesh', '2'])
        spans.clear()
        sp.COUNTS.clear()
        marks = []
        r = _sp_steps(model, lambda: marks.append(
            {k: len(v) for k, v in spans.items()}))
        # the last step's spans: between the last two marks
        r['last_step_spans_ms'] = {
            k: v[marks[-2].get(k, 0):marks[-1].get(k, 0)]
            for k, v in spans.items()}
        r['collectives'] = dict(sp.COUNTS)
        torch.save(r, os.path.join(out, 'sp_rank%d.pt' % rank))
    finally:
        parallel.shutdown()
        (sp._exchange, mesh.all_reduce_sum_in_,
         torch.distributed.all_gather) = saved


def sp_sharded_run(plant=None):
    """Two gloo sp ranks on cuda:0 (with the SP_PLANTS fault ``plant``):
    their results."""
    port = parallel.mesh.free_port()
    ctx = torch.multiprocessing.start_processes(
        _sp_rank, args=(port, RESULTS_DIR, plant), nprocs=2, join=False,
        start_method='spawn')
    deadline = time.time() + SP_JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.time() < deadline, 'the spatial-mesh ranks did not '
                  'end within %d s' % SP_JOIN_TIMEOUT)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [torch.load(os.path.join(RESULTS_DIR, 'sp_rank%d.pt' % r),
                       weights_only=True) for r in range(2)]


def sp_compare():
    """SP_RUNS one-process runs and one sharded run of SP_STEPS steps from
    one seed: every state and loss, the distances, the step times."""
    ones = []
    for i in range(SP_RUNS):
        model = _sp_model('one%d' % i)
        ones.append(_sp_steps(model))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    ranks = sp_sharded_run()

    def st(r):
        return r['state'], r['losses']
    pairs = {'one%d-one%d' % (i, j): _state_diff(st(ones[i]), st(ones[j]))
             for i in range(SP_RUNS) for j in range(i + 1, SP_RUNS)}
    sharded = {'rank0-one%d' % i: _state_diff(st(o), st(ranks[0]))
               for i, o in enumerate(ones)}
    return ones, ranks, pairs, sharded


def phase_spatial_mesh(books):
    """(c) train --spatial_mesh 2 on this one-card machine raises; (a) two
    gloo ranks on cuda:0 split the height of the bench configuration (f32,
    batch 1) against SP_RUNS one-process runs: losses and every parameter,
    Adam moment and pool within dm_limits (SP_SPREAD_FLOOR), each rank's
    launches sp_per_step's (every conv site on its kernel, the IN sites of
    16 rows or more on the row-split entries), the ranks' states bitwise
    equal; the step's time, and its halo exchanges', all-reduces' and
    all-gathers' shares of it."""
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    try:
        trainer.main(TRAIN_FLAGS + ON_CARD + [
            '--spatial_mesh', '2', '--name', SP_NAME + '_cards'])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and 'fewer cards than workers' in raised
          and '--spatial_mesh 2' in raised
          and 'has %d cards' % cards in raised,
          'train --spatial_mesh 2 on %d card(s) did not raise the '
          'fewer-cards error: %r' % (cards, raised))
    print('  --spatial_mesh 2 on %d card(s): %s' % (cards, raised))

    ones, ranks, pairs, sharded = sp_compare()
    per = sp_per_step(books)
    expect = expected(per, SP_STEPS)
    one_expect = expected(LAUNCHES_PER_STEP, SP_STEPS)
    for i, r in enumerate(ones):
        check(r['counts'] == one_expect, 'one-process run %d: launches %s, '
              'expected %s' % (i, r['counts'], one_expect))
    for rank, r in enumerate(ranks):
        check(r['counts'] == expect, 'spatial-mesh rank %d: launches %s, '
              'expected %s' % (rank, r['counts'], expect))
        check(all(r['counts'][k] > 0 for k in per),
              'spatial-mesh rank %d: a kernel of the path never launched: '
              '%s' % (rank, r['counts']))
        d = _state_diff((ranks[0]['state'], ranks[0]['losses']),
                        (r['state'], r['losses']))
        check(d['differ'] == 0 and not any(d['losses'].values()),
              'spatial-mesh rank %d: %d tensors differ from rank 0 (%s), '
              'losses %s' % (rank, d['differ'], d['name'], d['losses']))
    limits = dm_limits(pairs, ones[0]['losses'], floor=SP_SPREAD_FLOOR)
    over = {n: _over_limits(d, limits) for n, d in sharded.items()}
    for n, d in sharded.items():
        print('  %s: whole %.3g, worst %.3g (%s), losses %s'
              % (n, d['whole'], d['worst'], d['name'], d['losses']))
    for n, d in pairs.items():
        print('  %s: whole %.3g, worst %.3g (%s), losses %s'
              % (n, d['whole'], d['worst'], d['name'], d['losses']))
    check(not any(over.values()), 'spatial-mesh steps beyond the limits '
          '%s: %s' % (limits, over))
    rank_ms = [statistics.median(r['ms'][1:]) for r in ranks]
    one_ms = statistics.median(o['ms'][-1] for o in ones)
    shares = [{k: dict(calls=len(v), ms=sum(v))
               for k, v in r['last_step_spans_ms'].items()} for r in ranks]
    print('spatial mesh on %s: 2 gloo ranks on one card, half the rows '
          'each: %s ms a step (rank 0, 1); of rank 0\'s last step %s; one '
          'process: %.1f ms a step; collectives a run (rank 0) %s'
          % (card_line(), ', '.join('%.1f' % m for m in rank_ms),
             ', '.join('%s %d calls %.1f ms' % (k, v['calls'], v['ms'])
                       for k, v in sorted(shares[0].items())), one_ms,
             ranks[0]['collectives']))
    return dict(cards_error=raised, limits=limits, pairs=pairs,
                sharded=sharded, rank_step_ms=[r['ms'] for r in ranks],
                one_step_ms=[o['ms'] for o in ones], last_step_shares=shares,
                collectives=ranks[0]['collectives'], per_step=per,
                launches=ranks[0]['counts'])


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

    heading('== build')
    t0 = time.time()
    reports = build.build_all()
    print('built %d kernel libraries in %.1f s' % (len(reports),
                                                    time.time() - t0))
    t0 = time.time()
    print('PNG decoder: %s (%.1f s)' % (native_io.build(), time.time() - t0))
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

    heading('== conv3x3 at ragged shapes, and two runs of one launch')
    conv3_shapes = phase_conv3x3_shapes()
    heading('== conv3x3_dw at ragged shapes, and two runs of one launch')
    dw_shapes = phase_conv3x3_dw_shapes()
    heading('== conv4s2 at ragged shapes, and two runs of one launch')
    c4_shapes = phase_conv4s2_shapes()
    heading('== convt4s2 at ragged shapes, and two runs of one launch')
    ct_shapes = phase_convt4s2_shapes()
    heading('== instance_norm_act and instance_norm_bwd at ragged shapes, at '
          'their routes\' thresholds, and two runs of one launch')
    in_shapes, in_shape_plans = phase_instance_norm_shapes()
    in_ptxas = ptxas_in_kernels()
    print('  one-launch kernels, [registers, spill bytes]: %s' % in_ptxas)
    check(in_ptxas and all(v[1] == 0 for v in in_ptxas.values()),
          'IN one-launch kernels spill or are missing: %s' % in_ptxas)

    heading('== forward kernels vs plain versions at the 512 px sampler sites')
    per_site, agg = run_cases(sampler_cases())

    heading('== the fused conv3x3 + IN region\'s kernels at the CRN trunk sites')
    per_site_r, agg_r = phase_region()
    heading('== conv3x3_in_stats at ragged shapes and on constant planes')
    region_shapes = phase_region_shapes()
    agg.update(agg_r)

    heading('== the train step\'s sites (one f32 step, bench.py configuration)')
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

    heading('== kernels A, B, C, and conv3x3 and convt4s2 as dx, vs plain '
          'versions at the train step\'s sites')
    per_site_t, agg_t = run_cases(train_cases(books))
    per_site += per_site_t
    agg.update(agg_t)

    heading('== autograd Functions vs autograd of the plain forwards')
    fn_checks = phase_functions(books)

    heading('== sampler: DSGAN, 512 px, %d samples' % SAMPLES)
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
    heading('== sampler forward alone: wall and device time per sample')
    fwd = phase_forward(g1, g2)
    heading('== reference: one 512 px sample, card kernels vs CPU plain')
    phase_reference(g1, g2)
    heading('== --no_pallas: one 512 px sample, card library calls vs CPU '
          'plain; 2 samples through the sampler, no kernel launched')
    phase_reference(g1, g2, card_kernels=False)
    r_np, counts_np = run_sampler(DSGAN_FLAGS + ['--no_pallas'], 2,
                                  os.path.join(RESULTS_DIR, 'no_pallas'), {})
    K.set_kernels_enabled(True)
    print('sampler --no_pallas: 2 samples in %.3f s; launches %s'
          % (r_np['loop_seconds'], counts_np))
    heading('== sampler with the region\'s gate on: %d samples, and one sample '
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

    heading('== training: bench.py DSGAN configuration, 512 px')
    write_train_set()
    train16 = bench_train('bfloat16', TRAIN_IMAGES)
    train32 = bench_train('float32', F32_STEPS)
    heading('== one bf16 train step profiled')
    prof = phase_profile_step(device_kernels)
    heading('== reference: one f32 train step at 512 px, card vs CPU plain')
    ref_step = phase_reference_step()
    heading('== reference under --no_pallas: one f32 train step at 512 px, '
          'card library calls vs CPU plain')
    ref_step_np = phase_reference_step(no_pallas=True)
    heading('== --profile_dir: a trace of steps 10-20 of a %d-step f32 run'
          % PROFILE_STEPS)
    profile_dir = phase_profile_dir()
    heading('== the bench entry point: kernels and --no_pallas, bf16 and f32, '
          'in turns')
    bench_arms = phase_bench()
    heading('== the step without a synchronize: one eager bf16 step under '
          'set_sync_debug_mode("error")')
    sync_free = phase_sync_free()
    heading('== chunked == eager: %d steps, train_chunk (a captured step '
          'replayed) against eager steps, f32 and bf16, deterministic; one '
          'step with the default algorithms' % CHUNK_STEPS)
    chunk_eq = {dt: phase_chunk_equals_eager(dt)
                for dt in ('float32', 'bfloat16')}
    heading('== the train entry point with --steps_per_dispatch %d'
          % DRIVER_CHUNK)
    chunked_driver = phase_chunked_driver()

    heading('== stage 1: the label GAN (--model fcgan), recipe command, 512 px')
    stage1_16 = stage1_train('bfloat16', TRAIN_IMAGES)
    stage1_32 = stage1_train('float32', F32_STEPS)
    stage1_name = '%s_bfloat16' % STAGE1_NAME
    r_s1, counts_s1 = run_sampler(
        STAGE1_ARCH + ['--name', stage1_name], 4,
        os.path.join(RESULTS_DIR, 'stage1'), {'convt4s2': G1_CONVT},
        ('fake',))
    print('stage-1 sampler: 4 samples in %.3f s; launches %s'
          % (r_s1['loop_seconds'], counts_s1))

    heading('== hand-off: stage 1\'s G and D_0, D_1 as seq_net_{G1,D1_0,D1_1}')
    handoff(stage1_name)
    check_sequential_load()
    heading('== the README DSGAN command (--sequential_train), bf16, region '
          'gate on and off')
    readme = {'gate_on': readme_train(True, TRAIN_IMAGES),
              'gate_off': readme_train(False, TRAIN_IMAGES)}
    heading('== reference: one bf16 train step with the region\'s gate on (the '
          'README step), card vs CPU plain, both in bf16')
    ref_step_bf16 = phase_reference_step(gate=True, dtype='bfloat16')

    heading('== SGAN step 2 (cgan) and the segmentation gate: their kernel '
          'sites, and those the DSGAN step does not have')
    t_new = time.time()
    write_seg_set()
    new_books, new_paths = phase_new_sites(books)
    heading('== kernels vs plain versions at the new sites')
    per_site_new, agg_new = run_cases(new_site_cases(new_books))
    heading('== cgan training: tools/bench_extra.py:54-68, 512 px, bf16')
    cgan16 = cgan_train('bfloat16', TRAIN_IMAGES)
    heading('== cgan training with --steps_per_dispatch %d' % CGAN_CHUNK)
    cgan_chunked = cgan_chunked_train()
    heading('== cgan: chunked == eager, %d steps, bf16, deterministic'
          % CHUNK_STEPS)
    cgan_chunk_eq = phase_cgan_chunk_equals_eager()
    heading('== reference: one f32 cgan iteration at 512 px, card vs CPU plain')
    cgan_ref = phase_cgan_reference_step()
    heading('== the conditional sampler (--model cgan), 512 px, bf16')
    cgan_sampler = phase_cgan_sampler('%s_bfloat16' % CGAN_NAME)
    heading('== bench_extra cgan_pix2pix_512: kernels and --no_pallas, bf16')
    cgan_bench = phase_cgan_bench()
    heading('== segmentation: train_ss, then test_ss (quality_eval.py:94-104, '
          '512 px)')
    segmentation = phase_segmentation()
    heading('== the segmentation step as bench arms: kernels and --no_pallas, '
          'f32')
    seg_bench = phase_seg_bench()
    new_seconds = time.time() - t_new
    print('SGAN step 2 and segmentation phases: %.1f s' % new_seconds)

    heading('== the two-stage family (twostage, twostage_factd, the DSGAN\'s '
          'training options) and latent inversion: their kernel sites, and '
          'those the DSGAN step does not have')
    t_ts = time.time()
    ts_books, ts_paths = phase_ts_sites(books, stage1_name)
    heading('== kernels vs plain versions at the two-stage family\'s new sites')
    per_site_ts, agg_ts = run_cases(new_site_cases(ts_books))
    heading('== twostage, twostage_factd (README command, bf16) and the '
          'training options (bench configuration)')
    two_stage = phase_two_stage()
    heading('== latent inversion: recon on stage 1\'s G, 512 px')
    recon_run = phase_recon(stage1_name)
    ts_seconds = time.time() - t_ts
    print('two-stage family and recon phases: %.1f s' % ts_seconds)

    heading('== the last recipes (the cgan family, segmentation_cycle, '
          '--model test with resnet_9blocks): their kernel sites, and those '
          'no earlier path has')
    t_last = time.time()
    write_unaligned_set()
    save_resnet_weights()
    last_books, last_paths = phase_last_sites(
        [books] + list(new_paths.values()) + list(ts_paths.values()))
    heading('== kernels vs plain versions at the last recipes\' new sites')
    per_site_last, agg_last = run_cases(new_site_cases(last_books))
    heading('== the cgan family (cgan_cycle, cgan2, cgan2_cycle, cgan_causal; '
          'tools/bench_extra.py:54-68 widths, 512 px, bf16)')
    family = phase_cgan_family()
    heading('== segmentation_cycle: train_ss, then test_ss (512 px, f32)')
    seg_cycle = phase_segmentation_cycle()
    heading('== --model test: resnet_9blocks ngf 64 at 512 px')
    resnet = phase_resnet_test()
    last_seconds = time.time() - t_last
    print('last recipes\' phases: %.1f s' % last_seconds)

    heading('== the rest of the zoo (fcgan_star, the autoencoder and '
          'n_layers_sep, the dcgan pair): their kernel sites, and those no '
          'earlier path has')
    t_zoo = time.time()
    zoo_books, zoo_paths = phase_zoo_sites(
        [books] + list(new_paths.values()) + list(ts_paths.values())
        + list(last_paths.values()))
    heading('== kernels vs plain versions at the zoo\'s new sites')
    per_site_zoo, agg_zoo = run_cases(new_site_cases(zoo_books))
    heading('== the zoo paths: Z1 stage 1 with fcgan_star, Z2 SGAN step 2 with '
          'the autoencoder and n_layers_sep, Z3 JointGAN with the dcgan pair '
          '(bf16)')
    zoo = phase_zoo()
    zoo_seconds = time.time() - t_zoo
    print('zoo phases: %.1f s' % zoo_seconds)

    heading('== the host image path: the native PNG decoder against PIL, the '
          'cgan command\'s input path by stage, its train entry point with '
          'the decoder and with --no_native_io')
    t_decode = time.time()
    decode = phase_decode()
    decode_seconds = time.time() - t_decode
    print('decode phase: %.1f s' % decode_seconds)
    heading('== the quality gate (quality_eval, 512 px, ngf 16): its kernel '
          'sites, and those no earlier path has')
    t_gate = time.time()
    gate_books, gate_paths = phase_gate_sites(
        [books] + list(new_paths.values()) + list(ts_paths.values())
        + list(last_paths.values()) + list(zoo_paths.values()))
    heading('== kernels vs plain versions at the gate\'s new sites')
    per_site_gate, agg_gate = run_cases(new_site_cases(gate_books))
    heading('== the gate: train, test, train_ss, test_ss (bound and control '
          'too), in-process, exact launches')
    gate = phase_gate()
    gate_seconds = time.time() - t_gate
    print('gate phases: %.1f s' % gate_seconds)

    heading('== data parallelism (--data_mesh): too few cards raises; two gloo '
          'ranks on one card against one process at batch %d; an NCCL group '
          'of one bitwise equal to no group' % DM_BATCH)
    t_dm = time.time()
    data_mesh = phase_data_mesh()
    dm_seconds = time.time() - t_dm
    print('data-mesh phase: %.1f s' % dm_seconds)

    heading('== spatial parallelism (--spatial_mesh): the row-split IN '
            'entries vs their plain versions; too few cards raises; two '
            'gloo ranks on one card split the height against one process')
    t_sp = time.time()
    per_site_sp, agg_sp = phase_spatial_in()
    agg.update(agg_sp)
    spatial_mesh = phase_spatial_mesh(books)
    sp_seconds = time.time() - t_sp
    print('spatial-mesh phases: %.1f s' % sp_seconds)

    kernels = []
    for name in ('conv3x3', 'convt4s2', 'instance_norm_act', 'conv3x3_dw',
                 'instance_norm_bwd', 'conv4s2', 'conv3x3_in_stats',
                 'instance_norm_apply') + SP_IN_KERNELS:
        a = agg[name]
        run = (readme['gate_on'] if name in agg_r else spatial_mesh
               if name in SP_IN_KERNELS else train16)
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
                             reference_step_bf16=ref_step_bf16),
                  stage1=dict(bf16=stage1_16, f32=stage1_32,
                              sampler_loop_seconds=r_s1['loop_seconds'],
                              sampler_launches=counts_s1),
                  readme=readme,
                  cgan=dict(launches_per_step=CGAN_PER_STEP,
                            launches_per_sample=CGAN_PER_SAMPLE,
                            train=cgan16, chunked=cgan_chunked,
                            chunk_equals_eager=cgan_chunk_eq,
                            reference_step=cgan_ref, sampler=cgan_sampler,
                            bench=cgan_bench),
                  segmentation=dict(segmentation, bench=seg_bench,
                                    launches_per_step=SEG_PER_STEP,
                                    launches_per_forward=SEG_PER_FORWARD),
                  new_sites=per_site_new, new_site_sums=agg_new,
                  new_phases_seconds=new_seconds,
                  two_stage=dict(two_stage, launches_per_step=TS_PER_STEP,
                                 sites=per_site_ts, site_sums=agg_ts,
                                 site_books={
                                     path: {k: {repr(s_): c
                                                for s_, c in v.items()}
                                            for k, v in b.items()}
                                     for path, b in ts_paths.items()},
                                 seconds=ts_seconds),
                  recon=recon_run,
                  last_recipes=dict(
                      cgan_family=family, segmentation_cycle=seg_cycle,
                      resnet_test=resnet,
                      launches_per_step=dict(FAMILY_PER_STEP,
                                             segmentation_cycle=SEGC_PER_STEP),
                      launches_per_forward=dict(
                          segmentation_cycle=SEGC_PER_FORWARD,
                          resnet_9blocks=RESNET_PER_FORWARD),
                      sites=per_site_last, site_sums=agg_last,
                      site_books={
                          path: {k: {repr(s_): c for s_, c in v.items()}
                                 for k, v in b.items()}
                          for path, b in last_paths.items()},
                      seconds=last_seconds),
                  zoo=dict(
                      paths=zoo,
                      launches_per_step={p: z.per_step
                                         for p, z in ZOO.items()},
                      launches_per_sample={p: z.per_sample
                                           for p, z in ZOO.items()},
                      sites=per_site_zoo, site_sums=agg_zoo,
                      site_books={
                          path: {k: {repr(s_): c for s_, c in v.items()}
                                 for k, v in b.items()}
                          for path, b in zoo_paths.items()},
                      seconds=zoo_seconds),
                  decode=dict(decode, seconds=decode_seconds),
                  gate=dict(
                      gate, launches_per_step=GATE_PER_STEP,
                      sites=per_site_gate, site_sums=agg_gate,
                      site_books={
                          path: {k: {repr(s_): c for s_, c in v.items()}
                                 for k, v in b.items()}
                          for path, b in gate_paths.items()},
                      seconds=gate_seconds),
                  data_mesh=dict(data_mesh, seconds=dm_seconds),
                  spatial_mesh=dict(spatial_mesh, in_sites=per_site_sp,
                                    seconds=sp_seconds),
                  new_site_books={
                      path: {k: {repr(s_): c for s_, c in v.items()}
                             for k, v in b.items()}
                      for path, b in new_paths.items()},
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
