"""Benchmark the other published 512 px train recipes: one JSON line each.

    python -m supervised_gan_tpu_torch.bench_extra [--configs NAME ...] \\
        [train flags]

The port's copy of the JAX package's tools/bench_extra.py:36-80, with the
same three configurations and flags (the paths those of this checkout: the
dataroot is never read, opt.txt goes under ./checkpoints/<name>):

  * fcgan_unsup_512   reference README.md "Train a UnsupervisedGAN model":
                      G deconv ngf 32 x 5 from 8 x 8^2 noise, a 3-scale D
                      bank ndf 32, the b channel (stage 1's recipe);
  * cgan_pix2pix_512  reference README.md "Step 2, training a CGAN model":
                      G unet_256 ngf 64 with dropout and injected Gaussian
                      noise, a 2-scale D bank (n_layers 3 and 4) ndf 64 on
                      cat(A, B), WeightedL1 2 4 (SGAN step 2);
  * fcgan_joint_512   reference README.md "Train a JointGAN model": the
                      UnsupervisedGAN command on rg_b.

Each is timed by bench.main (bench.py: warm-up, windows per step and in
chunks of a captured step, a trace on the card), in this process, one
after the other; flags given on the command line follow each
configuration's and take their place.  Every record carries ``config``.
"""

import argparse
import gc
import sys

import torch

from . import bench

FCGAN_ARGS = [
    '--dataroot', './datasets/unused', '--name', 'bench_fcgan_unsup',
    '--model', 'fcgan', '--which_direction', 'A',
    '--dataset_mode', 'single', '--loadSize', '512', '--fineSize', '512',
    '--batchSize', '1', '--input_nc', '2',
    '--which_model_netG', 'deconv', '--n_layers_G', '5', '--ngf', '32',
    '--which_model_netD', 'n_layers', '--n_layers_D', '3', '3', '3',
    '--ndf', '32', '--scale_factor', '1', '2', '4',
    '--lambda_D', '0.5', '0.4', '0.1',
    '--noise_nc', '8', '--noiseSize', '8', '--norm', 'instance',
    '--no_dropout', '--n_update_G', '2', '--no_lsgan',
    '--which_channel', 'b', '--manualSeed', '0', '--lr', '0.00002',
    '--checkpoints_dir', './checkpoints', '--display_id', '0',
    '--compute_dtype', 'bfloat16',
]

CGAN_ARGS = [
    '--dataroot', './datasets/unused', '--name', 'bench_cgan_pix2pix',
    '--model', 'cgan', '--which_direction', 'AtoB',
    '--dataset_mode', 'single', '--loadSize', '1024', '--fineSize', '512',
    '--batchSize', '1', '--input_nc', '2', '--output_nc', '1',
    '--which_model_netG', 'unet_256', '--ngf', '64',
    '--which_model_netD', 'n_layers', '--n_layers_D', '3', '4',
    '--ndf', '64', '--scale_factor', '1', '1', '--lambda_D', '0.5', '0.5',
    '--lambda_A', '10', '--noise_nc', '8', '--noiseSize', '4',
    '--norm', 'instance', '--n_update_G', '2', '--weight_L1', '2', '4',
    '--no_lsgan', '--manualSeed', '0', '--add_gaussian_noise',
    '--which_channel', 'rg_b', '--lr', '0.00002',
    '--checkpoints_dir', './checkpoints', '--display_id', '0',
    '--compute_dtype', 'bfloat16',
]

JOINTGAN_ARGS = list(FCGAN_ARGS)
JOINTGAN_ARGS[JOINTGAN_ARGS.index('--which_channel') + 1] = 'rg_b'
JOINTGAN_ARGS[JOINTGAN_ARGS.index('bench_fcgan_unsup')] = 'bench_jointgan'

CONFIGS = {'fcgan_unsup_512': FCGAN_ARGS, 'cgan_pix2pix_512': CGAN_ARGS,
           'fcgan_joint_512': JOINTGAN_ARGS}


def run(config, args=(), **kw):
    """bench.main on one configuration (``kw``: its window and trace
    parameters); returns the record, with ``config``."""
    return bench.main(list(args), base=CONFIGS[config],
                      metric_name=config[:-len('_512')],
                      record_extra={'config': config}, **kw)


def main(args=None, **kw):
    """Every configuration named by --configs (default: all three) in turn;
    returns their records."""
    ap = argparse.ArgumentParser(prog='bench_extra')
    ap.add_argument('--configs', nargs='+', default=list(CONFIGS),
                    choices=list(CONFIGS))
    known, rest = ap.parse_known_args(sys.argv[1:] if args is None
                                      else list(args))
    records = []
    for config in known.configs:
        records.append(run(config, rest, **kw))
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return records


if __name__ == '__main__':
    main()
