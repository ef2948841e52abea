"""CLI option surface.

A copy of supervised_gan_tpu/options/base_options.py: the reference flag
surface (names, defaults, list-valued flags) so the README command lines
parse unchanged.  ``--gpu_ids`` selects the device: ``cuda:<first id>``, or
the CPU for ``-1``.  Flags whose feature is not yet ported raise
NotImplementedError, naming themselves, when given a non-default value.
--data_mesh and the --dcn_* flags are data parallelism (parallel/mesh.py):
the training entry points launch their workers from them (and check them
against --batchSize there); the samplers run one unsharded process.
"""

import argparse
import os

# flag -> its default; another value asks for a feature not yet ported
NOT_YET_PORTED = {
    'spatial_mesh': 0,
}


class BaseOptions:
    def __init__(self):
        self.parser = argparse.ArgumentParser()
        self.initialized = False
        self.isTrain = False

    def initialize(self):
        p = self.parser
        # -- data -------------------------------------------------------- #
        p.add_argument('--dataroot', required=True, help='path to images (with per-phase subfolders)')
        p.add_argument('--batchSize', type=int, default=1, help='input batch size')
        p.add_argument('--loadSize', type=int, default=286, help='scale images to this size')
        p.add_argument('--fineSize', type=int, default=256, help='then crop to this size')
        p.add_argument('--patchSize', type=int, default=70, help='patch size')
        p.add_argument('--input_nc', type=int, default=3, help='# of input image channels')
        p.add_argument('--noise_nc', type=int, default=8, help='# of input noise channels')
        p.add_argument('--noiseSize', type=int, default=1, help='noise image spatial size')
        p.add_argument('--noiseSizeVal', type=int, default=1, help='noise image spatial size at val time')
        p.add_argument('--output_nc', type=int, default=3, help='# of output image channels')
        p.add_argument('--dataset_mode', type=str, default='unaligned', help='unaligned | aligned | single')
        p.add_argument('--which_direction', type=str, default='AtoB', help='AtoB or BtoA')
        p.add_argument('--nThreads', default=2, type=int, help='# threads for loading data')
        p.add_argument('--serial_batches', action='store_true', help='take images in order (no shuffle)')
        p.add_argument('--max_dataset_size', type=int, default=float("inf"), help='max samples per dataset')
        p.add_argument('--resize_or_crop', type=str, default='resize_and_crop',
                       help='resize_and_crop|crop|scale_width|scale_width_and_crop')
        p.add_argument('--no_flip', action='store_true', help='disable horizontal-flip augmentation')
        p.add_argument('--no_rotate', action='store_true', help='disable k*90-degree rotation augmentation')
        p.add_argument('--which_channel', type=str, default='rg', help='channel-select spec, e.g. rg_b')
        # -- architecture ------------------------------------------------- #
        p.add_argument('--ngf', type=int, default=64, help='# of gen filters in first conv layer')
        p.add_argument('--ndf', type=int, default=64, help='# of discrim filters in first conv layer')
        p.add_argument('--which_model_netD', type=str, default='basic', help='selects model to use for netD')
        p.add_argument('--which_model_netG', type=str, default='resnet_9blocks', help='selects model to use for netG')
        p.add_argument('--n_layers_D', type=int, default=[3], nargs='+', help='per-D layer counts (list)')
        p.add_argument('--n_layers_G', type=int, default=5, help='G depth (deconv) or # skip connections (unet)')
        p.add_argument('--scale_factor', type=int, default=[1], nargs='+', help='per-D input scale factors (list)')
        p.add_argument('--norm', type=str, default='instance', help='instance or batch normalization')
        p.add_argument('--no_dropout', action='store_true', help='no dropout for the generator')
        p.add_argument('--use_residual', action='store_true', help='add residual shortcut to G')
        p.add_argument('--add_gaussian_noise', action='store_true', help='add Gaussian noise when upsampling')
        p.add_argument('--gaussian_sigma', type=float, default=0.1, help='std of injected Gaussian noise')
        p.add_argument('--n_layers_G_skip', type=int, default=-1, help='limit # of unet skip connections')
        p.add_argument('--upsample_mode', type=str, default='convt', help='upsample mode, convt or bilinear')
        p.add_argument('--no_share_label_block_weights', action='store_true',
                       help='do not share CRN label-block weights across scales')
        p.add_argument('--n_layers_CRN_block', type=int, default=1, help='# layers in CRN inter blocks')
        p.add_argument('--identity', type=float, default=0.0, help='identity-mapping loss weight (legacy)')
        # -- bookkeeping --------------------------------------------------- #
        p.add_argument('--gpu_ids', type=str, default='0', help='device ids, e.g. 0 or 0,1,2; -1 for CPU')
        p.add_argument('--name', type=str, default='experiment_name', help='experiment name (checkpoint subdir)')
        p.add_argument('--model', type=str, default='cycle_gan', help='which model recipe to use')
        p.add_argument('--checkpoints_dir', type=str, default='./checkpoints', help='models are saved here')
        p.add_argument('--manualSeed', type=int, default=None, help='manual random seed')
        p.add_argument('--pretrained_model_dir', type=str, default='',
                       help='pretrained model dir (defaults to checkpoints_dir/name)')
        # -- display ------------------------------------------------------- #
        p.add_argument('--display_winsize', type=int, default=256, help='display window size')
        p.add_argument('--display_id', type=int, default=1, help='window id of the web display')
        p.add_argument('--display_port', type=int, default=8097, help='visdom port of the web display')
        p.add_argument('--display_single_pane_ncols', type=int, default=0,
                       help='if positive, single visdom pane with this many images per row')
        p.add_argument('--display_title', type=str, default='loss over time', help='title of loss plot')
        # -- segmentation --------------------------------------------------- #
        p.add_argument('--use_sigmoid_ss', action='store_true', help='sigmoid instead of softmax in segmentation')
        p.add_argument('--weights', type=float, default=None, nargs='+',
                       help='per-channel weights for L1 loss in cGAN / CE loss in segmentation')
        # the reference README's SGAN step-2 command uses --weight_L1
        # (README.md:38) but the reference only defines --weights — alias it
        # so the published command runs (same treatment as 'deconv')
        p.add_argument('--weight_L1', dest='weights', type=float, default=None,
                       nargs='+', help='alias for --weights (reference README.md:38)')
        p.add_argument('--valSize', type=int, default=0, help='val image size')
        p.add_argument('--save_val_visuals', action='store_true', help='save val visuals')
        p.add_argument('--best_metric', type=str, default='None', help='metric used to pick the best checkpoint')
        p.add_argument('--which_metric', default=['None'], nargs='+', help='metrics to compute during training')
        p.add_argument('--add_background_onehot', action='store_true', help='add background one-hot class')
        p.add_argument('--add_background_onehot_acc', action='store_true',
                       help='add background one-hot class for accuracy computation')
        # -- two-stage (suffix-1 = label stage, suffix-2 = image stage) ------ #
        p.add_argument('--scale_factor1', type=int, default=[1], nargs='+', help='per-D1 scale factors')
        p.add_argument('--scale_factor2', type=int, default=[1], nargs='+', help='per-D2 scale factors')
        p.add_argument('--which_model_netD1', type=str, default='n_layers')
        p.add_argument('--which_model_netG1', type=str, default='fcgan')
        p.add_argument('--which_model_netF1', type=str, default='fcgan')
        p.add_argument('--ngf1', type=int, default=64)
        p.add_argument('--ndf1', type=int, default=64)
        p.add_argument('--nff1', type=int, default=64)
        p.add_argument('--n_layers_D1', type=int, default=[3], nargs='+')
        p.add_argument('--n_layers_G1', type=int, default=5)
        p.add_argument('--n_layers_F1', type=int, default=5)
        p.add_argument('--no_dropout1', action='store_true')
        p.add_argument('--noise_nc1', type=int, default=256)
        p.add_argument('--noiseSize1', type=int, default=1)
        p.add_argument('--which_model_netD2', type=str, default='n_layers')
        p.add_argument('--which_model_netG2', type=str, default='unet_128')
        p.add_argument('--which_model_netF2', type=str, default='unet_128')
        p.add_argument('--ngf2', type=int, default=64)
        p.add_argument('--ndf2', type=int, default=64)
        p.add_argument('--nff2', type=int, default=64)
        p.add_argument('--n_layers_D2', type=int, default=[3], nargs='+')
        p.add_argument('--n_layers_G2', type=int, default=5)
        p.add_argument('--n_layers_F2', type=int, default=5)
        p.add_argument('--no_dropout2', action='store_true')
        p.add_argument('--noise_nc2', type=int, default=256)
        p.add_argument('--noiseSize2', type=int, default=1)
        p.add_argument('--transform_1to2', type=str, default='None',
                       help='transform from G1 output to G2 input, e.g. bilinear_2')
        p.add_argument('--use_residual1', action='store_true')
        p.add_argument('--use_residual2', action='store_true')
        p.add_argument('--upsample_mode1', type=str, default='convt')
        p.add_argument('--no_share_label_block_weights1', action='store_true')
        p.add_argument('--n_layers_CRN_block1', type=int, default=1)
        p.add_argument('--upsample_mode2', type=str, default='convt')
        p.add_argument('--no_share_label_block_weights2', action='store_true')
        p.add_argument('--n_layers_CRN_block2', type=int, default=1)
        p.add_argument('--n_layers_G1_skip', type=int, default=-1)
        p.add_argument('--n_layers_G2_skip', type=int, default=-1)
        # -- additions of the JAX package (defaults preserve reference behavior) #
        p.add_argument('--compute_dtype', type=str, default='float32',
                       help='dtype for conv compute: float32 | bfloat16 (params stay float32)')
        p.add_argument('--data_mesh', type=int, default=0,
                       help='if >1, train data-parallel: this many worker processes, one a device, each on an equal share of the batch (0 or 1 = one process)')
        p.add_argument('--spatial_mesh', type=int, default=0,
                       help='if >1, spatially partition the image height over this many devices (batch-1 latency scaling; composes with --data_mesh into a 2-D mesh)')
        p.add_argument('--no_pallas', action='store_true',
                       help='disable the hand-written kernels (every conv and '
                            'norm site takes its PyTorch library call)')
        p.add_argument('--no_native_io', action='store_true', help='disable the C++ image decode path')
        p.add_argument('--cache_data', action='store_true',
                       help='cache decoded+resized images in RAM across epochs '
                            '(bit-identical augmentation; for recipe-scale datasets — '
                            'capped at 2 GiB, streams past the cap)')
        p.add_argument('--dcn_coordinator', type=str, default='',
                       help='multi-host: coordinator address host:port of the process group')
        p.add_argument('--dcn_num_processes', type=int, default=0,
                       help='multi-host: total number of processes (0 = single-process)')
        p.add_argument('--dcn_process_id', type=int, default=0,
                       help='multi-host: this process index in [0, dcn_num_processes)')

        self.initialized = True

    def parse(self, args=None):
        if not self.initialized:
            self.initialize()
        self.opt = self.parser.parse_args(args)
        self.opt.isTrain = self.isTrain

        for flag, default in NOT_YET_PORTED.items():
            if getattr(self.opt, flag, default) != default:
                raise NotImplementedError(
                    '--%s is not yet ported to the PyTorch package' % flag)
        for flag in ('data_mesh', 'dcn_num_processes', 'dcn_process_id'):
            if getattr(self.opt, flag) < 0:
                raise ValueError('--%s must be 0 or more, got %d'
                                 % (flag, getattr(self.opt, flag)))
        if self.opt.compute_dtype not in ('float32', 'bfloat16'):
            raise ValueError('--compute_dtype must be float32 or bfloat16, '
                             'got %r' % self.opt.compute_dtype)

        # '-1' (or any negative id) selects the CPU
        str_ids = self.opt.gpu_ids.split(',')
        self.opt.gpu_ids = [int(s) for s in str_ids if int(s) >= 0]

        items = sorted(vars(self.opt).items())
        print('------------ Options -------------')
        for k, v in items:
            print('%s: %s' % (k, v))
        print('-------------- End ---------------')

        expr_dir = os.path.join(self.opt.checkpoints_dir, self.opt.name)
        os.makedirs(expr_dir, exist_ok=True)
        with open(os.path.join(expr_dir, 'opt.txt'), 'wt') as f:
            f.write('------------ Options -------------\n')
            for k, v in items:
                f.write('%s: %s\n' % (k, v))
            f.write('-------------- End ---------------\n')
        return self.opt
