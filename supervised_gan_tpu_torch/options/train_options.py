"""Training options: a copy of supervised_gan_tpu/options/train_options.py
(reference options/train_options.py:4-66).  --steps_per_dispatch runs its
chunks as replays of the train step captured as a CUDA graph (on the CPU,
as eager steps)."""

from .base_options import BaseOptions


class TrainOptions(BaseOptions):
    def initialize(self):
        BaseOptions.initialize(self)
        p = self.parser
        p.add_argument('--display_freq', type=int, default=100, help='steps between image displays')
        p.add_argument('--print_freq', type=int, default=100, help='steps between console loss prints')
        p.add_argument('--save_latest_freq', type=int, default=5000, help='steps between latest-checkpoint saves')
        p.add_argument('--save_epoch_freq', type=int, default=5, help='epochs between numbered checkpoint saves')
        p.add_argument('--continue_train', action='store_true', help='resume from a saved checkpoint')
        p.add_argument('--phase', type=str, default='train', help='train, val, test, etc')
        p.add_argument('--which_epoch', type=str, default='latest', help='checkpoint label to load')
        p.add_argument('--niter', type=int, default=100, help='# epochs at the initial learning rate')
        p.add_argument('--niter_decay', type=int, default=100, help='# epochs of linear lr decay to zero')
        p.add_argument('--beta1', type=float, default=0.5, help='adam beta1')
        p.add_argument('--lr', type=float, default=0.0002, help='initial adam learning rate')
        p.add_argument('--no_lsgan', action='store_true', help='vanilla (BCE) GAN instead of least-squares GAN')
        p.add_argument('--lambda_A', type=float, default=10.0, help='weight for regression loss (A -> B)')
        p.add_argument('--lambda_B', type=float, default=10.0, help='weight for regression loss (B -> A)')
        p.add_argument('--n_update_G', type=int, default=1, help='# of G updates per iteration')
        p.add_argument('--n_update_D', type=int, default=1, help='# of D updates per iteration')
        p.add_argument('--lambda_D', type=float, default=[1.0], nargs='+', help='per-discriminator loss weights')
        p.add_argument('--pool_size', type=int, default=50, help='replay buffer size for generated images')
        p.add_argument('--no_html', action='store_true', help='do not write the HTML training report')
        p.add_argument('--no_cgan', action='store_true', help='unconditional D (drop the conditioning input)')
        p.add_argument('--noise_pool_size', type=int, default=100, help='fixed-noise pool size')
        p.add_argument('--optimizer', type=str, default='adam', help='which optimizer to use')
        p.add_argument('--clamp_lower', type=float, default=-0.01)
        p.add_argument('--clamp_upper', type=float, default=0.01)
        p.add_argument('--train_D_on_fake_fake_pair', action='store_true')
        p.add_argument('--train_G_on_fake_fake_pair', action='store_true')
        p.add_argument('--pool_reject_prob', type=float, default=0.5, help='pool swap-rejection probability')
        p.add_argument('--really_CausalGAN', action='store_true', help='G maximizes Anti-Labeler NLL')
        p.add_argument('--lambda_fake_cycle', type=float, default=1.0, help='fake-cycle loss weight')
        p.add_argument('--which_model_to_load', nargs='+', default=[''], help='pretrained subnets to load')
        p.add_argument('--which_model_to_load_label', nargs='+', default=[''])
        p.add_argument('--no_logD_trick', action='store_true', help='use -log(1-D) instead of log(D) for G')
        # two-stage
        p.add_argument('--lr1', type=float, default=0.0002, help='stage-1 adam learning rate')
        p.add_argument('--lr2', type=float, default=0.0002, help='stage-2 adam learning rate')
        p.add_argument('--lambda_D1', type=float, default=[1.0], nargs='+')
        p.add_argument('--no_lsgan1', action='store_true')
        p.add_argument('--n_update_D1', type=int, default=1)
        p.add_argument('--lambda_D2', type=float, default=[1.0], nargs='+')
        p.add_argument('--no_lsgan2', action='store_true')
        p.add_argument('--n_update_D2', type=int, default=1)
        p.add_argument('--sequential_train', action='store_true', help='load pretrained stage nets before training')
        p.add_argument('--which_epoch_sequential', type=str, default='seq', help='epoch label for sequential loading')
        p.add_argument('--use_multi_class_GAN', action='store_true', help='3-way classification in D2')
        p.add_argument('--detach_G1_from_G2_x', action='store_true')
        p.add_argument('--detach_G1_from_G2_y', action='store_true')
        p.add_argument('--GAN_losses_D2', nargs='+', default=['real_fake'], help='pairs in the D2 GAN loss')
        p.add_argument('--GAN_losses_G2', nargs='+', default=['real_fake'], help='pairs in the G2 GAN loss')
        p.add_argument('--use_random_crop_G2', action='store_true')
        p.add_argument('--random_crop_size', type=int, default=512)
        p.add_argument('--lambda_A_cycle', type=float, default=10.0, help='A->B->A cycle loss weight')
        p.add_argument('--lambda_B_cycle', type=float, default=10.0, help='B->A->B cycle loss weight')
        p.add_argument('--use_fixed_noise1', action='store_true', help='sample noise1 from a fixed pool')
        p.add_argument('--lambda_G1', type=float, default=1, help='weight for G1 GAN loss')
        p.add_argument('--lambda_G2', type=float, default=1, help='weight for G2 GAN loss')

        p.add_argument('--profile_dir', type=str, default='',
                       help='if set, write a torch.profiler trace of steps '
                            '10-20 into this directory (*.pt.trace.json)')
        p.add_argument('--steps_per_dispatch', type=int, default=1,
                       help='run this many training iterations as one '
                            'chunk: replays of the train step captured as '
                            'a CUDA graph, no synchronize inside (the same '
                            'draws and state as per-step training; '
                            'display/print/save cadence is respected by '
                            'flushing at boundaries)')
        p.add_argument('--abort_on_nan', action='store_true',
                       help='stop training when printed metrics go '
                            'non-finite instead of burning the remaining '
                            'epochs on a poisoned state (off by default: '
                            'the reference trains through NaN)')

        self.isTrain = True
