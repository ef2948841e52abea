"""Shared base of the two-group (label <-> image) recipes (counterpart of
supervised_gan_tpu/models/two_group.py): which_channel parsing into (A, B)
groups, aligned / single set_input, the transform_1to2 pair, define_G /
the F reconstructor from a suffixed option block and the clamped (lr, lr1,
lr2) linear decay (the G and D-bank builders are BaseModel's)."""

import numpy as np
import torch

from .base import BaseModel, parse_which_channel
from .common import cat_channels
from .. import nn
from ..ops import avg_pool, bilinear_upsample


def make_transform(transform_1to2):
    """The G1-output -> G2-input coupling and its inverse: a bilinear
    x-sc upsample and AvgPool(sc) for ``bilinear_<sc>``, else identities
    (models/common.py:67 of the JAX package; reference models/
    cgan_model.py:51-57)."""
    if 'bilinear' in transform_1to2:
        sc = int(transform_1to2.split('_')[1])
        return (lambda x: bilinear_upsample(x, sc),
                lambda x: avg_pool(x, sc))
    return (lambda x: x), (lambda x: x)


class TwoGroupModel(BaseModel):
    def initialize(self, opt):
        BaseModel.initialize(self, opt)
        groups = parse_which_channel(opt.which_channel)
        if len(groups) != 2:
            raise ValueError('--which_channel must name two groups, got %r'
                             % opt.which_channel)
        self.groups = groups
        opt.input_nc = len(groups[0])
        opt.output_nc = len(groups[1])
        self.transform, self.transform_inverse = make_transform(
            opt.transform_1to2)
        if opt.isTrain:
            self.old_lr = opt.lr
            self.old_lr1 = opt.lr1
            self.old_lr2 = opt.lr2

    # ----------------------------------------------------------- inputs -- #
    STEP_INPUTS = ('input_A', 'input_B')

    @staticmethod
    def _nchw(arr, channels):
        """(B, H, W, 3) float32 numpy -> (B, len(channels), H, W)."""
        t = torch.from_numpy(np.ascontiguousarray(arr[..., channels]))
        return t.permute(0, 3, 1, 2).contiguous()

    def host_inputs(self, input):
        AtoB = self.opt.which_direction == 'AtoB'
        g0, g1 = self.groups
        if self.opt.dataset_mode == 'aligned':
            a, b = (input['A'], input['B']) if AtoB else (input['B'],
                                                          input['A'])
        elif self.opt.dataset_mode == 'single':
            a = b = input['A']
        else:
            raise NotImplementedError(
                'Dataset mode [%s] is not recognized' % self.opt.dataset_mode)
        self.image_paths = input['A_paths' if AtoB else 'B_paths']
        return {'input_A': self._nchw(a, g0), 'input_B': self._nchw(b, g1)}

    def cat_pair(self, a, b):
        """The D input of (conditioning a, generated b): b alone with
        --no_cgan."""
        return b if self.opt.no_cgan else cat_channels(a, b)

    # ---------------------------------------------------------- networks -- #
    def build_F(self, in_nc, out_nc, suffix='2'):
        """The F reconstructor: nff / which_model_netF / n_layers_F with the
        stage's dropout and upsample options (reference twostage_cycle:
        58-63)."""
        o = self.opt

        def g(name):
            return getattr(o, name + suffix)

        return nn.define_G(
            in_nc, out_nc, g('nff'), g('which_model_netF'), o.norm,
            not g('no_dropout'), n_layers_G=g('n_layers_F'), use_fcn=False,
            noise_nc=g('noise_nc'), add_gaussian_noise=o.add_gaussian_noise,
            gaussian_sigma=o.gaussian_sigma, upsample_mode=g('upsample_mode'),
            n_layers_CRN_block=g('n_layers_CRN_block'),
            share_label_weights=not g('no_share_label_block_weights'),
            use_residual=bool(g('use_residual')),
            generator=self.init_generator)

    # --------------------------------------------------------------- lr -- #
    def update_learning_rate(self):
        """Clamped three-rate linear decay (reference
        twostage_cycle_model.py:480-503)."""
        o = self.opt
        lr = max(0, self.old_lr - o.lr / o.niter_decay)
        lr1 = max(0, self.old_lr1 - o.lr1 / o.niter_decay)
        lr2 = max(0, self.old_lr2 - o.lr2 / o.niter_decay)
        print('update learning rate: %f -> %f, %f -> %f'
              % (self.old_lr1, lr1, self.old_lr2, lr2))
        self.old_lr, self.old_lr1, self.old_lr2 = lr, lr1, lr2
        self.apply_learning_rates()

    def apply_learning_rates(self):
        """Write the current rates into the optimizers' groups."""

    def lrs(self):
        return {'lr': self.old_lr, 'lr1': self.old_lr1, 'lr2': self.old_lr2}


class UnalignedInputs:
    """set_input of the recipes fed by the unaligned dataset (cgan2,
    cgan2_cycle, cgan_causal; reference cgan2_model.py:115-126): the A
    image carries the real label (input_A) and the real image (input_B),
    the independently indexed B image the stage-1 fake label
    (input_fake_A)."""
    STEP_INPUTS = ('input_A', 'input_B', 'input_fake_A')

    def host_inputs(self, input):
        g0, g1 = self.groups
        self.image_paths = input['A_paths']
        return {'input_A': self._nchw(input['A'], g0),
                'input_B': self._nchw(input['A'], g1),
                'input_fake_A': self._nchw(input['B'], g0)}
