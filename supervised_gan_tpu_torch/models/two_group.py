"""Shared base of the two-group (label <-> image) recipes, sampling subset
(counterpart of supervised_gan_tpu/models/two_group.py): which_channel
parsing into (A, B) groups, the transform_1to2 coupling and define_G
plumbing from suffixed option blocks."""

from .base import BaseModel, parse_which_channel
from .. import nn
from ..ops import bilinear_upsample


def make_transform(transform_1to2):
    """The G1-output -> G2-input coupling: bilinear x-sc upsample for
    ``bilinear_<sc>``, else identity (models/common.py:67 of the JAX
    package, whose AvgPool inverse comes with the training slice;
    reference models/cgan_model.py:51-57)."""
    if 'bilinear' in transform_1to2:
        sc = int(transform_1to2.split('_')[1])
        return lambda x: bilinear_upsample(x, sc)
    return lambda x: x


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
        self.transform = make_transform(opt.transform_1to2)

    def build_G(self, in_nc, out_nc, suffix=''):
        """define_G from the (optionally suffixed) architecture options,
        weights drawn from the seeded init generator."""
        o = self.opt

        def g(name):
            return getattr(o, name + suffix)

        return nn.define_G(
            in_nc, out_nc, g('ngf'), g('which_model_netG'), o.norm,
            not g('no_dropout'), n_layers_G=g('n_layers_G'),
            use_fcn=g('noiseSize') != 1, noise_nc=g('noise_nc'),
            add_gaussian_noise=o.add_gaussian_noise,
            upsample_mode=g('upsample_mode'),
            n_layers_CRN_block=g('n_layers_CRN_block'),
            share_label_weights=not g('no_share_label_block_weights'),
            generator=self.init_generator)
