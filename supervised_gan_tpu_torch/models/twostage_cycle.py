"""TwoStageCycle, the DSGAN recipe: the sampler (isTrain=False).

Counterpart of supervised_gan_tpu/models/twostage_cycle.py:64-180 and
491-532.  G1 (fcgan) turns noise1 into a label, ``transform_1to2`` upsamples
it, G2 (CRN) turns the label and noise2 into an image.  The JAX sampler also
loads F2 (:106); F2 is not run on this path and is loaded here once it is
ported.  Training comes with the training slice.
"""

from collections import OrderedDict

import torch

from .two_group import TwoGroupModel
from .. import nn
from ..utils.images import tensor2im


class TwoStageCycleModel(TwoGroupModel):
    def initialize(self, opt):
        if opt.isTrain:
            raise NotImplementedError('twostage_cycle training is not yet '
                                      'ported; only the sampler is')
        TwoGroupModel.initialize(self, opt)
        self.netG1 = self.build_G(opt.input_nc, 0, suffix='1')
        self.netG2 = self.build_G2()
        self.load_network(self.netG1, 'G1', opt.which_epoch)
        self.load_network(self.netG2, 'G2', opt.which_epoch)
        self.netG1.to(self.device)
        self.netG2.to(self.device)

        print('------------ Networks initialized -------------')
        nn.print_network(self.netG1, 'G1')
        nn.print_network(self.netG2, 'G2')
        print('-----------------------------------------------')

    def build_G2(self):
        """G2 maps label -> image with use_fcn forced off (reference
        twostage_cycle_model.py:52-57)."""
        o = self.opt
        return nn.define_G(
            o.input_nc, o.output_nc, o.ngf2, o.which_model_netG2, o.norm,
            not o.no_dropout2, n_layers_G=o.n_layers_G2, use_fcn=False,
            noise_nc=o.noise_nc2, add_gaussian_noise=o.add_gaussian_noise,
            upsample_mode=o.upsample_mode2,
            n_layers_CRN_block=o.n_layers_CRN_block2,
            share_label_weights=not o.no_share_label_block_weights2,
            generator=self.init_generator)

    def _noise_shapes(self):
        o = self.opt
        return {'noise1': (o.batchSize, o.noise_nc1, o.noiseSize1,
                           o.noiseSize1),
                'noise2': (o.batchSize, o.noise_nc2, o.noiseSize2,
                           o.noiseSize2)}

    def test(self):
        shapes = self._noise_shapes()
        self.noise1 = self.noise(shapes['noise1'])
        self.noise2 = self.noise(shapes['noise2'])
        cd = self.compute_dtype
        with torch.no_grad():
            self.fake_A = self.netG1(self.noise1.to(cd))
            self.fake_B_from_fake_A = self.netG2(
                self.transform(self.fake_A), self.noise2.to(cd))
        print('Random check: {}, {}'.format(
            float(self.noise1[0, 0, 0, 0]), float(self.noise2[0, 0, 0, 0])))

    def outputs(self):
        """The tensors one test() call produced."""
        return (self.fake_A, self.fake_B_from_fake_A)

    def get_current_visuals(self, save_as_single_image=False):
        if save_as_single_image:
            ab = torch.cat([self.transform(self.fake_A),
                            self.fake_B_from_fake_A], 1)
            return OrderedDict([('AB', tensor2im(ab))])
        return OrderedDict([
            ('fake_A', tensor2im(self.transform(self.fake_A))),
            ('fake_B', tensor2im(self.fake_B_from_fake_A))])
