"""CGAN: the conditional label -> image GAN with WeightedL1 (SGAN step 2,
pix2pix; reference models/cgan_model.py, README.md:38).

Counterpart of supervised_gan_tpu/models/cgan.py.  G (--which_model_netG,
unet_256 in the README) maps the label channels A to the image channels B;
a multi-scale PatchGAN bank D judges cat(A, B) pairs, or B alone with
--no_cgan, one image pool holding the (pair of the) fake.  D loss 0.5 (fake
+ real); G loss the logD trick (or --no_logD_trick) weighted by --lambda_D
per scale, plus --lambda_A x WeightedL1(fake_B, real_B) with the per-pixel
weight map of --weight_L1 / --weights.

One iteration (models/common.py alternate_updates): the recorded forward,
n_update_D D updates and n_update_G G updates, the noise (the CRN's noise
input, the injected Gaussian noise, dropout) redrawn and the forward
recorded again after each update of a kind repeated more than once.  The G
loss backpropagates through the recorded forward with the updated D bank
held fixed.

Two reference quirks are kept: the metric ``G_GAN`` is the total (GAN +
L1) (cgan.py:124-125 there), and the lr decay is single-rate and not
clamped at 0 (cgan.py:176-181 there), unlike TwoGroupModel's.
"""

from collections import OrderedDict

import torch

from .base import adam, set_lr
from .common import (PairDiscriminator, alternate_updates, g_apply,
                     l1_weight_map)
from .pools import init_pool
from .two_group import TwoGroupModel
from .. import nn
from ..nn.losses import gan_loss, weighted_l1_loss
from ..utils.images import tensor2im

class CGANModel(PairDiscriminator, TwoGroupModel):
    STEP_OUTPUTS = ('_metrics', 'fake_B')
    METRICS_ORDER = ('G_GAN', 'G_L1', 'D_real', 'D_fake')

    def name(self):
        return 'cGANModel'

    def initialize(self, opt):
        TwoGroupModel.initialize(self, opt)
        self.netG = self.build_G(opt.input_nc, opt.output_nc)
        if self.isTrain:
            pair_nc = opt.output_nc if opt.no_cgan \
                else opt.input_nc + opt.output_nc
            self.netD = self.build_D_bank(pair_nc)
        if not self.isTrain or opt.continue_train:
            self.load_network(self.netG, 'G', opt.which_epoch)
            if self.isTrain:
                self.load_bank(self.netD, 'D_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_noise_generator(net, self.noise_generator)

        if self.isTrain:
            self.optG = adam([(self.netG.parameters(), self.old_lr)],
                             opt.beta1, self.device)
            self.optD = adam([(self.netD.parameters(), self.old_lr)],
                             opt.beta1, self.device)
            self.pools = {'fake': init_pool(
                opt.pool_size, (pair_nc, opt.fineSize, opt.fineSize),
                self.device)}
            if opt.continue_train:
                extra = self.load_full_state(opt.which_epoch, self.nets(),
                                             self.optimizers(), self.pools)
                if extra is not None:
                    self.old_lr = extra['lr']
                    self.apply_learning_rates()

        print('------------ Networks initialized -------------')
        nn.print_network(self.netG, 'G')
        if self.isTrain:
            for i, d in enumerate(self.netD):
                nn.print_network(d, 'D_%d' % i)
        print('-----------------------------------------------')

    def nets(self):
        nets = OrderedDict([('G', self.netG)])
        if self.isTrain:
            nets['D'] = self.netD
        return nets

    def optimizers(self):
        return {'G': self.optG, 'D': self.optD}

    def pool_queries(self):
        return ['fake'] * self.opt.n_update_D

    # ---------------------------------------------------------- training -- #
    def draw_noise(self):
        o = self.opt
        return self.noise((o.batchSize, o.noise_nc, o.noiseSize, o.noiseSize))

    def _record(self):
        return {'fake_B': g_apply(self.netG, self.input_A, self.draw_noise(),
                                  self.compute_dtype)}

    def update_G(self, taps):
        """One G update through the D bank, held fixed; returns the total
        and the scaled L1 term."""
        o = self.opt
        lsgan = not o.no_lsgan
        for p in self.netD.parameters():
            p.requires_grad_(False)
        try:
            fake_B = taps['fake_B']
            outs = self.bank_apply(self.netD, self.pair(fake_B))
            if o.no_logD_trick:
                gan = sum(-gan_loss(d, False, lsgan) * lam
                          for d, lam in zip(outs, o.lambda_D))
            else:
                gan = sum(gan_loss(d, True, lsgan) * lam
                          for d, lam in zip(outs, o.lambda_D))
            l1 = weighted_l1_loss(fake_B, self.input_B, l1_weight_map(
                self.input_A, o.weights)) * o.lambda_A
            total = gan + l1
            self._step(self.optG, total)
        finally:
            for p in self.netD.parameters():
                p.requires_grad_(True)
        return total.detach(), l1.detach()

    def train_step(self):
        o = self.opt
        taps, (d_real, d_fake), (total, l1) = alternate_updates(
            self._record, o.n_update_D, self.update_D, o.n_update_G,
            self.update_G)
        self._metrics = {'G_GAN': total, 'G_L1': l1, 'D_real': d_real,
                         'D_fake': d_fake}
        self.fake_B = taps['fake_B'].detach()

    def get_current_errors(self):
        return OrderedDict((k, float(self._metrics[k]))
                           for k in self.METRICS_ORDER)

    def save(self, label):
        self.save_network(self.netG, 'G', label)
        self.save_bank(self.netD, 'D_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, {'lr': self.old_lr})

    def apply_learning_rates(self):
        if not self.isTrain:
            return
        for o in (self.optG, self.optD):
            set_lr(o.param_groups[0], self.old_lr)

    def update_learning_rate(self):
        """Single-rate linear decay by lr / niter_decay per epoch, not
        clamped at 0 (reference cgan_model.py:254-262)."""
        lr = self.old_lr - self.opt.lr / self.opt.niter_decay
        print('update learning rate: %f -> %f' % (self.old_lr, lr))
        self.old_lr = self.old_lr1 = self.old_lr2 = lr
        self.apply_learning_rates()

    # ---------------------------------------------------------- sampling -- #
    def test(self):
        noise = self.draw_noise()
        self.real_A = self.transform(self.input_A)
        with torch.no_grad():
            self.fake_B = g_apply(self.netG, self.real_A, noise,
                                  self.compute_dtype)
        print('Random check: {}'.format(float(noise[0, 0, 0, 0])))

    def outputs(self):
        """The tensors one test() call produced."""
        return (self.fake_B,)

    def get_current_visuals(self, save_as_single_image=False):
        if self.isTrain:
            return OrderedDict([('real_A', tensor2im(self.input_A)),
                                ('fake_B', tensor2im(self.fake_B)),
                                ('real_B', tensor2im(self.input_B))])
        if save_as_single_image:
            ab = torch.cat([self.real_A, self.fake_B.to(self.real_A.dtype)],
                           1)
            return OrderedDict([('AB', tensor2im(ab))])
        return OrderedDict([('real_A', tensor2im(self.real_A)),
                            ('fake_B', tensor2im(self.fake_B))])
