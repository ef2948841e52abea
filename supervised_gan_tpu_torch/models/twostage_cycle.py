"""TwoStageCycle, the DSGAN recipe: the sampler and the train step.

Counterpart of supervised_gan_tpu/models/twostage_cycle.py.  Stage 1: G1
(fcgan) synthesizes labels from noise1, judged by the D1 bank in label
space against AvgPool-downsampled real labels.  Stage 2: G2 (CRN) turns
transform(fake label) or the real label, with noise2, into an image, judged
by the D2 bank on (label, image) pairs; F2 (unet) maps images back to
labels, closing the cycle.  The G loss has six terms (reference :337-410):

  G1_GAN + G2_GAN / num_pairs + lambda_A * WeightedL1(fakeB|realA, realB)
  + lambda_B * BCE(F2(realB) ~ realA)
  + lambda_A_cycle * BCE(F2(G2(realA)) ~ realA)
  + lambda_A_cycle * lambda_fake_cycle * BCE(F2(G2(fakeA)) ~ sg(transform(fakeA)))

One iteration (models/common.py:271-422 there): one recorded forward, then
D1^n, D2^n and G^n updates, the noise redrawn and the forward recorded again
after every repeat when n > 1.  The D losses see detached taps and image-
pool outputs; the G loss backpropagates through the recorded forward with
the post-update D parameters, held fixed, and its gradients are taken with
respect to G1, G2 and F2 only.
"""

from collections import OrderedDict

import torch

from .pools import init_pool
from .base import adam, set_lr
from .common import cat_channels, l1_weight_map
from .two_group import TwoGroupModel
from .. import nn
from ..nn.losses import bce_loss, gan_loss, weighted_l1_loss
from ..utils.images import tensor2im

METRICS_ORDER = ('G2_GAN', 'G2_real_cycle', 'G2_fake_cycle', 'D2', 'G1_GAN',
                 'D1')


def _unported_training_flags(opt):
    return [flag for flag, on in (
        ('--use_multi_class_GAN', opt.use_multi_class_GAN),
        ('--use_fixed_noise1', opt.use_fixed_noise1),
        ('--no_cgan', opt.no_cgan),
        ('--GAN_losses_D2 %s' % ' '.join(opt.GAN_losses_D2),
         opt.GAN_losses_D2 != ['real_fake']),
        ('--GAN_losses_G2 %s' % ' '.join(opt.GAN_losses_G2),
         opt.GAN_losses_G2 != ['real_fake']))
        if on]


class TwoStageCycleModel(TwoGroupModel):
    STEP_OUTPUTS = ('_metrics', '_taps')

    def initialize(self, opt):
        if opt.isTrain and _unported_training_flags(opt):
            raise NotImplementedError(
                'twostage_cycle training with %s is not yet ported'
                % ', '.join(_unported_training_flags(opt)))
        TwoGroupModel.initialize(self, opt)
        self.netG1 = self.build_G(opt.input_nc, 0, suffix='1')
        self.netG2 = self.build_G2()
        self.netF2 = self.build_F(opt.output_nc, opt.input_nc, suffix='2')
        if self.isTrain:
            self.netD1 = self.build_D_bank(opt.input_nc, suffix='1')
            self.netD2 = self.build_D_bank(opt.input_nc + opt.output_nc,
                                           suffix='2')
        if self.isTrain and opt.sequential_train:
            self.load_sequential()
        if not self.isTrain or opt.continue_train:
            self.load_network(self.netG1, 'G1', opt.which_epoch)
            self.load_network(self.netG2, 'G2', opt.which_epoch)
            self.load_network(self.netF2, 'F2', opt.which_epoch)
            if self.isTrain:
                self.load_bank(self.netD1, 'D1_%d', opt.which_epoch)
                self.load_bank(self.netD2, 'D2_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_noise_generator(net, self.noise_generator)

        if self.isTrain:
            self.optG = adam([(self.netG1.parameters(), self.old_lr1),
                              (self.netG2.parameters(), self.old_lr2),
                              (self.netF2.parameters(), self.old_lr2)],
                             opt.beta1, self.device)
            self.optD1 = adam([(self.netD1.parameters(), self.old_lr1)],
                              opt.beta1, self.device)
            self.optD2 = adam([(self.netD2.parameters(), self.old_lr2)],
                              opt.beta1, self.device)
            fs, a_small = opt.fineSize, self._label_space_size()
            self.pools = {
                'pool1': init_pool(opt.pool_size,
                                   (opt.input_nc, a_small, a_small),
                                   self.device),
                'pool2': init_pool(opt.pool_size,
                                   (opt.input_nc + opt.output_nc, fs, fs),
                                   self.device)}
            if opt.continue_train:
                extra = self.load_full_state(
                    opt.which_epoch, self.nets(), self.optimizers(),
                    self.pools)
                if extra is not None:
                    self.old_lr = extra['lr']
                    self.old_lr1 = extra['lr1']
                    self.old_lr2 = extra['lr2']
                    self.apply_learning_rates()

        print('------------ Networks initialized -------------')
        for label, net in self.nets().items():
            if isinstance(net, torch.nn.ModuleList):
                for i, d in enumerate(net):
                    nn.print_network(d, '%s_%d' % (label, i))
            else:
                nn.print_network(net, label)
        print('-----------------------------------------------')

    def load_sequential(self):
        """--sequential_train: each net named in --which_model_to_load (G1,
        G2, F2, D1, D2) from --pretrained_model_dir at
        --which_epoch_sequential, strictly (twostage_cycle.py:90-102 there);
        the others keep their init.  A --continue_train load that follows
        overrides it."""
        o = self.opt
        mdir, ep = o.pretrained_model_dir, o.which_epoch_sequential
        for label in ('G1', 'G2', 'F2'):
            if label in o.which_model_to_load:
                self.load_network(getattr(self, 'net' + label), label, ep,
                                  mdir)
        for label in ('D1', 'D2'):
            if label in o.which_model_to_load:
                self.load_bank(getattr(self, 'net' + label), label + '_%d',
                               ep, mdir)

    def nets(self):
        nets = OrderedDict([('G1', self.netG1), ('G2', self.netG2),
                            ('F2', self.netF2)])
        if self.isTrain:
            nets['D1'] = self.netD1
            nets['D2'] = self.netD2
        return nets

    def optimizers(self):
        return {'G': self.optG, 'D1': self.optD1, 'D2': self.optD2}

    def build_G2(self):
        """G2 maps label -> image with use_fcn forced off (reference
        twostage_cycle_model.py:52-57)."""
        o = self.opt
        return nn.define_G(
            o.input_nc, o.output_nc, o.ngf2, o.which_model_netG2, o.norm,
            not o.no_dropout2, n_layers_G=o.n_layers_G2, use_fcn=False,
            noise_nc=o.noise_nc2, add_gaussian_noise=o.add_gaussian_noise,
            gaussian_sigma=o.gaussian_sigma, upsample_mode=o.upsample_mode2,
            n_layers_CRN_block=o.n_layers_CRN_block2,
            share_label_weights=not o.no_share_label_block_weights2,
            use_residual=o.use_residual2, generator=self.init_generator)

    def _label_space_size(self):
        # D1's real side is transform_inverse(real_A)
        if 'bilinear' in self.opt.transform_1to2:
            return self.opt.fineSize // int(self.opt.transform_1to2.split('_')[1])
        return self.opt.fineSize

    def _noise_shapes(self):
        o = self.opt
        return {'noise1': (o.batchSize, o.noise_nc1, o.noiseSize1,
                           o.noiseSize1),
                'noise2': (o.batchSize, o.noise_nc2, o.noiseSize2,
                           o.noiseSize2)}

    def apply_learning_rates(self):
        if not self.isTrain:
            return
        for group, lr in zip(self.optG.param_groups,
                             (self.old_lr1, self.old_lr2, self.old_lr2)):
            set_lr(group, lr)
        set_lr(self.optD1.param_groups[0], self.old_lr1)
        set_lr(self.optD2.param_groups[0], self.old_lr2)

    def pool_queries(self):
        return (['pool1'] * self.opt.n_update_D1
                + ['pool2'] * self.opt.n_update_D2)

    # ---------------------------------------------------------- training -- #
    def draw_noises(self):
        shapes = self._noise_shapes()
        return {'noise1': self.noise(shapes['noise1']),
                'noise2': self.noise(shapes['noise2'])}

    def forward_taps(self, noises):
        """The recorded forward: G1, G2 twice and F2 three times."""
        cd = self.compute_dtype
        fake_A = self.netG1(noises['noise1'].to(cd))
        x_in = self.transform(fake_A)
        if self.opt.detach_G1_from_G2_x:
            x_in = x_in.detach()
        n2 = noises['noise2'].to(cd)
        fake_A_from_real_B = self.netF2(self.input_B.to(cd))
        fake_B_from_real_A = self.netG2(self.input_A.to(cd), n2)
        fake_B_from_fake_A = self.netG2(x_in, n2)
        return {'fake_A': fake_A,
                'fake_A_from_real_B': fake_A_from_real_B,
                'fake_B_from_real_A': fake_B_from_real_A,
                'fake_B_from_fake_A': fake_B_from_fake_A,
                'recon_real_A': self.netF2(fake_B_from_real_A),
                'recon_fake_A': self.netF2(fake_B_from_fake_A)}

    def _record(self):
        return self.forward_taps(self.draw_noises())

    def update_D1(self, taps):
        lsgan = not self.opt.no_lsgan1
        fake = self.query_pool('pool1', taps['fake_A'].detach())
        real = self.transform_inverse(self.input_A)
        lf = sum(gan_loss(o, False, lsgan)
                 for o in self.bank_apply(self.netD1, fake))
        lr = sum(gan_loss(o, True, lsgan)
                 for o in self.bank_apply(self.netD1, real))
        loss = (lf + lr) * 0.5
        self._step(self.optD1, loss)
        return loss.detach()

    def update_D2(self, taps):
        lsgan = not self.opt.no_lsgan2
        fake = self.query_pool(
            'pool2',
            cat_channels(self.input_A, taps['fake_B_from_real_A']).detach())
        real = cat_channels(self.input_A, self.input_B)
        loss_fake = sum(gan_loss(o, False, lsgan)
                        for o in self.bank_apply(self.netD2, fake))
        loss_real = sum(gan_loss(o, True, lsgan)
                        for o in self.bank_apply(self.netD2, real))
        loss = (loss_fake + loss_real) * 0.5
        self._step(self.optD2, loss)
        return loss.detach()

    def _adversarial(self, outs, lambdas, lsgan):
        if self.opt.no_logD_trick:
            return sum(-gan_loss(o, False, lsgan) * lam
                       for o, lam in zip(outs, lambdas))
        return sum(gan_loss(o, True, lsgan) * lam
                   for o, lam in zip(outs, lambdas))

    def g_loss(self, taps):
        """The six-term G loss of the taps; returns (total, metrics)."""
        o = self.opt
        real_A, real_B = self.input_A, self.input_B
        g1 = self._adversarial(self.bank_apply(self.netD1, taps['fake_A']),
                               o.lambda_D1, not o.no_lsgan1)
        pair = cat_channels(real_A, taps['fake_B_from_real_A'])
        g2 = self._adversarial(self.bank_apply(self.netD2, pair),
                               o.lambda_D2, not o.no_lsgan2)
        l1 = weighted_l1_loss(taps['fake_B_from_real_A'], real_B,
                              l1_weight_map(real_A, o.weights))
        ce = bce_loss((taps['fake_A_from_real_B'] + 1) / 2, (real_A + 1) / 2)
        real_cycle = bce_loss((taps['recon_real_A'] + 1) / 2,
                              (real_A + 1) / 2)
        fa_t = self.transform(taps['fake_A']).detach()
        fake_cycle = bce_loss((taps['recon_fake_A'] + 1) / 2, (fa_t + 1) / 2)
        total = (g1 + g2 + l1 * o.lambda_A + ce * o.lambda_B
                 + real_cycle * o.lambda_A_cycle
                 + fake_cycle * o.lambda_A_cycle * o.lambda_fake_cycle)
        return total, {'G2_GAN': g2, 'G2_real_cycle': real_cycle,
                       'G2_fake_cycle': fake_cycle, 'G1_GAN': g1}

    def update_G(self, taps):
        d_params = list(self.netD1.parameters()) + list(
            self.netD2.parameters())
        for p in d_params:
            p.requires_grad_(False)
        try:
            total, metrics = self.g_loss(taps)
            params = [p for net in (self.netG1, self.netG2, self.netF2)
                      for p in net.parameters()]
            # inert biases take no part in the forward: their grad is None
            grads = torch.autograd.grad(total, params, allow_unused=True)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        self.optG.zero_grad(set_to_none=True)
        for p, g in zip(params, grads):
            p.grad = g
        self.optG.step()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self):
        o = self.opt
        taps = self._record()
        metrics = {}
        for n_update, update, name in ((o.n_update_D1, self.update_D1, 'D1'),
                                       (o.n_update_D2, self.update_D2, 'D2')):
            for _ in range(n_update):
                metrics[name] = update(taps)
                if n_update > 1:
                    taps = self._record()
        for _ in range(o.n_update_G):
            metrics.update(self.update_G(taps))
            if o.n_update_G > 1:
                taps = self._record()
        self._metrics = metrics
        self._taps = {k: v.detach() for k, v in taps.items()}

    def get_current_errors(self):
        return OrderedDict((k, float(self._metrics[k])) for k in METRICS_ORDER)

    def save(self, label):
        self.save_network(self.netG1, 'G1', label)
        self.save_network(self.netG2, 'G2', label)
        self.save_network(self.netF2, 'F2', label)
        self.save_bank(self.netD1, 'D1_%d', label)
        self.save_bank(self.netD2, 'D2_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, self.lrs())

    # ---------------------------------------------------------- sampling -- #
    def test(self):
        noises = self.draw_noises()
        self.noise1, self.noise2 = noises['noise1'], noises['noise2']
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
        if self.isTrain:
            t = self._taps
            return OrderedDict([
                ('real_A', tensor2im(self.input_A)),
                ('fake_B_real_A', tensor2im(t['fake_B_from_real_A'])),
                ('fake_A', tensor2im(self.transform(t['fake_A']))),
                ('fake_B_fake_A', tensor2im(t['fake_B_from_fake_A'])),
                ('fake_A_real_B', tensor2im(t['fake_A_from_real_B'])),
                ('real_B', tensor2im(self.input_B)),
                ('recon_real_A', tensor2im(t['recon_real_A'])),
                ('recon_fake_A', tensor2im(t['recon_fake_A']))])
        if save_as_single_image:
            ab = torch.cat([self.transform(self.fake_A),
                            self.fake_B_from_fake_A], 1)
            return OrderedDict([('AB', tensor2im(ab))])
        return OrderedDict([
            ('fake_A', tensor2im(self.transform(self.fake_A))),
            ('fake_B', tensor2im(self.fake_B_from_fake_A))])
