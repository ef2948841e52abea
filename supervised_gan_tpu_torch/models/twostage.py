"""TwoStage, DSGAN without the F2 reconstructor, and what the two-stage
recipes share (counterpart of supervised_gan_tpu/models/twostage.py; the
cycle recipe, models/twostage_cycle.py, and the factorized-D2 one,
models/twostage_factd.py, build on it).

Stage 1: G1 (fcgan) synthesizes labels from noise1, judged by the D1 bank in
label space against AvgPool-downsampled real labels.  Stage 2: G2 (CRN)
turns transform(fake label) or the real label, with noise2, into an image,
judged by the D2 bank on (label, image) pairs, or on the image alone with
--no_cgan.  The G loss (reference twostage_model.py:371-377):

  lambda_G1 * G1_GAN + lambda_G2 * (G2_GAN / num_pairs + lambda_A * L1)

with an unweighted L1 of G2(real label) against the real image, present
when real_fake is in --GAN_losses_G2.  One iteration is exactly one D1, one
D2 and one G update on one recorded forward, the noise drawn once
(reference :379-395); --sequential_train always loads G1 and the D1 bank.

The options the family shares:
  * --GAN_losses_D2 / --GAN_losses_G2: the pairs, real_fake (the real label
    and G2's image of it) and fake_fake (transform(fake label) and G2's
    image of it, detached from G1 under --detach_G1_from_G2_y in the G
    loss).  D2's fake loss is the mean over its pairs, each queried through
    ``pool2`` in that order.
  * --use_multi_class_GAN: D2 has 3-class logits, real = class 0, the
    real_fake pair class 1 (pool ``pool2_1``), the fake_fake pair class 2
    (``pool2_2``); its loss (l0 + l1 + l2) / 3.  The G2 term takes class 0
    as its target, negated without the logD trick (reference
    twostage_cycle_model.py:363-366).
  * --use_fixed_noise1: noise1 is --batchSize rows of a pool of
    --noise_pool_size draws made once at init (reference
    twostage_cycle_model.py:125-127, 196-197), its slots drawn on the host
    with the pools' decisions and staged with them (models/base.py
    stage_rows), so a captured step holds it.
"""

from collections import OrderedDict

import torch

from .base import adam, set_lr
from .pools import init_pool, pool_fill
from .two_group import TwoGroupModel
from .. import nn
from ..nn.losses import gan_loss, gan_loss_multiclass, weighted_l1_loss
from ..utils.images import tensor2im


class TwoStageModel(TwoGroupModel):
    STEP_OUTPUTS = ('_metrics', '_taps')
    METRICS_ORDER = ('G2_GAN', 'D2', 'G1_GAN', 'D1')
    G_NETS = ('G1', 'G2')

    def name(self):
        return 'TwoStageModel'

    def initialize(self, opt):
        TwoGroupModel.initialize(self, opt)
        self.netG1 = self.build_G(opt.input_nc, 0, suffix='1')
        self.netG2 = self.build_G2()
        self.build_more_G()
        if self.isTrain:
            self.netD1 = self.build_D_bank(opt.input_nc, suffix='1')
            self.netD2 = self.build_D_bank(
                self.d2_nc(), suffix='2',
                num_classes=3 if opt.use_multi_class_GAN else 2)
        if self.isTrain and opt.sequential_train:
            self.load_sequential()
        if not self.isTrain or opt.continue_train:
            for label in self.G_NETS:
                self.load_network(getattr(self, 'net' + label), label,
                                  opt.which_epoch)
            if self.isTrain:
                self.load_bank(self.netD1, 'D1_%d', opt.which_epoch)
                self.load_bank(self.netD2, 'D2_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_noise_generator(net, self.noise_generator)

        if self.isTrain:
            self.optG = adam(
                [(getattr(self, 'net' + label).parameters(), lr)
                 for label, lr in zip(self.G_NETS, self._g_lrs())],
                opt.beta1, self.device)
            self.optD1 = adam([(self.netD1.parameters(), self.old_lr1)],
                              opt.beta1, self.device)
            self.optD2 = adam([(self.netD2.parameters(), self.old_lr2)],
                              opt.beta1, self.device)
            self.pools = self._init_pools()
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

    def build_more_G(self):
        """Generators besides G1 and G2 (the cycle's F2)."""

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

    def load_sequential(self):
        """--sequential_train: G1 and the D1 bank from
        --pretrained_model_dir at --which_epoch_sequential, strictly
        (twostage.py:63-67 there); a --continue_train load that follows
        overrides them."""
        o = self.opt
        mdir, ep = o.pretrained_model_dir, o.which_epoch_sequential
        self.load_network(self.netG1, 'G1', ep, mdir)
        self.load_bank(self.netD1, 'D1_%d', ep, mdir)

    def d2_nc(self):
        o = self.opt
        return o.output_nc if o.no_cgan else o.input_nc + o.output_nc

    def _init_pools(self):
        o = self.opt
        fs, a_small = o.fineSize, self._label_space_size()
        pair = (self.d2_nc(), fs, fs)
        pools = {'pool1': init_pool(o.pool_size, (o.input_nc, a_small,
                                                  a_small), self.device)}
        for name in dict.fromkeys(self.d2_pools()):
            pools[name] = init_pool(o.pool_size, pair, self.device)
        if o.use_fixed_noise1:
            shape = self._noise_shapes()['noise1'][1:]
            npool = init_pool(o.noise_pool_size, shape, self.device)
            if npool is None:
                raise ValueError('--use_fixed_noise1 needs a '
                                 '--noise_pool_size above 0')
            pools['noise1'] = pool_fill(
                npool, self.noise((o.noise_pool_size,) + shape, rows=False))
            self.sampled_pools = ('noise1',)
        return pools

    def nets(self):
        nets = OrderedDict((label, getattr(self, 'net' + label))
                           for label in self.G_NETS)
        if self.isTrain:
            nets['D1'] = self.netD1
            nets['D2'] = self.netD2
        return nets

    def optimizers(self):
        return {'G': self.optG, 'D1': self.optD1, 'D2': self.optD2}

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

    def _g_lrs(self):
        """The G optimizer's group rates: lr1 for G1, lr2 for the rest."""
        return [self.old_lr1] + [self.old_lr2] * (len(self.G_NETS) - 1)

    def apply_learning_rates(self):
        if not self.isTrain:
            return
        for group, lr in zip(self.optG.param_groups, self._g_lrs()):
            set_lr(group, lr)
        set_lr(self.optD1.param_groups[0], self.old_lr1)
        set_lr(self.optD2.param_groups[0], self.old_lr2)

    # ------------------------------------------------------------ pools -- #
    def n_updates(self):
        """(D1, D2, G) updates an iteration."""
        return 1, 1, 1

    def d2_pairs(self):
        """The D2 loss's fake pairs, in the order D2 queries them."""
        if self.opt.use_multi_class_GAN:
            return ['real_fake', 'fake_fake']
        return [p for p in ('real_fake', 'fake_fake')
                if p in self.opt.GAN_losses_D2]

    def d2_pools(self):
        """The pool of each D2 query: ``pool2`` for each pair, or
        ``pool2_1`` / ``pool2_2`` for the multi-class D2's classes 1 and 2."""
        if self.opt.use_multi_class_GAN:
            return ['pool2_1', 'pool2_2']
        return ['pool2'] * len(self.d2_pairs())

    def pool_queries(self):
        """Each recorded forward samples the noise pool first; then D1 and
        D2 query theirs, the forward recorded again after every update of a
        kind repeated more than once (train_step)."""
        record = ['noise1'] if self.opt.use_fixed_noise1 else []
        out = list(record)
        n1, n2, ng = self.n_updates()
        for n, names in ((n1, ['pool1']), (n2, self.d2_pools())):
            for _ in range(n):
                out += names + (record if n > 1 else [])
        return out + (record * ng if ng > 1 else [])

    # ---------------------------------------------------------- training -- #
    def draw_noises(self):
        shapes = self._noise_shapes()
        n1 = (self.sample_pool('noise1') if self.opt.use_fixed_noise1
              else self.noise(shapes['noise1']))
        return {'noise1': n1, 'noise2': self.noise(shapes['noise2'])}

    def forward_taps(self, noises):
        """The recorded forward: G1, then G2 on the real and on the fake
        label."""
        cd = self.compute_dtype
        fake_A = self.netG1(noises['noise1'].to(cd))
        n2 = noises['noise2'].to(cd)
        fake_B_from_real_A = self.netG2(self.input_A.to(cd), n2)
        return {'fake_A': fake_A,
                'fake_B_from_real_A': fake_B_from_real_A,
                'fake_B_from_fake_A': self.netG2(self._g2_label(fake_A), n2)}

    def _g2_label(self, fake_A):
        x_in = self.transform(fake_A)
        return x_in.detach() if self.opt.detach_G1_from_G2_x else x_in

    def _record(self):
        return self.forward_taps(self.draw_noises())

    def pair_of(self, name, taps, detach_label=False):
        """The D2 input of pair ``name`` (real_fake or fake_fake)."""
        if name == 'real_fake':
            return self.cat_pair(self.input_A, taps['fake_B_from_real_A'])
        label = self.transform(taps['fake_A'])
        if detach_label:
            label = label.detach()
        return self.cat_pair(label, taps['fake_B_from_fake_A'])

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

    def d2_fakes(self, taps):
        """The pooled fake pairs of one D2 update, in d2_pairs' order."""
        return [self.query_pool(pool, self.pair_of(name, taps).detach())
                for name, pool in zip(self.d2_pairs(), self.d2_pools())]

    def update_D2(self, taps):
        fakes = self.d2_fakes(taps)
        real = self.cat_pair(self.input_A, self.input_B)
        if self.opt.use_multi_class_GAN:
            # the pairs are classes 1 and 2, real is class 0
            l1, l2, l0 = (sum(gan_loss_multiclass(o, c)
                              for o in self.bank_apply(self.netD2, x))
                          for c, x in ((1, fakes[0]), (2, fakes[1]),
                                       (0, real)))
            loss = (l0 + l1 + l2) / 3
        else:
            lsgan = not self.opt.no_lsgan2
            loss_fake = sum(gan_loss(o, False, lsgan) for x in fakes
                            for o in self.bank_apply(self.netD2, x))
            loss_real = sum(gan_loss(o, True, lsgan)
                            for o in self.bank_apply(self.netD2, real))
            loss = (loss_fake / len(fakes) + loss_real) * 0.5
        self._step(self.optD2, loss)
        return loss.detach()

    def _adversarial(self, outs, lambdas, lsgan, multiclass=False):
        """The G's GAN term on D outputs: the logD trick (real target, or
        class 0), else the negated fake-target loss (negated class 0)."""
        if multiclass:
            sign = -1 if self.opt.no_logD_trick else 1
            return sum(sign * gan_loss_multiclass(o, 0) * lam
                       for o, lam in zip(outs, lambdas))
        if self.opt.no_logD_trick:
            return sum(-gan_loss(o, False, lsgan) * lam
                       for o, lam in zip(outs, lambdas))
        return sum(gan_loss(o, True, lsgan) * lam
                   for o, lam in zip(outs, lambdas))

    def g1_gan(self, taps):
        o = self.opt
        return self._adversarial(self.bank_apply(self.netD1, taps['fake_A']),
                                 o.lambda_D1, not o.no_lsgan1)

    def g2_gan(self, taps):
        """G2's GAN term summed over the --GAN_losses_G2 pairs, and their
        number."""
        o = self.opt
        pairs = [p for p in ('real_fake', 'fake_fake')
                 if p in o.GAN_losses_G2]
        g2 = sum(self._adversarial(
            self.bank_apply(self.netD2, self.pair_of(
                p, taps, detach_label=o.detach_G1_from_G2_y)),
            o.lambda_D2, not o.no_lsgan2, o.use_multi_class_GAN)
            for p in pairs)
        return g2, len(pairs)

    def g_loss(self, taps):
        """lambda_G1 G1_GAN + lambda_G2 (G2_GAN / num_pairs + lambda_A L1);
        returns (total, metrics)."""
        o = self.opt
        g1 = self.g1_gan(taps)
        g2, num_pairs = self.g2_gan(taps)
        total = g1 * o.lambda_G1 + g2 / max(num_pairs, 1) * o.lambda_G2
        if 'real_fake' in o.GAN_losses_G2:
            l1 = weighted_l1_loss(taps['fake_B_from_real_A'], self.input_B)
            total = total + l1 * o.lambda_G2 * o.lambda_A
        return total, {'G2_GAN': g2, 'G1_GAN': g1}

    def update_G(self, taps):
        d_params = list(self.netD1.parameters()) + list(
            self.netD2.parameters())
        for p in d_params:
            p.requires_grad_(False)
        try:
            total, metrics = self.g_loss(taps)
            params = [p for label in self.G_NETS
                      for p in getattr(self, 'net' + label).parameters()]
            # inert biases take no part in the forward: their grad is None
            grads = torch.autograd.grad(total, params, allow_unused=True)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        self.optG.zero_grad(set_to_none=True)
        for p, g in zip(params, grads):
            p.grad = g
        self.optG.step()
        return {k: v.detach() if torch.is_tensor(v) else v
                for k, v in metrics.items()}

    def train_step(self):
        """The recorded forward, then D1^n, D2^n and G^n updates (n from
        n_updates), the forward recorded again after every update of a kind
        repeated more than once."""
        n1, n2, ng = self.n_updates()
        taps = self._record()
        metrics = {}
        for n_update, update, name in ((n1, self.update_D1, 'D1'),
                                       (n2, self.update_D2, 'D2')):
            for _ in range(n_update):
                metrics[name] = update(taps)
                if n_update > 1:
                    taps = self._record()
        for _ in range(ng):
            metrics.update(self.update_G(taps))
            if ng > 1:
                taps = self._record()
        self._metrics = metrics
        self._taps = {k: v.detach() for k, v in taps.items()}

    def get_current_errors(self):
        return OrderedDict((k, float(self._metrics[k]))
                           for k in self.METRICS_ORDER)

    def save(self, label):
        for name in self.G_NETS:
            self.save_network(getattr(self, 'net' + name), name, label)
        self.save_bank(self.netD1, 'D1_%d', label)
        self.save_bank(self.netD2, 'D2_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, self.lrs())

    # ---------------------------------------------------------- sampling -- #
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
        """twostage.py:297-312 there: the label untransformed."""
        if self.isTrain:
            t = self._taps
            return OrderedDict([
                ('fake_A', tensor2im(t['fake_A'])),
                ('fake_B_fake_A', tensor2im(t['fake_B_from_fake_A'])),
                ('real_A', tensor2im(self.input_A)),
                ('real_B', tensor2im(self.input_B)),
                ('fake_B_real_A', tensor2im(t['fake_B_from_real_A']))])
        return OrderedDict([
            ('fake_A', tensor2im(self.fake_A)),
            ('fake_B_fake_A', tensor2im(self.fake_B_from_fake_A))])
