"""CGANCycle: the conditional label -> image GAN with an image -> label
reconstructor closing the cycle (reference models/cgan_cycle_model.py),
and what the cycle recipes share (models/cgan2_cycle.py and
models/cgan_causal.py build on it).

Counterpart of supervised_gan_tpu/models/cgan_cycle.py.  G1
(--which_model_netG1) maps the label A to the image B, judged by the D1
bank on (A, B) pairs (B alone with --no_cgan), its fakes through
``pool1``; G2 (--which_model_netG2) maps B back to A.  The G loss
(reference :188-226):

  GAN(D1 on (A, G1(A))) + lambda_A * WeightedL1(G1(A), B)
  + lambda_B * BCE(G2(B) ~ A) + lambda_A_cycle * BCE(G2(G1(A)) ~ A)

One Adam over G1 (lr1) and G2 (lr2), one over D1 (lr1), the clamped
three-rate decay of TwoGroupModel.  One iteration (models/common.py
alternate_updates): the recorded forward, n_update_D1 D1 updates and
n_update_G G updates, the forward recorded again after each update of a
kind repeated more than once.  With --n_update_* above 1 the whole forward
is recorded again, as the JAX package does (cgan_cycle.py:8-13 there; the
reference recomputes fake_B and recon_A only).  --sequential_train loads
the nets named in --which_model_to_load (G1, G2, D1) from
--pretrained_model_dir.  The JAX package's SGAN_TPU_PHASE_F2 layout switch
has no counterpart.
"""

from collections import OrderedDict

import torch

from .base import adam, set_lr
from .common import alternate_updates, g_apply, l1_weight_map
from .pools import init_pool
from .two_group import TwoGroupModel
from .. import nn
from ..nn.losses import bce_loss, gan_loss, weighted_l1_loss
from ..utils.images import tensor2im


def _bce_pm1(pred, target):
    """BCE of a tanh output against a [-1, 1] target, both mapped to
    [0, 1]."""
    return bce_loss((pred + 1) / 2, (target + 1) / 2)


class CGANCycleModel(TwoGroupModel):
    STEP_OUTPUTS = ('_metrics', '_taps')
    METRICS_ORDER = ('G1', 'G2', 'D1')
    G_NETS = ('G1', 'G2')      # the nets of the G optimizer
    MORE_NETS = ()             # other generators, saved and loaded

    def name(self):
        return 'cGANCycleModel'

    def initialize(self, opt):
        TwoGroupModel.initialize(self, opt)
        self.netG1 = self.build_G(opt.input_nc, opt.output_nc, suffix='1')
        self.netG2 = self.build_G(opt.output_nc, opt.input_nc, suffix='2')
        for label in self.MORE_NETS:
            setattr(self, 'net' + label,
                    self.build_G(opt.output_nc, opt.input_nc, suffix='2'))
        if self.isTrain:
            self.netD1 = self.build_D_bank(self.pair_nc(), suffix='1')
            if opt.sequential_train:
                self.load_sequential()
        if not self.isTrain or opt.continue_train:
            for label in self.G_NETS + self.MORE_NETS:
                self.load_network(getattr(self, 'net' + label), label,
                                  opt.which_epoch)
            if self.isTrain:
                self.load_bank(self.netD1, 'D1_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_noise_generator(net, self.noise_generator)

        if self.isTrain:
            self.optG = adam([(self.netG1.parameters(), self.old_lr1),
                              (self.netG2.parameters(), self.old_lr2)],
                             opt.beta1, self.device)
            self.optD1 = adam([(self.netD1.parameters(), self.old_lr1)],
                              opt.beta1, self.device)
            self.build_more_optimizers()
            self.pools = {'pool1': init_pool(
                opt.pool_size, (self.pair_nc(), opt.fineSize, opt.fineSize),
                self.device)}
            if opt.continue_train:
                extra = self.load_full_state(opt.which_epoch, self.nets(),
                                             self.optimizers(), self.pools)
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

    def build_more_optimizers(self):
        """Optimizers besides G's and D1's (the Anti-Labeler's)."""

    def pair_nc(self):
        o = self.opt
        return o.output_nc if o.no_cgan else o.input_nc + o.output_nc

    def load_sequential(self):
        """--sequential_train: G1, G2 and the D1 bank as named in
        --which_model_to_load, from --pretrained_model_dir at
        --which_epoch_sequential, strictly."""
        o = self.opt
        mdir, ep = o.pretrained_model_dir, o.which_epoch_sequential
        for label in self.G_NETS:
            if label in o.which_model_to_load:
                self.load_network(getattr(self, 'net' + label), label, ep,
                                  mdir)
        if 'D1' in o.which_model_to_load:
            self.load_bank(self.netD1, 'D1_%d', ep, mdir)

    def nets(self):
        nets = OrderedDict((label, getattr(self, 'net' + label))
                           for label in self.G_NETS + self.MORE_NETS)
        if self.isTrain:
            nets['D1'] = self.netD1
        return nets

    def optimizers(self):
        return {'G': self.optG, 'D1': self.optD1}

    def apply_learning_rates(self):
        if not self.isTrain:
            return
        for group, lr in zip(self.optG.param_groups,
                             (self.old_lr1, self.old_lr2)):
            set_lr(group, lr)
        set_lr(self.optD1.param_groups[0], self.old_lr1)

    def n_updates(self):
        """(D1, G) updates an iteration."""
        return self.opt.n_update_D1, self.opt.n_update_G

    def pool_queries(self):
        return ['pool1'] * self.n_updates()[0]

    # ---------------------------------------------------------- training -- #
    def draw_noises(self):
        """noise1 and noise2, in this order (the unets ignore them)."""
        o = self.opt
        return (self.noise((o.batchSize, o.noise_nc1, o.noiseSize1,
                            o.noiseSize1)),
                self.noise((o.batchSize, o.noise_nc2, o.noiseSize2,
                            o.noiseSize2)))

    def forward_taps(self, noise1, noise2):
        """The recorded forward: G1(A), G2(B), G2(G1(A))."""
        cd = self.compute_dtype
        fake_B = g_apply(self.netG1, self.input_A, noise1, cd)
        return {'fake_B': fake_B,
                'fake_A': g_apply(self.netG2, self.input_B, noise2, cd),
                'recon_A': g_apply(self.netG2, fake_B, noise2, cd)}

    def _record(self):
        return self.forward_taps(*self.draw_noises())

    def d1_fake(self, taps):
        """The fake pair D1 judges."""
        return self.cat_pair(self.input_A, taps['fake_B'])

    def update_D1(self, taps):
        """One D1 update, 0.5 (fake + real); returns the loss."""
        lsgan = not self.opt.no_lsgan1
        fake = self.query_pool('pool1', self.d1_fake(taps).detach())
        real = self.cat_pair(self.input_A, self.input_B)
        lf = sum(gan_loss(o, False, lsgan)
                 for o in self.bank_apply(self.netD1, fake))
        lr = sum(gan_loss(o, True, lsgan)
                 for o in self.bank_apply(self.netD1, real))
        loss = (lf + lr) * 0.5
        self._step(self.optD1, loss)
        return loss.detach()

    def adversarial(self, fake):
        """G's GAN term on D1's outputs for ``fake``: the logD trick, or the
        negated fake-target loss with --no_logD_trick."""
        o = self.opt
        lsgan = not o.no_lsgan1
        outs = self.bank_apply(self.netD1, fake)
        if o.no_logD_trick:
            return sum(-gan_loss(d, False, lsgan) * lam
                       for d, lam in zip(outs, o.lambda_D1))
        return sum(gan_loss(d, True, lsgan) * lam
                   for d, lam in zip(outs, o.lambda_D1))

    def g_loss(self, taps):
        """The four-term G loss; returns (total, metrics)."""
        o = self.opt
        real_A = self.input_A
        gan = self.adversarial(self.cat_pair(real_A, taps['fake_B']))
        l1 = weighted_l1_loss(taps['fake_B'], self.input_B,
                              l1_weight_map(real_A, o.weights))
        ce = _bce_pm1(taps['fake_A'], real_A)
        cyc = _bce_pm1(taps['recon_A'], real_A)
        total = (gan + l1 * o.lambda_A + ce * o.lambda_B
                 + cyc * o.lambda_A_cycle)
        return total, {'G1': total, 'G2': cyc}

    def update_G(self, taps):
        """One update of the G nets through the D1 bank, held fixed;
        returns the metrics."""
        d_params = list(self.netD1.parameters())
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
        return {k: v.detach() for k, v in metrics.items()}

    def update_D(self, taps):
        """The D-side updates of one round (D1's)."""
        return self.update_D1(taps)

    def train_step(self):
        nd, ng = self.n_updates()
        taps, d1, metrics = alternate_updates(self._record, nd,
                                              self.update_D, ng,
                                              self.update_G)
        self._metrics = dict(metrics, D1=d1)
        self._taps = {k: v.detach() for k, v in taps.items()}

    def get_current_errors(self):
        return OrderedDict((k, float(self._metrics[k]))
                           for k in self.METRICS_ORDER)

    def save(self, label):
        for name in self.G_NETS + self.MORE_NETS:
            self.save_network(getattr(self, 'net' + name), name, label)
        self.save_bank(self.netD1, 'D1_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, self.lrs())

    # ---------------------------------------------------------- sampling -- #
    def test(self):
        """G1 on the label, untransformed; both noises drawn."""
        noise1, noise2 = self.draw_noises()
        self.real_A = self.input_A
        with torch.no_grad():
            self.fake_B = g_apply(self.netG1, self.real_A, noise1,
                                  self.compute_dtype)
        print('Random check: {}, {}'.format(float(noise1[0, 0, 0, 0]),
                                            float(noise2[0, 0, 0, 0])))

    def outputs(self):
        """The tensors one test() call produced."""
        return (self.fake_B,)

    def train_visuals(self):
        t = self._taps
        return [('real_A', tensor2im(self.input_A)),
                ('real_B', tensor2im(self.input_B)),
                ('fake_B', tensor2im(t['fake_B'])),
                ('recon_A', tensor2im(t['recon_A']))]

    def get_current_visuals(self, save_as_single_image=False):
        if self.isTrain:
            return OrderedDict(self.train_visuals())
        if save_as_single_image:
            ab = torch.cat([self.real_A, self.fake_B.to(self.real_A.dtype)],
                           1)
            return OrderedDict([('AB', tensor2im(ab))])
        return OrderedDict([('real_A', tensor2im(self.real_A)),
                            ('fake_B', tensor2im(self.fake_B))])
