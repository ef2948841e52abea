"""CGAN2: the conditional GAN fed by the unaligned dataset, whose B side
supplies fake labels a stage-1 GAN wrote to disk (reference
models/cgan2_model.py; it asks for --dataset_mode unaligned).

Counterpart of supervised_gan_tpu/models/cgan2.py.  G runs on the real
and on the fake label with the same noise; --train_D_on_fake_fake_pair and
--train_G_on_fake_fake_pair put the (fake label, G(fake label)) pair in
place of the real one in D's and G's loss (reference :169-233); the L1
term is G's only on the real pair.  The pool rejects a swap with
--pool_reject_prob (reference :79).  Otherwise models/cgan.py: the D bank,
the single-rate unclamped lr decay, the sampler.
"""

from collections import OrderedDict

from .cgan import CGANModel
from .common import alternate_updates, g_apply, l1_weight_map
from .two_group import UnalignedInputs
from ..nn.losses import gan_loss, weighted_l1_loss
from ..utils.images import tensor2im


class CGAN2Model(UnalignedInputs, CGANModel):
    STEP_OUTPUTS = ('_metrics', '_taps')
    METRICS_ORDER = ('G_GAN', 'D_real', 'D_fake')

    def initialize(self, opt):
        if opt.dataset_mode != 'unaligned':
            raise ValueError('--model cgan2 needs --dataset_mode unaligned, '
                             'got %r' % opt.dataset_mode)
        CGANModel.initialize(self, opt)
        if self.isTrain:
            self.pool_rejects['fake'] = opt.pool_reject_prob

    def _record(self):
        noise = self.draw_noise()
        cd = self.compute_dtype
        return {'fake_B_from_real_A': g_apply(self.netG, self.input_A,
                                              noise, cd),
                'fake_B_from_fake_A': g_apply(self.netG, self.input_fake_A,
                                              noise, cd)}

    def chosen_pair(self, taps, fake_fake):
        if fake_fake:
            return self.pair(taps['fake_B_from_fake_A'], self.input_fake_A)
        return self.pair(taps['fake_B_from_real_A'])

    def fake_pair(self, taps):
        return self.chosen_pair(taps, self.opt.train_D_on_fake_fake_pair)

    def update_G(self, taps):
        """One G update through the D bank, held fixed; returns the total."""
        o = self.opt
        lsgan = not o.no_lsgan
        for p in self.netD.parameters():
            p.requires_grad_(False)
        try:
            outs = self.bank_apply(self.netD, self.chosen_pair(
                taps, o.train_G_on_fake_fake_pair))
            if o.no_logD_trick:
                gan = sum(-gan_loss(d, False, lsgan) * lam
                          for d, lam in zip(outs, o.lambda_D))
            else:
                gan = sum(gan_loss(d, True, lsgan) * lam
                          for d, lam in zip(outs, o.lambda_D))
            if o.train_G_on_fake_fake_pair:
                l1 = 0.0
            else:
                l1 = weighted_l1_loss(taps['fake_B_from_real_A'],
                                      self.input_B, l1_weight_map(
                                          self.input_A, o.weights))
            total = gan + l1 * o.lambda_A
            self._step(self.optG, total)
        finally:
            for p in self.netD.parameters():
                p.requires_grad_(True)
        return total.detach()

    def train_step(self):
        o = self.opt
        taps, (d_real, d_fake), total = alternate_updates(
            self._record, o.n_update_D, self.update_D, o.n_update_G,
            self.update_G)
        self._metrics = {'G_GAN': total, 'D_real': d_real, 'D_fake': d_fake}
        self._taps = {k: v.detach() for k, v in taps.items()}

    def get_current_visuals(self, save_as_single_image=False):
        if not self.isTrain:
            return CGANModel.get_current_visuals(self, save_as_single_image)
        t = self._taps
        return OrderedDict([
            ('real_A', tensor2im(self.input_A)),
            ('fake_B_real_A', tensor2im(t['fake_B_from_real_A'])),
            ('fake_A', tensor2im(self.input_fake_A)),
            ('fake_B_fake_A', tensor2im(t['fake_B_from_fake_A'])),
            ('real_B', tensor2im(self.input_B))])
