"""CGAN2Cycle: cgan_cycle fed by the unaligned dataset, whose B side
carries stage-1 fake labels (reference models/cgan2_cycle_model.py).

Counterpart of supervised_gan_tpu/models/cgan2_cycle.py.  The recorded
forward runs G1 on the real and on the fake label, G2 on the real image
and on both of G1's images; --train_D_on_fake_fake_pair and
--train_G_on_fake_fake_pair put the (fake label, G1(fake label)) pair in
place of the real one in D1's and G's loss.  The G loss (reference
:202-245):

  GAN(D1 on the chosen pair) + lambda_A * WeightedL1(G1(A), B)
  + lambda_B * BCE(G2(B) ~ A)
  + lambda_A_cycle * (BCE(G2(G1(A)) ~ A)
                      + lambda_fake_cycle * BCE(G2(G1(fake A)) ~ fake A))

the L1 term absent with --train_G_on_fake_fake_pair.
"""

from .cgan_cycle import CGANCycleModel, _bce_pm1
from .common import g_apply, l1_weight_map
from .two_group import UnalignedInputs
from ..nn.losses import weighted_l1_loss
from ..utils.images import tensor2im


class CGAN2CycleModel(UnalignedInputs, CGANCycleModel):
    METRICS_ORDER = ('G1', 'real_cycle', 'fake_cycle', 'D1')

    def forward_taps(self, noise1, noise2):
        """G1(A), G1(fake A), G2(B), G2(G1(A)), G2(G1(fake A))."""
        cd = self.compute_dtype
        f_real = g_apply(self.netG1, self.input_A, noise1, cd)
        f_fake = g_apply(self.netG1, self.input_fake_A, noise1, cd)
        return {'fake_B_from_real_A': f_real,
                'fake_B_from_fake_A': f_fake,
                'fake_A_from_real_B': g_apply(self.netG2, self.input_B,
                                              noise2, cd),
                'recon_real_A': g_apply(self.netG2, f_real, noise2, cd),
                'recon_fake_A': g_apply(self.netG2, f_fake, noise2, cd)}

    def chosen_pair(self, taps, fake_fake):
        if fake_fake:
            return self.cat_pair(self.input_fake_A,
                                 taps['fake_B_from_fake_A'])
        return self.cat_pair(self.input_A, taps['fake_B_from_real_A'])

    def d1_fake(self, taps):
        return self.chosen_pair(taps, self.opt.train_D_on_fake_fake_pair)

    def g_loss(self, taps):
        o = self.opt
        real_A = self.input_A
        gan = self.adversarial(self.chosen_pair(
            taps, o.train_G_on_fake_fake_pair))
        if o.train_G_on_fake_fake_pair:
            l1 = 0.0
        else:
            l1 = weighted_l1_loss(taps['fake_B_from_real_A'], self.input_B,
                                  l1_weight_map(real_A, o.weights))
        ce = _bce_pm1(taps['fake_A_from_real_B'], real_A)
        real_cycle = _bce_pm1(taps['recon_real_A'], real_A)
        fake_cycle = _bce_pm1(taps['recon_fake_A'], self.input_fake_A)
        total = (gan + l1 * o.lambda_A + ce * o.lambda_B
                 + real_cycle * o.lambda_A_cycle
                 + fake_cycle * o.lambda_A_cycle * o.lambda_fake_cycle)
        return total, {'G1': total, 'real_cycle': real_cycle,
                       'fake_cycle': fake_cycle}

    def train_visuals(self):
        t = self._taps
        return [('real_A', tensor2im(self.input_A)),
                ('fake_B_real_A', tensor2im(t['fake_B_from_real_A'])),
                ('fake_A', tensor2im(self.input_fake_A)),
                ('fake_B_fake_A', tensor2im(t['fake_B_from_fake_A'])),
                ('fake_A_real_B', tensor2im(t['fake_A_from_real_B'])),
                ('real_B', tensor2im(self.input_B)),
                ('recon_real_A', tensor2im(t['recon_real_A'])),
                ('recon_fake_A', tensor2im(t['recon_fake_A']))]
