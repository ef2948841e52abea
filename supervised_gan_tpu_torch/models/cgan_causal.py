"""CGANCausal: a CausalGAN-style cgan2_cycle with a Labeler (G2) and an
Anti-Labeler (LG) (reference models/cgan_causal_model.py, which the
reference's factory never registers; the JAX package registers it, and so
does the port).

Counterpart of supervised_gan_tpu/models/cgan_causal.py.  The forward is
cgan2_cycle's; D1 judges (A, G1(A)) only, and each of D1, LG and G takes
one update an iteration.  The G loss (reference :212-216):

  GAN(D1 on (A, G1(A))) (the logD trick always) + lambda_A * L1(G1(A), B)
  + lambda_B * BCE(G2(B) ~ A) + lambda_A_cycle * BCE(G2(G1(A)) ~ A)
  +/- lambda_A_cycle * BCE(G2(G1(fake A)) ~ fake A)

the last term subtracted with --really_CausalGAN.  The reference's LG loss
is that last BCE, which LG's parameters take no part in (reference
:179-183 against the forward :138-143): LG's Adam sees zero gradients and
LG stays at its init, yet it is saved and loaded.  The JAX package keeps
that quirk (cgan_causal.py:3-12, :150-160 there) and so does the port,
whose LG update steps its Adam on exact zeros.  Unlike the JAX package, a
--continue_train restores the full train state, as every port recipe does.
"""

import torch

from .base import adam, set_lr
from .cgan2_cycle import CGAN2CycleModel
from .cgan_cycle import _bce_pm1
from ..nn.losses import gan_loss, weighted_l1_loss


class CGANCausalModel(CGAN2CycleModel):
    METRICS_ORDER = ('G1', 'G2', 'D1')
    MORE_NETS = ('LG',)

    def name(self):
        return 'CGANCausalModel'

    def build_more_optimizers(self):
        self.optLG = adam([(self.netLG.parameters(), self.old_lr2)],
                          self.opt.beta1, self.device)

    def load_sequential(self):
        """The JAX recipe reads no --sequential_train."""

    def optimizers(self):
        return dict(CGAN2CycleModel.optimizers(self), LG=self.optLG)

    def apply_learning_rates(self):
        CGAN2CycleModel.apply_learning_rates(self)
        if self.isTrain:
            set_lr(self.optLG.param_groups[0], self.old_lr2)

    def n_updates(self):
        return 1, 1

    def d1_fake(self, taps):
        return self.cat_pair(self.input_A, taps['fake_B_from_real_A'])

    def update_LG(self):
        """LG's Adam step on zero gradients: LG does not move."""
        for p in self.netLG.parameters():
            p.grad = torch.zeros_like(p)
        self.optLG.step()

    def update_D(self, taps):
        d1 = self.update_D1(taps)
        self.update_LG()
        return d1

    def g_loss(self, taps):
        o = self.opt
        real_A = self.input_A
        lsgan = not o.no_lsgan1
        outs = self.bank_apply(self.netD1, self.cat_pair(
            real_A, taps['fake_B_from_real_A']))
        gan = sum(gan_loss(d, True, lsgan) * lam
                  for d, lam in zip(outs, o.lambda_D1))
        l1 = weighted_l1_loss(taps['fake_B_from_real_A'], self.input_B)
        lr_term = _bce_pm1(taps['fake_A_from_real_B'], real_A)
        lg_term = _bce_pm1(taps['recon_fake_A'], self.input_fake_A)
        cyc = _bce_pm1(taps['recon_real_A'], real_A)
        pm = -1.0 if o.really_CausalGAN else 1.0
        total = (gan + l1 * o.lambda_A + lr_term * o.lambda_B
                 + cyc * o.lambda_A_cycle + pm * lg_term * o.lambda_A_cycle)
        return total, {'G1': total, 'G2': cyc}

    def train_visuals(self):
        return [v for v in CGAN2CycleModel.train_visuals(self)
                if v[0] != 'fake_A_real_B']
