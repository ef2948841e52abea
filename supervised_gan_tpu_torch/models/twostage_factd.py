"""TwoStageFactD: twostage with a factorized second discriminator
(counterpart of supervised_gan_tpu/models/twostage_factd.py; reference
models/twostage_factD_model.py).

D2's prediction at each paired scale i < min(len(D1), len(D2)) is

    mul_padded(transform(D1_i(label part)), D2_i(pair))

(models/common.py mul_padded: D1's map reflection-padded, centred, to
D2's), the label part being the pair's label brought back to label space.
The D2 update trains D2 alone: D1's post-update parameters enter as
constants, and the label part is taken again from the pooled pair
(transform_inverse of its first --input_nc channels).  The G loss's G2 term
goes through the same products with both banks held fixed.  It needs the
conditional binary D2: no --use_multi_class_GAN, no --no_cgan (reference
:23-24).  Everything else is twostage's.
"""

import torch

from .common import cat_channels, mul_padded
from .twostage import TwoStageModel
from ..nn.losses import gan_loss


class TwoStageFactDModel(TwoStageModel):
    def initialize(self, opt):
        if opt.isTrain and (opt.use_multi_class_GAN or opt.no_cgan):
            raise ValueError('twostage_factd needs the conditional binary '
                             'D2: no --use_multi_class_GAN, no --no_cgan')
        TwoStageModel.initialize(self, opt)

    def fact_pred(self, label_part, pair, d1_constant=False):
        """mul_padded(transform(D1_i(label_part)), D2_i(pair)) for each
        paired scale i; D1's maps without a graph with ``d1_constant``."""
        cd = self.compute_dtype
        preds = []
        for d1, d2 in zip(self.netD1, self.netD2):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not d1_constant):
                m1 = d1(label_part, cd)
            preds.append(mul_padded(self.transform(m1), d2(pair, cd)))
        return preds

    def update_D2(self, taps):
        lsgan = not self.opt.no_lsgan2
        nc = self.opt.input_nc
        fakes = self.d2_fakes(taps)
        loss_fake = sum(
            gan_loss(p, False, lsgan) for x in fakes for p in self.fact_pred(
                self.transform_inverse(x[:, :nc]), x, d1_constant=True))
        real = cat_channels(self.input_A, self.input_B)
        loss_real = sum(gan_loss(p, True, lsgan) for p in self.fact_pred(
            self.transform_inverse(self.input_A), real, d1_constant=True))
        loss = (loss_fake / len(fakes) + loss_real) * 0.5
        self._step(self.optD2, loss)
        return loss.detach()

    def g2_gan(self, taps):
        """The G2 term through the factorized predictions: for real_fake the
        label part is transform_inverse(real label), for fake_fake the fake
        label itself (detached with its upsampled copy under
        --detach_G1_from_G2_y)."""
        o = self.opt
        lsgan = not o.no_lsgan2
        terms = []
        if 'real_fake' in o.GAN_losses_G2:
            terms.append((self.transform_inverse(self.input_A),
                          self.pair_of('real_fake', taps)))
        if 'fake_fake' in o.GAN_losses_G2:
            fake_A = taps['fake_A']
            if o.detach_G1_from_G2_y:
                fake_A = fake_A.detach()
            terms.append((fake_A, self.pair_of(
                'fake_fake', taps, detach_label=o.detach_G1_from_G2_y)))
        g2 = sum(self._adversarial(self.fact_pred(label, pair), o.lambda_D2,
                                   lsgan) for label, pair in terms)
        return g2, len(terms)
