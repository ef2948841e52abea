"""TwoStageCycle, the DSGAN recipe: the sampler and the train step.

Counterpart of supervised_gan_tpu/models/twostage_cycle.py: the two stages
of models/twostage.py (G1 and the D1 bank in label space, G2 and the D2
bank on pairs, with its options: the pairs, the multi-class D2, --no_cgan,
the fixed-noise pool) and F2 (unet), which maps images back to labels and
closes the cycle.  The G loss has six terms (reference :337-410):

  G1_GAN + G2_GAN / num_pairs + lambda_A * WeightedL1(fakeB|realA, realB)
  + lambda_B * BCE(F2(realB) ~ realA)
  + lambda_A_cycle * BCE(F2(G2(realA)) ~ realA)
  + lambda_A_cycle * lambda_fake_cycle * BCE(F2(G2(fakeA)) ~ sg(transform(fakeA)))

the L1 term present when real_fake is in --GAN_losses_G2.

One iteration (models/common.py:271-422 there): one recorded forward, then
D1^n, D2^n and G^n updates, the noise redrawn and the forward recorded again
after every repeat when n > 1.  The D losses see detached taps and image-
pool outputs; the G loss backpropagates through the recorded forward with
the post-update D parameters, held fixed, and its gradients are taken with
respect to G1, G2 and F2 only.
"""

from collections import OrderedDict

import torch

from .common import l1_weight_map
from .twostage import TwoStageModel
from ..nn.losses import bce_loss, weighted_l1_loss
from ..utils.images import tensor2im


class TwoStageCycleModel(TwoStageModel):
    METRICS_ORDER = ('G2_GAN', 'G2_real_cycle', 'G2_fake_cycle', 'D2',
                     'G1_GAN', 'D1')
    G_NETS = ('G1', 'G2', 'F2')

    def name(self):
        return 'TwoStageCycleModel'

    def build_more_G(self):
        self.netF2 = self.build_F(self.opt.output_nc, self.opt.input_nc,
                                  suffix='2')

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

    def n_updates(self):
        o = self.opt
        return o.n_update_D1, o.n_update_D2, o.n_update_G

    # ---------------------------------------------------------- training -- #
    def forward_taps(self, noises):
        """The recorded forward: G1, G2 twice and F2 three times."""
        cd = self.compute_dtype
        fake_A = self.netG1(noises['noise1'].to(cd))
        x_in = self._g2_label(fake_A)
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

    def g_loss(self, taps):
        """The six-term G loss of the taps; returns (total, metrics)."""
        o = self.opt
        real_A, real_B = self.input_A, self.input_B
        g1 = self.g1_gan(taps)
        g2, num_pairs = self.g2_gan(taps)
        ce = bce_loss((taps['fake_A_from_real_B'] + 1) / 2, (real_A + 1) / 2)
        real_cycle = bce_loss((taps['recon_real_A'] + 1) / 2,
                              (real_A + 1) / 2)
        fa_t = self.transform(taps['fake_A']).detach()
        fake_cycle = bce_loss((taps['recon_fake_A'] + 1) / 2, (fa_t + 1) / 2)
        total = g1 + g2 / max(num_pairs, 1)
        if 'real_fake' in o.GAN_losses_G2:
            l1 = weighted_l1_loss(taps['fake_B_from_real_A'], real_B,
                                  l1_weight_map(real_A, o.weights))
            total = total + l1 * o.lambda_A
        total = (total + ce * o.lambda_B + real_cycle * o.lambda_A_cycle
                 + fake_cycle * o.lambda_A_cycle * o.lambda_fake_cycle)
        return total, {'G2_GAN': g2, 'G2_real_cycle': real_cycle,
                       'G2_fake_cycle': fake_cycle, 'G1_GAN': g1}

    # ---------------------------------------------------------- sampling -- #
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
