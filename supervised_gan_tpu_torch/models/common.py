"""What the recipes share (counterpart of supervised_gan_tpu/models/
common.py): the cGAN pair, the WeightedL1 weight map and the factorized
D2's padded product (:78, :92 and :104 there), the alternating update schedule of the one-G recipes (fcgan,
cgan, segmentation; ``build_gan_train_step`` there) and the D update on
(conditioning, generated) pairs that cgan and segmentation share."""

import torch

from ..nn.generators import (CascadedRefinementNetwork, DCGANGenerator,
                             FCGANGenerator, FCGANGeneratorStar)
from ..nn.losses import gan_loss
from ..ops import reflection_pad
from ..parallel import spatial

# the generators that take the noise alone (reference
# models/networks.py:535 and 1067)
NOISE_ONLY = (FCGANGenerator, FCGANGeneratorStar, DCGANGenerator)


def g_apply(net, x, noise, dtype, activation='tanh'):
    """A generator in ``dtype`` (models/common.py:43-60 there): the fcgan,
    fcgan_star and dcgan generators take the noise alone, the CRN the label
    x and the noise, the others x alone (they ignore the noise)."""
    if isinstance(net, NOISE_ONLY):
        return net(noise.to(dtype), activation=activation)
    if isinstance(net, CascadedRefinementNetwork):
        return net(x.to(dtype), noise.to(dtype), activation=activation)
    return net(x.to(dtype), activation=activation)


def cat_channels(a, b):
    """(conditioning, generated) pair for a cGAN D input, the conditioning
    side cast to the generated side's dtype (models/common.py:78)."""
    return torch.cat([a.to(b.dtype), b], 1)


def l1_weight_map(real_A, weights):
    """Per-pixel WeightedL1 weight 1 + sum_i A_i (w_i - 1) on the [0, 1]-
    rescaled label channels, or None (models/common.py:92)."""
    if weights is None:
        return None
    a = (real_A.detach() + 1) / 2
    w = torch.ones_like(a[:, :1])
    for i, wi in enumerate(weights):
        w = w + a[:, i:i + 1] * (wi - 1.0)
    return w


def mul_padded(in1, in2):
    """in1 * in2 with in1 reflection-padded, centred, to in2's spatial size
    (reference util/util.py:131-145; models/common.py:104-118 there): the
    left and bottom pads take the floor of each split.  Sizes are global
    (--spatial_mesh: parallel/spatial.py ``height``); the row pads fetch
    the rows they reflect (ops/pad.py)."""
    h1, w1 = spatial.height(in1), in1.shape[3]
    h2, w2 = spatial.height(in2), in2.shape[3]
    if in1.shape[:2] == in2.shape[:2] and (h1, w1) == (h2, w2):
        return in1 * in2
    pad_l = (w2 - w1) // 2
    pad_b = (h2 - h1) // 2
    return reflection_pad(in1, pad_l, w2 - w1 - pad_l, h2 - h1 - pad_b,
                          pad_b) * in2


def alternate_updates(record, n_update_D, update_D, n_update_G, update_G):
    """One iteration: the recorded forward, then n_update_D D updates and
    n_update_G G updates on its taps, the forward recorded again (fresh
    noise) after every update of a kind repeated more than once, the last
    one included (``train_step`` of build_gan_train_step, models/common.py
    there).  The last recorded
    forward is only shown, so it records no graph.  Returns (taps, the
    last D update's result, the last G update's)."""
    taps = record()
    d = g = None
    for _ in range(n_update_D):
        d = update_D(taps)
        if n_update_D > 1:
            taps = record()
    for k in range(n_update_G):
        g = update_G(taps)
        if n_update_G > 1:
            with torch.set_grad_enabled(k + 1 < n_update_G):
                taps = record()
    return taps, d, g


class PairDiscriminator:
    """The D bank ``netD`` (Adam ``optD``) of a conditional recipe: it judges
    cat(input_A, B), or B alone with --no_cgan; its fakes (``fake_pair``,
    by default the pair of ``taps['fake_B']``) go through the ``fake``
    pool."""

    def pair(self, b, a=None):
        """The D input of B, conditioned on ``a`` (default input_A)."""
        if self.opt.no_cgan:
            return b
        return cat_channels(self.input_A if a is None else a, b)

    def fake_pair(self, taps):
        return self.pair(taps['fake_B'])

    def update_D(self, taps):
        """One D update, 0.5 (fake + real), on the pooled fake pair and the
        real pair; returns the (real, fake) loss sums."""
        lsgan = not self.opt.no_lsgan
        fake = self.query_pool('fake', self.fake_pair(taps).detach())
        real = self.pair(self.input_B)
        loss_fake = sum(gan_loss(o, False, lsgan)
                        for o in self.bank_apply(self.netD, fake))
        loss_real = sum(gan_loss(o, True, lsgan)
                        for o in self.bank_apply(self.netD, real))
        self._step(self.optD, (loss_fake + loss_real) * 0.5)
        return loss_real.detach(), loss_fake.detach()
