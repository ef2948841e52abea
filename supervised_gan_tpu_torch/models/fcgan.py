"""FCGAN: the unconditional GAN on channel-selected images (the stage-1 label
GAN of the DSGAN workflow, `--which_channel rg`; JointGAN `rg_b`;
UnsupervisedGAN `b`).

Counterpart of supervised_gan_tpu/models/fcgan.py:38-251 and 326-362
(reference models/fcgan_model.py): a fcgan / deconv G from noise and a
multi-scale PatchGAN bank D on the selected channels, BCE or LSGAN losses,
an image pool, one Adam each for G and D, and an unclamped linear lr decay.

One iteration: G draws a fake from fresh noise; n_update_D D updates on the
pooled fake and the real batch, the noise redrawn and the fake recomputed
after each one when n_update_D > 1; then n_update_G G updates through the
(fixed) D bank, likewise redrawn and recomputed after each when
n_update_G > 1.  The JAX G loss reruns G on the fake's noise and dropout key,
which gives the fake itself, so here the G loss backpropagates through the
recorded fake.  The JAX package's phase-major label pipeline (`_PHASE_G`,
`space_to_phase`) is an XLA layout choice: the port computes the same
function in pixel order.

Not ported yet, raising NotImplementedError: `reconstruction` (recon.py's
LBFGS latent inversion) and `interpolate` / `set_fixed_noise`.
"""

from collections import OrderedDict

import numpy as np
import torch

from .base import BaseModel, adam, parse_which_channel, set_lr
from .pools import init_pool
from .. import nn
from ..nn.losses import gan_loss
from ..utils.images import tensor2im

METRICS_ORDER = ('G_GAN', 'D_real', 'D_fake')


class FCGANModel(BaseModel):
    STEP_INPUTS = ('input',)
    STEP_OUTPUTS = ('_metrics', 'fake', 'real')

    def initialize(self, opt):
        BaseModel.initialize(self, opt)
        groups = parse_which_channel(opt.which_channel)
        self.chnl_idx = [i for g in groups for i in g]
        self.visual_groups, pos = [], 0
        for g in groups:
            self.visual_groups.append(list(range(pos, pos + len(g))))
            pos += len(g)
        opt.input_nc = len(self.chnl_idx)

        self.netG = self.build_G(opt.input_nc, 0)
        if self.isTrain:
            self.netD = self.build_D_bank(opt.input_nc)
        if not self.isTrain or opt.continue_train:
            self.load_network(self.netG, 'G', opt.which_epoch)
            if self.isTrain:
                self.load_bank(self.netD, 'D_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_dropout_generator(net, self.noise_generator)

        if self.isTrain:
            self.old_lr = opt.lr
            self.optG = adam([(self.netG.parameters(), opt.lr)], opt.beta1,
                             self.device)
            self.optD = adam([(self.netD.parameters(), opt.lr)], opt.beta1,
                             self.device)
            self.pools = {'pool': init_pool(
                opt.pool_size, (opt.input_nc, opt.fineSize, opt.fineSize),
                self.device)}
            if opt.continue_train:
                extra = self.load_full_state(opt.which_epoch, self.nets(),
                                             self.optimizers(), self.pools)
                if extra is not None:
                    self.old_lr = extra['lr']
                    self._apply_lr()

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

    def _noise_shape(self):
        o = self.opt
        return (o.batchSize, o.noise_nc, o.noiseSize, o.noiseSize)

    def draw_noise(self):
        return self.noise(self._noise_shape())

    def host_inputs(self, input):
        AorB = self.opt.which_direction == 'A'
        data = input['A' if AorB else 'B'][..., self.chnl_idx]
        t = torch.from_numpy(np.ascontiguousarray(data, np.float32))
        self.image_paths = input['A_paths' if AorB else 'B_paths']
        return {'input': t.permute(0, 3, 1, 2).contiguous()}

    def pool_queries(self):
        return ['pool'] * self.opt.n_update_D

    # ---------------------------------------------------------- training -- #
    def _generate(self, noise):
        return self.netG(noise.to(self.compute_dtype))

    def _step(self, optimizer, loss):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()

    def update_D(self, fake):
        """One D update on the pooled fake and the real batch; returns the
        (real, fake) loss sums."""
        lsgan = not self.opt.no_lsgan
        pooled = self.query_pool('pool', fake.detach())
        loss_fake = sum(gan_loss(o, False, lsgan)
                        for o in self.bank_apply(self.netD, pooled))
        loss_real = sum(gan_loss(o, True, lsgan)
                        for o in self.bank_apply(self.netD, self.input))
        self._step(self.optD, (loss_fake + loss_real) * 0.5)
        return loss_real.detach(), loss_fake.detach()

    def update_G(self, fake):
        """One G update through the D bank, held fixed; returns the loss."""
        o = self.opt
        lsgan = not o.no_lsgan
        for p in self.netD.parameters():
            p.requires_grad_(False)
        try:
            outs = self.bank_apply(self.netD, fake)
            if o.no_logD_trick:
                loss = sum(-gan_loss(d, False, lsgan) * lam
                           for d, lam in zip(outs, o.lambda_D))
            else:
                loss = sum(gan_loss(d, True, lsgan) * lam
                           for d, lam in zip(outs, o.lambda_D))
            self._step(self.optG, loss)
        finally:
            for p in self.netD.parameters():
                p.requires_grad_(True)
        return loss.detach()

    def train_step(self):
        o = self.opt
        fake = self._generate(self.draw_noise())
        for _ in range(o.n_update_D):
            d_real, d_fake = self.update_D(fake)
            if o.n_update_D > 1:
                fake = self._generate(self.draw_noise())
        for k in range(o.n_update_G):
            g_gan = self.update_G(fake)
            if o.n_update_G > 1:
                # the last recomputed fake is only shown, not trained on
                with torch.set_grad_enabled(k + 1 < o.n_update_G):
                    fake = self._generate(self.draw_noise())
        self._metrics = {'G_GAN': g_gan, 'D_real': d_real, 'D_fake': d_fake}
        self.fake = fake.detach()
        self.real = self.input

    def get_current_errors(self):
        return OrderedDict((k, float(self._metrics[k])) for k in METRICS_ORDER)

    def save(self, label):
        self.save_network(self.netG, 'G', label)
        self.save_bank(self.netD, 'D_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, {'lr': self.old_lr})

    def _apply_lr(self):
        for opt_ in (self.optG, self.optD):
            set_lr(opt_.param_groups[0], self.old_lr)

    def update_learning_rate(self):
        """Linear decay by lr / niter_decay per epoch, not clamped at 0
        (fcgan.py:358-362 there)."""
        lr = self.old_lr - self.opt.lr / self.opt.niter_decay
        print('update learning rate: %f -> %f' % (self.old_lr, lr))
        self.old_lr = lr
        self._apply_lr()

    # ---------------------------------------------------------- sampling -- #
    def test(self):
        noise = self.draw_noise()
        with torch.no_grad():
            self.fake = self._generate(noise)
        print('Random check: {}'.format(float(noise[0, 0, 0, 0])))

    def outputs(self):
        """The tensors one test() call produced."""
        return (self.fake,)

    def get_current_visuals(self, save_real=False, save_as_single_image=True):
        """fake_label / fake_image for two channel groups, fake for one;
        while training (or with save_real) the real batch beside them."""
        def split(t, prefix):
            if len(self.visual_groups) == 2:
                g0, g1 = self.visual_groups
                return [(prefix + '_label', tensor2im(t[:, g0])),
                        (prefix + '_image', tensor2im(t[:, g1]))]
            return [(prefix, tensor2im(t))]

        if self.isTrain or save_real:
            return OrderedDict(split(self.real, 'real')
                               + split(self.fake, 'fake'))
        return OrderedDict(split(self.fake, 'fake'))

    def reconstruction(self):
        raise NotImplementedError('fcgan reconstruction (recon.py, LBFGS '
                                  'latent inversion) is not yet ported')

    def interpolate(self, alpha):
        raise NotImplementedError('fcgan interpolate / set_fixed_noise is not '
                                  'yet ported')

    def set_fixed_noise(self, which_one):
        raise NotImplementedError('fcgan interpolate / set_fixed_noise is not '
                                  'yet ported')
