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

Sampling: ``test`` (a fresh noise), ``set_fixed_noise`` / ``interpolate``
(G on a blend of two kept noises) and ``reconstruction``, the latent
inversion of the recon entry point (fcgan.py:253-320 there).
"""

from collections import OrderedDict

import numpy as np
import torch

from .base import BaseModel, adam, parse_which_channel, set_lr
from .common import alternate_updates
from .pools import init_pool
from .. import nn
from ..nn.losses import bce_loss, gan_loss
from ..utils.images import tensor2im

METRICS_ORDER = ('G_GAN', 'D_real', 'D_fake')
# reconstruction: restarts, L-BFGS iterations each, the curvature pairs kept
RECON_TRIALS, RECON_ITERS, RECON_HISTORY = 3, 50, 10


def lbfgs_minimize(objective, z0, iters=RECON_ITERS, history=RECON_HISTORY):
    """``iters`` L-BFGS iterations on the scalar ``objective`` of a tensor
    from ``z0``: torch.optim.LBFGS with one iteration a step call, a
    strong-Wolfe line search and ``history`` curvature pairs kept across
    the calls (the state optax.lbfgs carries between its updates), and no
    early stop (tolerances 0): every iteration runs, as each of optax's
    updates does.  Returns the last iterate."""
    z = z0.detach().clone().requires_grad_(True)
    solver = torch.optim.LBFGS([z], lr=1, max_iter=1, history_size=history,
                               tolerance_grad=0, tolerance_change=0,
                               line_search_fn='strong_wolfe')

    def closure():
        solver.zero_grad()
        loss = objective(z)
        loss.backward()
        return loss

    for _ in range(iters):
        solver.step(closure)
    return z.detach()


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
            nn.set_noise_generator(net, self.noise_generator)

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
        fake, (d_real, d_fake), g_gan = alternate_updates(
            lambda: self._generate(self.draw_noise()), o.n_update_D,
            self.update_D, o.n_update_G, self.update_G)
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
        self.last_noise = self.draw_noise()
        with torch.no_grad():
            self.fake = self._generate(self.last_noise)
        print('Random check: {}'.format(float(self.last_noise[0, 0, 0, 0])))

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

    def set_fixed_noise(self, which_one):
        """Keep the last test() noise as end A (``which_one`` 'A') or B."""
        if which_one == 'A':
            self.fixed_noiseA = self.last_noise
        else:
            self.fixed_noiseB = self.last_noise

    def interpolate(self, alpha):
        """G on alpha * B + (1 - alpha) * A of the kept noises."""
        self.last_noise = (alpha * self.fixed_noiseB
                           + (1 - alpha) * self.fixed_noiseA)
        with torch.no_grad():
            self.fake = self._generate(self.last_noise)
        self.real = getattr(self, 'input', None)

    def draw_recon_noise(self, trial):
        """Trial ``trial``'s starting point, N(0, I) of the noise shape."""
        return self.draw_noise()

    def _recon_generate(self, noise):
        """G on ``noise`` with the same dropout masks at every call (the
        JAX package's fixed dropout key there): they draw from a generator
        seeded anew for the call."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.opt.manualSeed or 0) + 98)
        nn.set_noise_generator(self.netG, gen)
        try:
            return self._generate(noise)
        finally:
            nn.set_noise_generator(self.netG, self.noise_generator)

    def recon_objective(self, noise, real):
        """BCE((G(noise) + 1) / 2, (real + 1) / 2), what reconstruction
        minimizes over the noise."""
        return bce_loss((self._recon_generate(noise) + 1) / 2, (real + 1) / 2)

    def reconstruction(self):
        """L-BFGS latent inversion (fcgan.py:267-320 there; reference
        fcgan_model.py:238-307): RECON_TRIALS starts from N(0, I), each
        minimizing recon_objective on the input batch by L-BFGS
        (lbfgs_minimize).  G's parameters are frozen, so its backward
        computes dx only; its norms stay as in training.  Keeps the best trial; returns (its BCE,
        the N(0, I) negative log-likelihood of its noise and of its start,
        in float64 on the host) and sets fake, fake_init and real."""
        real = self.input
        shape = self._noise_shape()
        dim = shape[1] * shape[2] * shape[3]

        def nll(z):
            z = z.detach().cpu().double().numpy().ravel()
            return 0.5 * (z @ z) + 0.5 * dim * np.log(2 * np.pi)

        starts = [self.draw_recon_noise(t) for t in range(RECON_TRIALS)]
        frozen = [p for p in self.netG.parameters() if p.requires_grad]
        for p in frozen:
            p.requires_grad_(False)
        best = dict(err=float('inf'))
        def objective(z):
            return self.recon_objective(z, real)

        try:
            for trial, noise0 in enumerate(starts):
                print('trial {0} of {1}'.format(trial + 1, RECON_TRIALS))
                z = lbfgs_minimize(objective, noise0)
                with torch.no_grad():
                    recon = self._recon_generate(z)
                    err = float(bce_loss((recon + 1) / 2, (real + 1) / 2))
                    if err < best['err']:
                        best = dict(err=err, noise=z.detach(), recon=recon,
                                    recon_init=self._recon_generate(noise0),
                                    ll=nll(z), ll_init=nll(noise0))
        finally:
            for p in frozen:
                p.requires_grad_(True)
        self.last_noise = best['noise']
        self.fake = best['recon']
        self.fake_init = best['recon_init']
        self.real = real
        return best['err'], best['ll'], best['ll_init']
