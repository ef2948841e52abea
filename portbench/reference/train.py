"""Train steps in plain PyTorch: Adam, the image pools, the losses and the
update schedules of the reference's twostage_cycle (``DSGAN``) and cgan
(``CGAN``, SGAN step 2) models, as SURVEY.md and the reference README
describe them.

Each class keeps reference/__init__.py's contract; a configuration file
names one in its ``reference`` ('portbench/reference/train.py CGAN'), and
the harness finds it by that name.  ``Recipe`` holds what the classes
share; a new recipe is a class in a module of its own, a subclass of these
where it shares their step (a cgan with another generator overrides
``CGAN.generator`` alone).
"""

import collections

import torch
import torch.nn.functional as F

from . import nets


class Adam:
    """Adam (Kingma & Ba) with bias correction, eps added to the corrected
    root: p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, groups, beta1, beta2=0.999, eps=1e-8):
        self.groups = [(list(params), lr) for params, lr in groups]
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.state = {}

    def step(self, grads):
        """``grads``: {param: gradient}."""
        with torch.no_grad():
            for params, lr in self.groups:
                for p in params:
                    g = grads[p]
                    m, v, t = self.state.get(p, (torch.zeros_like(p),
                                                 torch.zeros_like(p), 0))
                    t += 1
                    m = self.b1 * m + (1 - self.b1) * g
                    v = self.b2 * v + (1 - self.b2) * g * g
                    self.state[p] = (m, v, t)
                    m_hat = m / (1 - self.b1 ** t)
                    v_hat = v / (1 - self.b2 ** t)
                    p -= lr * m_hat / (v_hat.sqrt() + self.eps)

    def params(self):
        return [p for params, _ in self.groups for p in params]


def update(opt, loss):
    params = opt.params()
    opt.step(dict(zip(params, torch.autograd.grad(loss, params))))


class Pool:
    """The reference's ImagePool of ``size`` images: while not full it
    stores each image and returns it; when full, with probability 1/2 it
    swaps the image with a random stored one and returns that, else it
    returns the image.  Each image draws a uniform, then a slot, from
    ``gen`` (one generator for all of a recipe's pools, drawn in the order
    the step queries them), whether the pool is full or not."""

    def __init__(self, size, gen):
        self.size = size
        self.images = []
        self.gen = gen

    def fill(self, images):
        """Start full, with ``images`` (size, C, H, W)."""
        self.images = [x.clone() for x in images[:self.size]]

    def query(self, batch):
        if self.size <= 0:
            return batch
        out = []
        for x in batch.detach():
            u = float(torch.rand((), generator=self.gen))
            slot = int(torch.randint(self.size, (), generator=self.gen))
            if len(self.images) < self.size:
                self.images.append(x.clone())
                out.append(x)
            elif u > 0.5:
                out.append(self.images[slot])
                self.images[slot] = x.clone()
            else:
                out.append(x)
        return torch.stack(out)


def bce(p, target):
    """Binary cross entropy of probabilities p against a tensor or a
    constant target (torch.nn.BCELoss: logs clamped at -100)."""
    if not torch.is_tensor(target):
        target = torch.full_like(p, float(target))
    return F.binary_cross_entropy(p, target)


def l1_weights(real_A, weights):
    """The WeightedL1 map 1 + sum_i a_i (w_i - 1), a the label in [0, 1]."""
    if not weights:
        return None
    a = (real_A + 1) / 2
    w = torch.ones_like(a[:, :1])
    for i, wi in enumerate(weights):
        w = w + a[:, i:i + 1] * (wi - 1.0)
    return w


def weighted_l1(x, y, w=None):
    z = (x - y).abs()
    return (z if w is None else z * w).mean()


def bank(ds, x, ctx):
    return [d.run(x, ctx) for d in ds]


def _list(v):
    return v if isinstance(v, list) else [v]


class Recipe:
    LOSSES = ()

    def __init__(self, flags, pool_seed=0):
        self.f = flags
        self.nets = collections.OrderedDict()
        self.pools = collections.OrderedDict()
        self.pool_gen = torch.Generator().manual_seed(pool_seed)
        self.pool_size = flags.get('pool_size', 50)

    def pool_shapes(self):
        """{pool name: (C, H, W) of its images}."""
        raise NotImplementedError

    def fill_pools(self, images):
        """Start every pool full: ``images`` {pool name: (size, C, H, W)}."""
        for name, pool in self.pools.items():
            pool.fill(images[name])

    def to(self, device):
        """The nets on ``device``, before any optimizer holds them (a move
        to another kind of device makes new parameters)."""
        for net in self.nets.values():
            net.to(device)

    def named_params(self):
        return collections.OrderedDict(
            ('%s.%s' % (label, n), p) for label, net in self.nets.items()
            for n, p in net.named_parameters())

    def optimizers(self):
        raise NotImplementedError

    def first_moments(self):
        """{'<net>.<name>': Adam's first moment} of every parameter Adam has
        stepped."""
        out = {}
        ids = {p: k for k, p in self.named_params().items()}
        for opt in self.optimizers():
            for p, (m, _, _) in opt.state.items():
                out[ids[p]] = m
        return out


class DSGAN(Recipe):
    """twostage_cycle: G1 (fcgan) draws a label from noise1, G2 (CRN) an image
    from a label and noise2, F2 (U-Net) an image back to a label; the D1 bank
    judges labels at half size, the D2 bank (label, image) pairs.  One
    iteration: the forward once, then one D1, one D2 and one G update."""

    LOSSES = ('G2_GAN', 'G2_real_cycle', 'G2_fake_cycle', 'D2', 'G1_GAN',
              'D1')

    def __init__(self, flags, device, pool_seed=0):
        super().__init__(flags, pool_seed)
        f = flags
        a_nc, b_nc = f['input_nc'], f['output_nc']
        self.sc = int(f['transform_1to2'].split('_')[1])
        self.nets['G1'] = nets.FCGAN(f['noise_nc1'], a_nc, f['ngf1'],
                                     f['n_layers_G1'],
                                     dropout=not f.get('no_dropout1'))
        self.nets['G2'] = nets.CRN(a_nc, b_nc, f['noise_nc2'], f['ngf2'],
                                   f['n_layers_CRN_block2'])
        self.nets['F2'] = nets.Unet(b_nc, a_nc,
                                    {'unet_128': 7, 'unet_256': 8}[
                                        f['which_model_netF2']],
                                    f['nff2'], not f.get('no_dropout2'))
        self.nets['D1'] = nets.d_bank(a_nc, f['ndf1'], _list(f['n_layers_D1']),
                                      _list(f['scale_factor1']))
        self.nets['D2'] = nets.d_bank(a_nc + b_nc, f['ndf2'],
                                      _list(f['n_layers_D2']),
                                      _list(f['scale_factor2']))
        self.to(device)
        b1 = f.get('beta1', 0.5)
        g = self.nets
        self.optG = Adam([(g['G1'].parameters(), f['lr1']),
                          (g['G2'].parameters(), f['lr2']),
                          (g['F2'].parameters(), f['lr2'])], b1)
        self.optD1 = Adam([(g['D1'].parameters(), f['lr1'])], b1)
        self.optD2 = Adam([(g['D2'].parameters(), f['lr2'])], b1)
        for name in ('pool1', 'pool2'):
            self.pools[name] = Pool(self.pool_size, self.pool_gen)

    def optimizers(self):
        return (self.optG, self.optD1, self.optD2)

    def pool_shapes(self):
        f = self.f
        a_nc, fs = f['input_nc'], f['fineSize']
        return {'pool1': (a_nc, fs // self.sc, fs // self.sc),
                'pool2': (a_nc + f['output_nc'], fs, fs)}

    def up(self, x):
        return nets.upsample(x, self.sc)

    def step(self, batch, ctx):
        f, n = self.f, self.nets
        A, B = batch['A'], batch['B']
        bs = A.shape[0]
        noise1 = ctx.draws.randn((bs, f['noise_nc1'], f['noiseSize1'],
                                  f['noiseSize1']))
        noise2 = ctx.draws.randn((bs, f['noise_nc2'], f['noiseSize2'],
                                  f['noiseSize2']))
        fake_A = n['G1'].run(noise1, ctx)
        fake_A_from_B = n['F2'].run(B, ctx)
        fake_B_from_A = n['G2'].run(A, noise2, ctx)
        fake_B_from_fake = n['G2'].run(self.up(fake_A), noise2, ctx)
        recon_real = n['F2'].run(fake_B_from_A, ctx)
        recon_fake = n['F2'].run(fake_B_from_fake, ctx)

        # D1 on pooled fake labels and the real label at label-space size
        fake = self.pools['pool1'].query(fake_A.detach())
        real = F.avg_pool2d(A, self.sc)
        loss_d1 = (sum(bce(o, 0) for o in bank(n['D1'], fake, ctx))
                   + sum(bce(o, 1) for o in bank(n['D1'], real, ctx))) * 0.5
        update(self.optD1, loss_d1)

        # D2 on the pooled (label, fake image) pair and the real pair
        fake = self.pools['pool2'].query(
            torch.cat([A, fake_B_from_A], 1).detach())
        real = torch.cat([A, B], 1)
        loss_d2 = (sum(bce(o, 0) for o in bank(n['D2'], fake, ctx))
                   + sum(bce(o, 1) for o in bank(n['D2'], real, ctx))) * 0.5
        update(self.optD2, loss_d2)

        # G: the six terms through the updated D banks
        g1 = sum(bce(o, 1) * lam for o, lam in zip(
            bank(n['D1'], fake_A, ctx), _list(f['lambda_D1'])))
        g2 = sum(bce(o, 1) * lam for o, lam in zip(
            bank(n['D2'], torch.cat([A, fake_B_from_A], 1), ctx),
            _list(f['lambda_D2'])))
        a01 = (A + 1) / 2
        ce = bce((fake_A_from_B + 1) / 2, a01)
        real_cycle = bce((recon_real + 1) / 2, a01)
        fake_cycle = bce((recon_fake + 1) / 2, (self.up(fake_A).detach() + 1)
                         / 2)
        total = (g1 + g2 + weighted_l1(fake_B_from_A, B) * f['lambda_A']
                 + ce * f['lambda_B'] + real_cycle * f['lambda_A_cycle']
                 + fake_cycle * f['lambda_A_cycle'] * f['lambda_fake_cycle'])
        update(self.optG, total)
        return {'G2_GAN': g2, 'G2_real_cycle': real_cycle,
                'G2_fake_cycle': fake_cycle, 'D2': loss_d2, 'G1_GAN': g1,
                'D1': loss_d1}


class CGAN(Recipe):
    """cgan (SGAN step 2): G (``generator``: the U-Net with dropout and
    injected Gaussian noise) maps the label to the image, a D bank judges
    (label, image) pairs.  One iteration: the forward, n_update_D D
    updates, n_update_G G updates, the forward drawn again after each
    update of a kind repeated more than once (the last one unrecorded)."""

    LOSSES = ('G_GAN', 'G_L1', 'D_real', 'D_fake')

    def __init__(self, flags, device, pool_seed=0):
        super().__init__(flags, pool_seed)
        f = flags
        a_nc, b_nc = f['input_nc'], f['output_nc']
        gauss = f.get('gaussian_sigma', 0.1) if f.get('add_gaussian_noise') \
            else None
        self.nets['G'] = self.generator(f, gauss)
        self.nets['D'] = nets.d_bank(a_nc + b_nc, f['ndf'],
                                     _list(f['n_layers_D']),
                                     _list(f['scale_factor']))
        self.to(device)
        b1 = f.get('beta1', 0.5)
        self.optG = Adam([(self.nets['G'].parameters(), f['lr'])], b1)
        self.optD = Adam([(self.nets['D'].parameters(), f['lr'])], b1)
        self.pools['fake'] = Pool(self.pool_size, self.pool_gen)

    def generator(self, f, gauss):
        """G for flags ``f`` (``gauss``: the injected noise's sigma, or
        None), built before the Adams take its parameters: the U-Net.  A
        recipe with another generator overrides this alone."""
        return nets.Unet(f['input_nc'], f['output_nc'],
                         {'unet_128': 7, 'unet_256': 8}[f['which_model_netG']],
                         f['ngf'], not f.get('no_dropout'), gauss)

    def optimizers(self):
        return (self.optG, self.optD)

    def pool_shapes(self):
        f = self.f
        return {'fake': (f['input_nc'] + f['output_nc'], f['fineSize'],
                         f['fineSize'])}

    def record(self, A, ctx):
        f = self.f
        # the noise input is drawn though the U-Net takes none
        ctx.draws.randn((A.shape[0], f['noise_nc'], f['noiseSize'],
                         f['noiseSize']))
        return self.nets['G'].run(A, ctx)

    def step(self, batch, ctx):
        f, n = self.f, self.nets
        A, B = batch['A'], batch['B']
        fake_B = self.record(A, ctx)
        out = {}
        for i in range(f.get('n_update_D', 1)):
            fake = self.pools['fake'].query(torch.cat([A, fake_B], 1).detach())
            real = torch.cat([A, B], 1)
            loss_fake = sum(bce(o, 0) for o in bank(n['D'], fake, ctx))
            loss_real = sum(bce(o, 1) for o in bank(n['D'], real, ctx))
            update(self.optD, (loss_fake + loss_real) * 0.5)
            out['D_real'], out['D_fake'] = loss_real, loss_fake
            if f.get('n_update_D', 1) > 1:
                fake_B = self.record(A, ctx)
        w = l1_weights(A, f.get('weight_L1'))
        ng = f.get('n_update_G', 1)
        for k in range(ng):
            gan = sum(bce(o, 1) * lam for o, lam in zip(
                bank(n['D'], torch.cat([A, fake_B], 1), ctx),
                _list(f['lambda_D'])))
            l1 = weighted_l1(fake_B, B, w) * f['lambda_A']
            total = gan + l1
            update(self.optG, total)
            out['G_GAN'], out['G_L1'] = total, l1
            if ng > 1:
                with torch.set_grad_enabled(k + 1 < ng):
                    fake_B = self.record(A, ctx)
        return out

