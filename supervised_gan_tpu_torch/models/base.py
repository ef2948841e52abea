"""BaseModel: the recipe protocol the drivers consume (counterpart of
supervised_gan_tpu/models/base.py; reference models/base_model.py:5-64).

It holds the device (``--gpu_ids``: ``cuda:<first id>``, or the CPU for
``-1``), the compute dtype, and three generators seeded from
``--manualSeed``: a CPU one for weight init, one on the device for every
noise draw and dropout mask, and a CPU one for the image pools' decisions.
They do not reproduce ``jax.random``'s numbers.

Checkpoints: ``<label>_net_<name>.pth`` per network (a CPU torch
``state_dict``, the format of the reference and of the JAX package), and
the port's own full train state ``<label>_state.pt`` (parameters, Adam
moments and steps, pools, learning rates and generator states) for an
exact ``--continue_train``.  ``build_G`` and ``build_D_bank`` build a
generator and a multi-scale discriminator bank from the plain or a
suffixed (``1``, ``2``) option block.  The JAX package's ``_state.pkl`` is a
different format and is not read.
"""

import os

import torch

from .. import nn
from ..utils import pth as pthio


def parse_which_channel(spec):
    """'rg_b' -> [[0, 1], [2]] (rgb indices per group)."""
    idx = {'r': 0, 'g': 1, 'b': 2}
    return [[idx[c] for c in group] for group in spec.split('_')]


def device_from_opt(gpu_ids):
    """The device --gpu_ids asks for.  A GPU that is not there raises: the
    drivers never carry on silently on the CPU."""
    if not gpu_ids:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('--gpu_ids %d asks for a CUDA device but none is '
                           'available; pass --gpu_ids -1 to run on the CPU'
                           % gpu_ids[0])
    return torch.device('cuda', gpu_ids[0])


def adam(groups, beta1):
    """optax.scale_by_adam(b1=beta1, b2=0.999, eps=1e-8) with the learning
    rate applied per parameter group (models/base.py:179-218 there):
    torch's Adam computes the same function.  ``groups``: [(params, lr)]."""
    return torch.optim.Adam([{'params': list(p), 'lr': lr} for p, lr in groups],
                            betas=(beta1, 0.999), eps=1e-8)


class BaseModel:
    def name(self):
        return type(self).__name__

    def initialize(self, opt):
        self.opt = opt
        self.isTrain = opt.isTrain
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.device = device_from_opt(opt.gpu_ids)
        seed = opt.manualSeed if opt.manualSeed is not None else 0
        self.init_generator = torch.Generator().manual_seed(seed)
        self.noise_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.pool_generator = torch.Generator().manual_seed(seed + 1)
        self.compute_dtype = (torch.bfloat16
                              if opt.compute_dtype == 'bfloat16'
                              else torch.float32)

    def noise(self, shape):
        """N(0, 1) float32 noise on the device from the seeded generator."""
        return torch.randn(shape, generator=self.noise_generator,
                           device=self.device)

    def _net_path(self, network_label, epoch_label, model_dir=''):
        d = model_dir or self.save_dir
        return os.path.join(d, '%s_net_%s.pth' % (epoch_label, network_label))

    def load_network(self, net, network_label, epoch_label, model_dir=''):
        # explicit model_dir wins, else save_dir (reference base_model.py:55-61)
        path = self._net_path(network_label, epoch_label, model_dir)
        print('loading %s' % path)
        return pthio.load_pth(path, net)

    def save_network(self, net, network_label, epoch_label):
        pthio.save_pth(self._net_path(network_label, epoch_label), net)

    def build_G(self, in_nc, out_nc, suffix=''):
        """define_G from the (optionally suffixed) architecture options,
        weights drawn from the seeded init generator."""
        o = self.opt

        def g(name, default=None):
            return getattr(o, name + suffix, default)

        return nn.define_G(
            in_nc, out_nc, g('ngf'), g('which_model_netG'), o.norm,
            not g('no_dropout'), n_layers_G=g('n_layers_G'),
            use_fcn=g('noiseSize') != 1, noise_nc=g('noise_nc'),
            add_gaussian_noise=o.add_gaussian_noise,
            upsample_mode=g('upsample_mode'),
            n_layers_CRN_block=g('n_layers_CRN_block'),
            share_label_weights=not g('no_share_label_block_weights'),
            use_residual=bool(g('use_residual')),
            n_layers_G_skip=g('n_layers_G_skip', -1),
            generator=self.init_generator)

    def build_D_bank(self, input_nc, suffix=''):
        """The multi-scale discriminator bank of a suffixed option block, as
        a ModuleList (reference fcgan_model.py:78)."""
        o = self.opt

        def g(name):
            return getattr(o, name + suffix)

        if not (len(g('scale_factor')) == len(g('lambda_D'))
                == len(g('n_layers_D'))):
            raise ValueError('--scale_factor%s, --lambda_D%s and '
                             '--n_layers_D%s must have one length'
                             % (suffix, suffix, suffix))
        return torch.nn.ModuleList(
            nn.define_D(input_nc, g('ndf'), g('which_model_netD'),
                        n_layers_D=n_layers, norm=o.norm,
                        use_sigmoid=g('no_lsgan'), scale_factor=scale,
                        generator=self.init_generator)
            for scale, n_layers in zip(g('scale_factor'), g('n_layers_D')))

    def bank_apply(self, bank, x):
        """Every discriminator of a bank on x, in the compute dtype."""
        return [d(x, self.compute_dtype) for d in bank]

    def load_bank(self, bank, label_fmt, epoch, model_dir=''):
        for i, d in enumerate(bank):
            self.load_network(d, label_fmt % i, epoch, model_dir)

    def save_bank(self, bank, label_fmt, epoch_label):
        for i, d in enumerate(bank):
            self.save_network(d, label_fmt % i, epoch_label)

    def _state_path(self, epoch_label):
        return os.path.join(self.save_dir, '%s_state.pt' % epoch_label)

    def save_full_state(self, epoch_label, nets, optimizers, pools, extra):
        """nets / optimizers / pools: dicts by name; extra: plain values."""
        payload = {
            'params': {k: {n: v.detach().cpu() for n, v in
                           net.state_dict().items()}
                       for k, net in nets.items()},
            'optim': {k: o.state_dict() for k, o in optimizers.items()},
            'pools': {k: None if p is None else
                      {'images': p['images'].cpu(), 'num': p['num']}
                      for k, p in pools.items()},
            'generators': {'noise': self.noise_generator.get_state(),
                           'pool': self.pool_generator.get_state()},
            'extra': dict(extra)}
        torch.save(payload, self._state_path(epoch_label))

    def load_full_state(self, epoch_label, nets, optimizers, pools):
        """Restore what save_full_state wrote, in place; returns its
        ``extra`` dict, or None when there is no state file."""
        path = self._state_path(epoch_label)
        if not os.path.exists(path):
            return None
        print('loading %s' % path)
        payload = torch.load(path, map_location='cpu', weights_only=True)
        for k, net in nets.items():
            net.load_state_dict(payload['params'][k], strict=True)
        for k, o in optimizers.items():
            o.load_state_dict(payload['optim'][k])
        for k, p in pools.items():
            saved = payload['pools'][k]
            if p is not None:
                p['images'].copy_(saved['images'])
                p['num'] = saved['num']
        self.noise_generator.set_state(payload['generators']['noise'])
        self.pool_generator.set_state(payload['generators']['pool'])
        return payload['extra']
