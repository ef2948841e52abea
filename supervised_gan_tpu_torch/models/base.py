"""BaseModel, sampling subset: the recipe protocol the drivers consume
(counterpart of supervised_gan_tpu/models/base.py; reference
models/base_model.py:5-64).

It holds the device (``--gpu_ids``: ``cuda:<first id>``, or the CPU for
``-1``), the compute dtype, and two generators seeded from ``--manualSeed``:
a CPU one for weight init and one on the device for every noise draw.  They
do not reproduce ``jax.random``'s numbers.
"""

import os

import torch

from ..utils import pth as pthio


def parse_which_channel(spec):
    """'rg_b' -> [[0, 1], [2]] (rgb indices per group)."""
    idx = {'r': 0, 'g': 1, 'b': 2}
    return [[idx[c] for c in group] for group in spec.split('_')]


def device_from_opt(gpu_ids):
    """The device --gpu_ids asks for.  A GPU that is not there raises: the
    sampler never carries on silently on the CPU."""
    if not gpu_ids:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('--gpu_ids %d asks for a CUDA device but none is '
                           'available; pass --gpu_ids -1 to run on the CPU'
                           % gpu_ids[0])
    return torch.device('cuda', gpu_ids[0])


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
