"""TestModel: bare A -> B inference with one generator on the single
dataset (reference models/test_model.py).

Counterpart of supervised_gan_tpu/models/test_model.py: G
(--which_model_netG, the option default resnet_9blocks) is built from the
plain options and loaded from ``<which_epoch>_net_G.pth``; test() runs it
on every channel of the loaded image, without gradient.  The reference's
define_G call puts gpu_ids in the n_layers_G slot (test_model.py:17-20
there); the port, as the JAX package, passes the options by name.
"""

from collections import OrderedDict

import torch

from .base import BaseModel
from .common import g_apply
from .. import nn
from ..utils.images import tensor2im


class TestModel(BaseModel):
    def name(self):
        return 'TestModel'

    def initialize(self, opt):
        if opt.isTrain:
            raise ValueError('--model test only samples')
        BaseModel.initialize(self, opt)
        self.netG = nn.define_G(
            opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG,
            opt.norm, not opt.no_dropout, n_layers_G=opt.n_layers_G,
            noise_nc=opt.noise_nc)
        self.load_network(self.netG, 'G', opt.which_epoch)
        self.netG.to(self.device)
        nn.set_noise_generator(self.netG, self.noise_generator)
        print('---------- Networks initialized -------------')
        nn.print_network(self.netG, 'G')
        print('-----------------------------------------------')

    def host_inputs(self, input):
        self.image_paths = input['A_paths']
        return {'input_A': self._nchw(input['A'])}

    @staticmethod
    def _nchw(arr):
        return torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous()

    def test(self):
        self.real_A = self.input_A
        with torch.no_grad():
            self.fake_B = g_apply(self.netG, self.real_A, None,
                                  self.compute_dtype)

    def outputs(self):
        """The tensors one test() call produced."""
        return (self.fake_B,)

    def get_current_visuals(self, save_as_single_image=False):
        return OrderedDict([('real_A', tensor2im(self.real_A)),
                            ('fake_B', tensor2im(self.fake_B))])
