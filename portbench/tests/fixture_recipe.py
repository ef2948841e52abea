"""A configuration's reference and a hand-kernel family brought as a file of
their own, which no file of the harness names: the fixture of
test_pb_faults.py's seam tests.  ``FixtureCGAN`` is reference/train.py's
SGAN step with another generator, found through a configuration's
``reference`` alone: for ``resnet_<n>blocks`` the program's ResNet
generator (nn/generators.py ResnetGenerator), written here from
reference/nets.py's layers; overriding ``CGAN.generator`` is all it takes.
The module is also a kernel family of one entry (kernels/__init__.py's
contract)."""

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import nets
from portbench.reference.train import CGAN
from portbench.roofline import PEAK_F32_FLOPS, nbytes

ENTRIES = ('fixture_scale',)
DEVICE_NAMES = ('fixture_scale_kernel',)


class ReflectPad(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.p = p

    def run(self, x, ctx):
        return F.pad(x, (self.p,) * 4, mode='reflect')


class Tanh(nn.Module):
    def run(self, x, ctx):
        return torch.tanh(x)


class UpConv(nets.Conv):
    """ConvTranspose2d k3 s2 p1 with output_padding 1: the p0 transposed
    conv, whose output is one row and one column longer at each end, with
    its first row and column cut away (ctx's convolutions take no
    output_padding)."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, 2, 0, True, True)

    def run(self, x, ctx):
        return super().run(x, ctx)[:, :, 1:, 1:]


class ResBlock(nn.Module):
    def __init__(self, dim, dropout):
        super().__init__()
        layers = [ReflectPad(1), nets.Conv(dim, dim, 3), nets.InstanceNorm(),
                  nets.relu()]
        if dropout:
            layers.append(nets.Dropout())
        layers += [ReflectPad(1), nets.Conv(dim, dim, 3), nets.InstanceNorm()]
        self.conv_block = nets.Seq(*layers)

    def run(self, x, ctx):
        return x + self.conv_block.run(x, ctx)


class Resnet(nn.Module):
    """Reflect-padded 7x7 stem, two 3x3 s2 downs, ``n_blocks`` residual
    blocks at 4 ngf, two 3x3 s2 transposed ups, reflect-padded 7x7 head,
    instance norm, tanh twice (the layers' last and the forward's)."""

    def __init__(self, in_nc, out_nc, ngf, dropout, n_blocks):
        super().__init__()
        layers = [ReflectPad(3), nets.Conv(in_nc, ngf, 7),
                  nets.InstanceNorm(), nets.relu()]
        for mult in (1, 2):
            layers += [nets.Conv(ngf * mult, ngf * mult * 2, 3, 2, 1),
                       nets.InstanceNorm(), nets.relu()]
        layers += [ResBlock(ngf * 4, dropout) for _ in range(n_blocks)]
        for mult in (4, 2):
            layers += [UpConv(ngf * mult, ngf * mult // 2),
                       nets.InstanceNorm(), nets.relu()]
        layers += [ReflectPad(3), nets.Conv(ngf, out_nc, 7), Tanh()]
        self.model = nets.Seq(*layers)

    def run(self, x, ctx):
        return torch.tanh(self.model.run(x, ctx))


class FixtureCGAN(CGAN):
    """CGAN's D bank, pools, Adams and step, with the ResNet generator."""

    def generator(self, f, gauss):
        blocks = {'resnet_9blocks': 9, 'resnet_6blocks': 6}.get(
            f['which_model_netG'])
        if blocks is None:
            return super().generator(f, gauss)
        if f.get('norm') != 'instance' or f.get('use_residual'):
            raise NotImplementedError('the fixture ResNet: instance norm, '
                                      'no residual output')
        return Resnet(f['input_nc'], f['output_nc'], f['ngf'],
                      not f.get('no_dropout'), blocks)


def cost(entry, args):
    """(x) -> 2 x: an operation an element, x read and the result
    written."""
    x = args[0]
    return float(x.numel()), 2.0 * nbytes(x)


def peak(entry, args):
    return PEAK_F32_FLOPS
