"""The nets of the two configurations in plain PyTorch, float32, written from
the reference repository's models/networks.py as SURVEY.md describes it:
the fcgan generator, the cascaded refinement network, the U-Net and the
multi-scale PatchGAN with its Gaussian blur front end.

Parameter names follow the reference's ``state_dict`` (``nn.Sequential``
children keyed by position, BatchNorm with its running buffers), so one
set of weights loads into these nets and into any implementation that keeps
the reference's layout.  Every layer computes through ``ctx`` (ctx.py): its
convolutions in ctx's precision, its dropout masks and injected noise from
ctx's draws.  BatchNorm always uses the batch's statistics and dropout is
always on: the reference never calls ``.eval()``.  Biases are kept before a
norm, where the norm cancels them (they then get a gradient of rounding
size only).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """Conv2d (weight (out, in, k, k)) or, with ``transpose``, ConvTranspose2d
    (weight (in, out, k, k))."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 transpose=False):
        super().__init__()
        self.cin, self.k = cin, k
        self.stride, self.padding, self.transpose = stride, padding, transpose
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def fan_in(self):
        return self.cin * self.k * self.k

    def run(self, x, ctx):
        return ctx.prec.conv(x, self.weight, self.bias, self.stride,
                             self.padding, self.transpose)


class BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def run(self, x, ctx):
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            1e-5)


class InstanceNorm(nn.Module):
    def run(self, x, ctx):
        return F.instance_norm(x, eps=1e-5)


class Act(nn.Module):
    def __init__(self, kind, slope=0.2):
        super().__init__()
        self.kind, self.slope = kind, slope

    def run(self, x, ctx):
        if self.kind == 'relu':
            return torch.relu(x)
        if self.kind == 'lrelu':
            return F.leaky_relu(x, self.slope)
        return torch.sigmoid(x)


class Dropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def run(self, x, ctx):
        keep = 1.0 - self.p
        mask = ctx.draws.rand(x.shape) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Upsample2(nn.Module):
    """x2 bilinear, align_corners=True (torch 0.3's Upsample)."""

    def run(self, x, ctx):
        return upsample(x, 2)


def upsample(x, scale):
    return F.interpolate(x, scale_factor=scale, mode='bilinear',
                         align_corners=True)


def gaussian(x, sigma, ctx):
    return x + sigma * ctx.draws.randn(x.shape, ctx.draws.noise_dtype)


class Seq(nn.Sequential):
    def run(self, x, ctx):
        for layer in self:
            x = layer.run(x, ctx)
        return x


def relu():
    return Act('relu')


def lrelu():
    return Act('lrelu', 0.2)


# ------------------------------------------------------------ generators -- #
class FCGAN(nn.Module):
    """ConvTranspose stack from a noise image (noiseSize > 1: the first layer
    k4 s2 p1), BatchNorm and ReLU between, tanh out."""

    def __init__(self, noise_nc, out_nc, ngf, n_layers, dropout=False):
        super().__init__()
        mult = min(2 ** (n_layers - 1), 8)
        layers = [Conv(noise_nc, ngf * mult, 4, 2, 1, False, True),
                  BatchNorm(ngf * mult), relu()]
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** (n_layers - n - 1), 8)
            layers += [Conv(ngf * prev, ngf * mult, 4, 2, 1, True, True),
                       BatchNorm(ngf * mult)]
            if dropout:
                layers.append(Dropout())
            layers.append(relu())
        layers.append(Conv(ngf, out_nc, 4, 2, 1, False, True))
        self.model = Seq(*layers)

    def run(self, noise, ctx):
        return torch.tanh(self.model.run(noise, ctx))


class UnetBlock(nn.Module):
    def __init__(self, outer, inner, sub=None, innermost=False,
                 dropout=False, gauss=None):
        super().__init__()
        self.gauss = gauss
        down = Conv(outer, inner, 4, 2, 1)
        if innermost:
            layers = [lrelu(), down, relu(),
                      Conv(inner, outer, 4, 2, 1, True, True), InstanceNorm()]
        else:
            layers = [lrelu(), down, InstanceNorm(), sub, relu(),
                      Conv(inner * 2, outer, 4, 2, 1, True, True),
                      InstanceNorm()]
            if dropout:
                layers.append(Dropout())
        self.model = Seq(*layers)

    def run(self, x, ctx):
        y = self.model.run(x, ctx)
        if self.gauss is not None:
            y = gaussian(y, self.gauss, ctx)
        return torch.cat([y, x], 1)


class Unet(nn.Module):
    """U-Net with every skip, instance norm; num_downs 7 (unet_128) or 8
    (unet_256); ``gauss``: the injected noise's sigma, or None."""

    def __init__(self, in_nc, out_nc, num_downs, ngf, dropout, gauss=None):
        super().__init__()
        block = UnetBlock(ngf * 8, ngf * 8, innermost=True, gauss=gauss)
        for _ in range(num_downs - 5):
            block = UnetBlock(ngf * 8, ngf * 8, block, dropout=dropout,
                              gauss=gauss)
        for outer, inner in ((4, 8), (2, 4), (1, 2)):
            block = UnetBlock(ngf * outer, ngf * inner, block, gauss=gauss)
        self.model = Seq(Conv(in_nc, ngf, 4, 2, 1), block, relu(),
                         Conv(ngf * 2, out_nc, 4, 2, 1, True, True))

    def run(self, x, ctx):
        return torch.tanh(self.model.run(x, ctx))


class CrnUp(nn.Module):
    """Conv3x3, x2 bilinear, instance norm."""

    def __init__(self, cin, cout):
        super().__init__()
        self.model = Seq(Conv(cin, cout, 3, 1, 1), Upsample2(), InstanceNorm())

    def run(self, x, ctx):
        return self.model.run(x, ctx)


class CrnInter(nn.Module):
    def __init__(self, cin, cout, n_layers, outer_most=False):
        super().__init__()
        layers = []
        for _ in range(1, n_layers):
            layers += [relu(), Conv(cin, cin, 3, 1, 1), InstanceNorm()]
        layers += [relu(), Conv(cin, cout, 3, 1, 1)]
        if not outer_most:
            layers.append(InstanceNorm())
        self.model = Seq(*layers)

    def run(self, x, ctx):
        return self.model.run(x, ctx)


class CRN(nn.Module):
    """Six-scale cascaded refinement network, shared label block, bilinear
    upsampling; the label side is 64 x the noise side."""

    def __init__(self, in_nc, out_nc, noise_nc, ngf, n_layers_block):
        super().__init__()

        def hblock(cin, cout, outer_most=False):
            return Seq(CrnUp(cin, ngf),
                       CrnInter(ngf, cout, n_layers_block, outer_most))

        self.blockh5 = hblock(noise_nc + in_nc, ngf)
        for i in (4, 3, 2, 1):
            setattr(self, 'blockh%d' % i, hblock(2 * ngf, ngf))
        self.blockh0 = hblock(2 * ngf, out_nc, outer_most=True)
        self.blockl = Seq(Conv(in_nc, ngf, 3, 1, 1), InstanceNorm())

    def run(self, label, noise, ctx):
        h = self.blockh5.run(torch.cat([F.avg_pool2d(label, 64), noise], 1),
                             ctx)
        for pool, i in ((32, 4), (16, 3), (8, 2), (4, 1), (2, 0)):
            lab = self.blockl.run(F.avg_pool2d(label, pool), ctx)
            h = getattr(self, 'blockh%d' % i).run(torch.cat([lab, h], 1), ctx)
        return torch.tanh(h)


# -------------------------------------------------------- discriminators -- #
def _matlab_gauss(kw, sigma):
    """MATLAB fspecial('gaussian', [kw kw], sigma)."""
    m = (kw - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h / h.sum()


def blur_down(x, scale):
    """The frozen Gaussian blur (sigma scale // 2, width 4 sigma + 1, zero
    padding 2 sigma) at stride ``scale``, channel by channel."""
    sigma = scale // 2
    kw = 4 * sigma + 1
    k = torch.tensor(_matlab_gauss(kw, sigma), dtype=x.dtype, device=x.device)
    c = x.shape[1]
    return F.conv2d(x, k.expand(c, 1, kw, kw), None, scale, 2 * sigma,
                    groups=c)


class PatchGAN(nn.Module):
    """n_layers PatchGAN, instance norm, sigmoid out; for scale > 1 the blur
    front end first."""

    def __init__(self, in_nc, ndf, n_layers, scale):
        super().__init__()
        self.scale = scale
        layers = [Conv(in_nc, ndf, 4, 2, 1), lrelu()]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [Conv(ndf * prev, ndf * mult, 4, 2, 1), InstanceNorm(),
                       lrelu()]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [Conv(ndf * prev, ndf * mult, 4, 1, 1), InstanceNorm(),
                   lrelu(), Conv(ndf * mult, 1, 4, 1, 1), Act('sigmoid')]
        self.model = Seq(*layers)

    def run(self, x, ctx):
        if self.scale > 1:
            x = blur_down(x, self.scale)
        return self.model.run(x, ctx)


def d_bank(in_nc, ndf, n_layers, scales):
    return nn.ModuleList(PatchGAN(in_nc, ndf, n, s)
                         for n, s in zip(n_layers, scales))


# ----------------------------------------------------------------- init -- #
def init_specs(net):
    """(name, tensor, kind, bound) of every parameter and buffer of ``net``
    in state_dict order: kind 'w' N(0, 0.02), 'bn' N(1, 0.02), 'b'
    U(-bound, bound) with bound 1 / sqrt(fan_in), 'zero', 'one'."""
    specs = []
    for mname, m in net.named_modules():
        pre = mname + '.' if mname else ''
        if isinstance(m, Conv):
            specs.append((pre + 'weight', m.weight, 'w', 0.0))
            if m.bias is not None:
                specs.append((pre + 'bias', m.bias, 'b',
                              1.0 / math.sqrt(m.fan_in())))
        elif isinstance(m, BatchNorm):
            specs += [(pre + 'weight', m.weight, 'bn', 0.0),
                      (pre + 'bias', m.bias, 'zero', 0.0),
                      (pre + 'running_mean', m.running_mean, 'zero', 0.0),
                      (pre + 'running_var', m.running_var, 'one', 0.0)]
    return specs
