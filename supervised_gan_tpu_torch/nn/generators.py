"""The generators of the recipes (NCHW).

Counterparts of supervised_gan_tpu/nn/generators.py: `FCGANGenerator`
(:41-95), `FCGANGeneratorStar` (:97-147), the unet
(`UnetSkipConnectionBlock`, `UnetGenerator`, :150-264, pixel output only),
the CRN (`CrnUpsampleBlock`, `CrnInterBlock`, `CascadedRefinementNetwork`,
:265-386), the resnet (`ResnetBlock`, `ResnetGenerator`, :389-444),
`AutoEncoder` (:447-482) and `DCGANGenerator` (:484-508).  Structure,
channel arithmetic,
layer order and attribute names match, so parameter counts and state_dict
keys line up.  Injected Gaussian noise (--add_gaussian_noise) is a
GaussianNoise module beside a block's ``model``, with no parameters, so the
keys are the same with it or without it.
"""

import torch
from torch import nn

from .core import (BatchNorm2d, Conv2d, ConvTranspose2d, Dropout,
                   GaussianNoise, LeakyReLU, ReflectionPad2d, ReLU, Sequential,
                   Tanh, Upsample)
from ..ops import avg_pool


def activate(y, activation='tanh'):
    """The output activation; softmax over the channels (dim 1 of NCHW)."""
    if activation == 'tanh':
        return torch.tanh(y)
    if activation == 'sigmoid':
        return torch.sigmoid(y)
    if activation == 'softmax':
        return torch.softmax(y, dim=1)
    if activation in (None, 'none'):
        return y
    raise ValueError('unknown activation %r' % (activation,))


class FCGANGenerator(nn.Module):
    """DCGAN-style ConvTranspose stack from a noise image; BatchNorm always.
    use_fcn (noiseSize != 1): the first layer is k4 s2 p1, else k4 s1 p0.
    Output side = noiseSize * 2^(n_layers+1) with use_fcn.  use_dropout puts
    Dropout(0.5) between each middle layer's BatchNorm and its ReLU (not
    after the first layer), which shifts the position keys after it."""

    def __init__(self, noise_nc, input_nc, ngf=64, n_layers=3,
                 use_dropout=False, use_fcn=False):
        super().__init__()
        nf_mult = min(2 ** (n_layers - 1), 8)
        if use_fcn:
            first = ConvTranspose2d(noise_nc, ngf * nf_mult, 4, 2, 1, bias=False)
        else:
            first = ConvTranspose2d(noise_nc, ngf * nf_mult, 4, 1, 0, bias=False)
        layers = [first, BatchNorm2d(ngf * nf_mult), ReLU()]
        for n in range(1, n_layers):
            prev = nf_mult
            nf_mult = min(2 ** (n_layers - n - 1), 8)
            layers += [ConvTranspose2d(ngf * prev, ngf * nf_mult, 4, 2, 1),
                       BatchNorm2d(ngf * nf_mult)]
            if use_dropout:
                layers.append(Dropout(0.5))
            layers.append(ReLU())
        layers.append(ConvTranspose2d(ngf, input_nc, 4, 2, 1, bias=False))
        self.model = Sequential(*layers)

    def forward(self, noise, activation='tanh'):
        return activate(self.model(noise), activation)


def _up(in_nc, out_nc, final=False):
    """One level of a FCGANGeneratorStar tower: a k4 s2 ConvT without bias,
    then BatchNorm and ReLU unless it is the head."""
    layers = [ConvTranspose2d(in_nc, out_nc, 4, 2, 1, bias=False)]
    if not final:
        layers += [BatchNorm2d(out_nc), ReLU()]
    return Sequential(*layers)


class FCGANGeneratorStar(nn.Module):
    """Two coupled ConvTranspose towers from two halves of the noise: tower
    a (``conv0a``-``conv5a``) makes the label channel, tower b
    (``conv0b``-``conv5b``) the image channel, and each level 1-5 of tower b
    takes cat(ha, hb).  The first half of the noise channels feeds tower b,
    the second tower a; the output is cat(ha, hb), label first.  BatchNorm
    always; use_dropout is not read.  Needs n_layers == 5, use_fcn and
    input_nc == 2 (reference models/networks.py:549-551)."""

    def __init__(self, noise_nc, input_nc, ngf=64, n_layers=3,
                 use_dropout=False, use_fcn=False):
        super().__init__()
        if not (n_layers == 5 and use_fcn and input_nc == 2):
            raise ValueError('fcgan_star needs n_layers 5, noiseSize > 1 and '
                             'input_nc 2, got %d, %s, %d'
                             % (n_layers, use_fcn, input_nc))
        self.noise_nc = noise_nc // 2
        mults = [8, 8, 4, 2, 1]
        ic = self.noise_nc
        for i, m in enumerate(mults):
            setattr(self, 'conv%da' % i, _up(ic, ngf * m))
            ic = ngf * m
        self.conv5a = _up(ngf, 1, final=True)
        self.conv0b = _up(self.noise_nc, ngf * 8)
        for i, m in enumerate(mults[1:]):
            # level i + 1 takes cat(ha, hb), each ngf * mults[i] channels
            setattr(self, 'conv%db' % (i + 1), _up(2 * ngf * mults[i],
                                                   ngf * m))
        self.conv5b = _up(2 * ngf, 1, final=True)

    def forward(self, noise, activation='tanh'):
        n = self.noise_nc
        hb = self.conv0b(noise[:, :n])
        ha = self.conv0a(noise[:, n:2 * n])
        for i in range(1, 6):
            hb = getattr(self, 'conv%db' % i)(torch.cat([ha, hb], 1))
            ha = getattr(self, 'conv%da' % i)(ha)
        return activate(torch.cat([ha, hb], 1), activation)


class UnetSkipConnectionBlock(nn.Module):
    """One U-Net level: y = model(x), plus sigma N(0, 1) with
    add_gaussian_noise, returned as cat([y, x]) when this level keeps its
    skip connection (reference models/networks.py:373-419)."""

    def __init__(self, outer_nc, inner_nc, submodule=None, innermost=False,
                 norm_layer=BatchNorm2d, use_dropout=False,
                 add_gaussian_noise=False, gaussian_sigma=0.1,
                 add_skip_this=True, add_skip_sub=True):
        super().__init__()
        self.gauss = (GaussianNoise(gaussian_sigma) if add_gaussian_noise
                      else None)
        self.add_skip_this = add_skip_this
        downconv = Conv2d(outer_nc, inner_nc, 4, 2, 1)
        if innermost:
            layers = [LeakyReLU(0.2), downconv,
                      ReLU(), ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1),
                      norm_layer(outer_nc)]
        else:
            nc_mult = 2 if add_skip_sub else 1
            layers = [LeakyReLU(0.2), downconv, norm_layer(inner_nc),
                      submodule, ReLU(),
                      ConvTranspose2d(inner_nc * nc_mult, outer_nc, 4, 2, 1),
                      norm_layer(outer_nc)]
            if use_dropout:
                layers.append(Dropout(0.5))
        self.model = Sequential(*layers)

    def forward(self, x):
        y = self.model(x)
        if self.gauss is not None:
            y = self.gauss(y)
        return torch.cat([y, x], 1) if self.add_skip_this else y


class UnetGenerator(nn.Module):
    """Recursive U-Net; num_downs = 7 for unet_128, 8 for unet_256.
    ``num_skips`` (< 0: all) limits how many levels, from the innermost,
    keep their skip concat.  Takes no noise input: stochasticity comes
    from dropout and the injected Gaussian noise (reference
    models/networks.py:362-367)."""

    def __init__(self, input_nc, output_nc, num_downs, ngf=64,
                 norm_layer=BatchNorm2d, use_dropout=False, use_residual=False,
                 add_gaussian_noise=False, gaussian_sigma=0.1, num_skips=-1):
        super().__init__()
        self.use_residual = use_residual
        if num_skips < 0:
            num_skips = num_downs
        gauss = dict(add_gaussian_noise=add_gaussian_noise,
                     gaussian_sigma=gaussian_sigma)
        add_skip_this = num_skips >= 1
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, norm_layer=norm_layer,
                                        innermost=True,
                                        add_skip_this=add_skip_this, **gauss)
        for i in range(num_downs - 5):
            add_skip_sub, add_skip_this = add_skip_this, num_skips >= i + 2
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, block,
                                            norm_layer=norm_layer,
                                            use_dropout=use_dropout,
                                            add_skip_this=add_skip_this,
                                            add_skip_sub=add_skip_sub, **gauss)
        for outer_mult, inner_mult, skip_at in ((4, 8, num_downs - 3),
                                                (2, 4, num_downs - 2),
                                                (1, 2, num_downs - 1)):
            add_skip_sub, add_skip_this = add_skip_this, num_skips >= skip_at
            block = UnetSkipConnectionBlock(ngf * outer_mult, ngf * inner_mult,
                                            block, norm_layer=norm_layer,
                                            add_skip_this=add_skip_this,
                                            add_skip_sub=add_skip_sub, **gauss)
        nc_mult = 2 if add_skip_this else 1
        self.model = Sequential(
            Conv2d(input_nc, ngf, 4, 2, 1),
            block,
            ReLU(),
            ConvTranspose2d(ngf * nc_mult, output_nc, 4, 2, 1))

    def forward(self, x, activation='tanh'):
        y = self.model(x)
        return activate(x + y if self.use_residual else y, activation)


class CrnUpsampleBlock(nn.Module):
    """convt: ConvT k4s2p1 + norm;  bilinear: Conv3x3 + x2 bilinear + norm;
    then sigma N(0, 1) with add_gaussian_noise (reference
    models/networks.py:738-764)."""

    def __init__(self, input_nc, output_nc, mode='convt',
                 norm_layer=BatchNorm2d, add_gaussian_noise=False,
                 gaussian_sigma=0.1):
        super().__init__()
        self.gauss = (GaussianNoise(gaussian_sigma) if add_gaussian_noise
                      else None)
        if mode == 'convt':
            self.model = Sequential(
                ConvTranspose2d(input_nc, output_nc, 4, 2, 1, bias=False),
                norm_layer(output_nc))
        elif mode == 'bilinear':
            self.model = Sequential(
                Conv2d(input_nc, output_nc, 3, 1, 1),
                Upsample(2, 'bilinear'),
                norm_layer(output_nc))
        else:
            raise NotImplementedError('UpsampleBlock mode [%s]' % mode)

    def forward(self, x):
        y = self.model(x)
        return y if self.gauss is None else self.gauss(y)


class CrnInterBlock(nn.Module):
    """(n_layers-1) x [ReLU, Conv3x3, norm] then [ReLU, Conv3x3 (+norm unless
    outermost)]."""

    def __init__(self, input_nc, output_nc, n_layers=1, norm_layer=BatchNorm2d,
                 outer_most=False):
        super().__init__()
        layers = []
        for _ in range(1, n_layers):
            layers += [ReLU(), Conv2d(input_nc, input_nc, 3, 1, 1),
                       norm_layer(input_nc)]
        layers += [ReLU(), Conv2d(input_nc, output_nc, 3, 1, 1)]
        if not outer_most:
            layers.append(norm_layer(output_nc))
        self.model = Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class CascadedRefinementNetwork(nn.Module):
    """6-scale cascaded refinement: at each scale the label is AvgPool-
    downsampled (64, 32, 16, 8, 4, 2), embedded by a shared (or per-scale)
    3x3 conv block and concatenated with the upsampled hidden state.  The
    label side must be 64 * noiseSize."""

    def __init__(self, input_nc, output_nc, noise_nc, ngf=64, n_layers=5,
                 norm_layer=BatchNorm2d, upsample_mode='convt',
                 add_gaussian_noise=False, gaussian_sigma=0.1,
                 share_label_weights=True, n_layers_block=1):
        super().__init__()
        if n_layers != 5:
            raise ValueError('the CRN has n_layers == 5, got %d' % n_layers)
        self.share_label_weights = share_label_weights

        def hblock(in_nc, out_nc, outer_most=False, with_gauss=True):
            return Sequential(
                CrnUpsampleBlock(in_nc, ngf, mode=upsample_mode,
                                 norm_layer=norm_layer,
                                 add_gaussian_noise=(add_gaussian_noise
                                                     and with_gauss),
                                 gaussian_sigma=gaussian_sigma),
                CrnInterBlock(ngf, out_nc, n_layers=n_layers_block,
                              norm_layer=norm_layer, outer_most=outer_most))

        self.blockh5 = hblock(noise_nc + input_nc, ngf)
        self.blockh4 = hblock(ngf + ngf, ngf)
        self.blockh3 = hblock(ngf + ngf, ngf)
        self.blockh2 = hblock(ngf + ngf, ngf)
        self.blockh1 = hblock(ngf + ngf, ngf)
        self.blockh0 = hblock(ngf + ngf, output_nc, outer_most=True,
                              with_gauss=False)

        def lblock():
            return Sequential(Conv2d(input_nc, ngf, 3, 1, 1), norm_layer(ngf))

        if share_label_weights:
            self.blockl = lblock()
        else:
            for i in range(5):
                setattr(self, 'blockl%d' % i, lblock())

    def forward(self, label, noise, activation='tanh'):
        h = self.blockh5(torch.cat([avg_pool(label, 64), noise], 1))
        for pool, hname, lidx in ((32, 'blockh4', 4), (16, 'blockh3', 3),
                                  (8, 'blockh2', 2), (4, 'blockh1', 1),
                                  (2, 'blockh0', 0)):
            lname = 'blockl' if self.share_label_weights else 'blockl%d' % lidx
            l = getattr(self, lname)(avg_pool(label, pool))
            h = getattr(self, hname)(torch.cat([l, h], 1))
        return activate(h, activation)


class ResnetBlock(nn.Module):
    """x + [pad, conv3x3, norm, ReLU, (Dropout), pad, conv3x3, norm](x), the
    pads reflections by 1 and the convs p0 (reference models/
    networks.py:272-311)."""

    def __init__(self, dim, padding_type='reflect', norm_layer=BatchNorm2d,
                 use_dropout=False):
        super().__init__()
        if padding_type != 'reflect':
            raise NotImplementedError('padding [%s] is not implemented'
                                      % padding_type)
        layers = [ReflectionPad2d(1), Conv2d(dim, dim, 3, 1, 0),
                  norm_layer(dim), ReLU()]
        if use_dropout:
            layers.append(Dropout(0.5))
        layers += [ReflectionPad2d(1), Conv2d(dim, dim, 3, 1, 0),
                   norm_layer(dim)]
        self.conv_block = Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """Johnson's resnet generator: a reflect-padded 7x7 stem, two 3x3 s2
    downsamples, n_blocks ResnetBlocks at 4 ngf, two 3x3 s2 transposed
    upsamples and a reflect-padded 7x7 head (reference models/
    networks.py:221-268).  Without use_residual the model ends in a Tanh
    and the forward applies tanh again, as the reference and the JAX
    package do; the forward's ``activation`` is not read (the output is
    always tanh'd, generators.py:441-444 there)."""

    def __init__(self, input_nc, output_nc, ngf=64, norm_layer=BatchNorm2d,
                 use_dropout=False, n_blocks=6, use_residual=False):
        super().__init__()
        self.use_residual = use_residual
        layers = [ReflectionPad2d(3), Conv2d(input_nc, ngf, 7, 1, 0),
                  norm_layer(ngf), ReLU()]
        for i in range(2):
            mult = 2 ** i
            layers += [Conv2d(ngf * mult, ngf * mult * 2, 3, 2, 1),
                       norm_layer(ngf * mult * 2), ReLU()]
        for _ in range(n_blocks):
            layers.append(ResnetBlock(ngf * 4, 'reflect', norm_layer,
                                      use_dropout))
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, 2, 1,
                                       output_padding=1),
                       norm_layer(ngf * mult // 2), ReLU()]
        layers += [ReflectionPad2d(3), Conv2d(ngf, output_nc, 7, 1, 0)]
        if not use_residual:
            layers.append(Tanh())
        self.model = Sequential(*layers)

    def forward(self, x, activation='tanh'):
        y = self.model(x)
        return torch.tanh(x + y if self.use_residual else y)


class AutoEncoder(nn.Module):
    """A k4 s2 conv encoder down to min(2^n_layers, 8) latent channels, then
    a k4 s2 ConvT decoder back up (reference models/networks.py:422-490).
    The latent conv, the first ConvT and the head have no bias; with
    use_dropout each encoder level past the first runs norm, Dropout(0.2),
    ReLU and each decoder level past the first norm, Dropout(0.5), ReLU.
    It takes no noise."""

    def __init__(self, input_nc, output_nc, n_layers=3, ngf=64,
                 norm_layer=BatchNorm2d, use_dropout=False):
        super().__init__()
        layers = [Conv2d(input_nc, ngf, 4, 2, 1), norm_layer(ngf), ReLU()]
        nf_mult = 1
        for n in range(1, n_layers):
            prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers += [Conv2d(prev * ngf, ngf * nf_mult, 4, 2, 1),
                       norm_layer(ngf * nf_mult)]
            if use_dropout:
                layers.append(Dropout(0.2))
            layers.append(ReLU())
        latent_nc = min(2 ** n_layers, 8)
        layers.append(Conv2d(nf_mult * ngf, latent_nc, 4, 2, 1, bias=False))
        nf_mult = min(2 ** (n_layers - 1), 8)
        layers += [ConvTranspose2d(latent_nc, ngf * nf_mult, 4, 2, 1,
                                   bias=False),
                   norm_layer(ngf * nf_mult), ReLU()]
        for n in range(1, n_layers):
            prev, nf_mult = nf_mult, min(2 ** (n_layers - n - 1), 8)
            layers += [ConvTranspose2d(ngf * prev, ngf * nf_mult, 4, 2, 1),
                       norm_layer(ngf * nf_mult)]
            if use_dropout:
                layers.append(Dropout(0.5))
            layers.append(ReLU())
        layers.append(ConvTranspose2d(ngf, output_nc, 4, 2, 1, bias=False))
        self.model = Sequential(*layers)

    def forward(self, x, activation='tanh'):
        return activate(self.model(x), activation)


class DCGANGenerator(nn.Module):
    """The fixed 128 px DCGAN stack from a 1x1 noise (reference
    models/networks.py:1015-1071): a k4 s1 p0 ConvT to 4x4, five k4 s2
    ConvTs (ngf 8 -> 4 -> 2 -> 1 -> 1/2 -> nc), none with bias, BatchNorm
    and ReLU between, and the Tanh inside the model: the forward's
    ``activation`` is not read, as in the reference."""

    def __init__(self, nz=100, nc=3, ngf=64):
        super().__init__()
        layers = [ConvTranspose2d(nz, ngf * 8, 4, 1, 0, bias=False)]
        widths = [ngf * 8, ngf * 4, ngf * 2, ngf, ngf // 2]
        for a, b in zip(widths, widths[1:]):
            layers += [BatchNorm2d(a), ReLU(),
                       ConvTranspose2d(a, b, 4, 2, 1, bias=False)]
        layers += [BatchNorm2d(widths[-1]), ReLU(),
                   ConvTranspose2d(widths[-1], nc, 4, 2, 1, bias=False),
                   Tanh()]
        self.model = Sequential(*layers)

    def forward(self, noise, activation='tanh'):
        return self.model(noise)
