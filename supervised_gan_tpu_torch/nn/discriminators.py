"""The discriminators (NCHW).

Counterpart of supervised_gan_tpu/nn/discriminators.py: the PatchGAN of
the DSGAN banks (`_trunk`, `NLayerDiscriminator`, :26-89, pixel path
only), its label / image split `NLayerDiscriminatorSep` (:92-149) and
`DCGANDiscriminator` (:152-174).  For scale_factor > 1 a PatchGAN's input
first goes through the fixed Gaussian blur + subsample front end
(ops.blur_downsample), which has no parameters.  Padding is 1 (the
reference's Python-2 padw).  Each forward takes the compute dtype, applied
after the front end (the JAX package blurs the input as it comes and
casts at the stem).
"""

import torch
from torch import nn

from .core import BatchNorm2d, Conv2d, LeakyReLU, Sequential, Sigmoid
from ..ops import blur_downsample


def _trunk(input_nc, ndf, n_layers, norm_layer, use_sigmoid, logit_nc):
    layers = [Conv2d(input_nc, ndf, 4, 2, 1), LeakyReLU(0.2)]
    nf_mult = 1
    for n in range(1, n_layers):
        prev, nf_mult = nf_mult, min(2 ** n, 8)
        layers += [Conv2d(ndf * prev, ndf * nf_mult, 4, 2, 1),
                   norm_layer(ndf * nf_mult), LeakyReLU(0.2)]
    prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
    layers += [Conv2d(ndf * prev, ndf * nf_mult, 4, 1, 1),
               norm_layer(ndf * nf_mult), LeakyReLU(0.2),
               Conv2d(ndf * nf_mult, logit_nc, 4, 1, 1)]
    if use_sigmoid:
        layers.append(Sigmoid())
    return Sequential(*layers)


class NLayerDiscriminator(nn.Module):
    """PatchGAN with the blur-downsample front end for scale_factor > 1;
    the logit map is (N, 1, H', W') or (N, num_classes, H', W')."""

    def __init__(self, input_nc, ndf=64, n_layers=3, norm_layer=BatchNorm2d,
                 use_sigmoid=False, scale_factor=1, num_classes=2):
        super().__init__()
        self.scale_factor = scale_factor
        logit_nc = 1 if num_classes == 2 else num_classes
        self.model = _trunk(input_nc, ndf, n_layers, norm_layer, use_sigmoid,
                            logit_nc)

    def forward(self, x, dtype=None):
        return self.model(_front(x, self.scale_factor, dtype))


def _front(x, scale_factor, dtype):
    """The blur front end for scale_factor > 1, then the cast."""
    if scale_factor > 1:
        x = blur_downsample(x, scale_factor)
    return x if dtype is None else x.to(dtype)


class NLayerDiscriminatorSep(nn.Module):
    """The PatchGAN with its first two levels split: label channels 0:2
    through the tower ``netA``, the image channel 2:3 through ``netB``
    (each a k4 s2 conv, LeakyReLU, a k4 s2 conv, norm, LeakyReLU), their
    features concatenated into the trunk ``model``.  The blur front end
    runs before the split.  Needs input_nc == 3.  netB takes the image,
    as the reference's GPU branch does (its CPU branch routes it through
    netA, reference models/networks.py:940)."""

    def __init__(self, input_nc, ndf=64, n_layers=3, norm_layer=BatchNorm2d,
                 use_sigmoid=False, scale_factor=1, num_classes=2):
        super().__init__()
        if input_nc != 3:
            raise ValueError('n_layers_sep needs input_nc 3, got %d'
                             % input_nc)
        self.scale_factor = scale_factor
        logit_nc = 1 if num_classes == 2 else num_classes

        def tower(in_nc):
            return Sequential(Conv2d(in_nc, ndf, 4, 2, 1), LeakyReLU(0.2),
                              Conv2d(ndf, ndf * 2, 4, 2, 1),
                              norm_layer(ndf * 2), LeakyReLU(0.2))

        self.netA = tower(2)
        self.netB = tower(1)
        nf_mult = 4                     # the two towers' 2 ndf each
        layers = []
        for n in range(2, n_layers):
            prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers += [Conv2d(ndf * prev, ndf * nf_mult, 4, 2, 1),
                       norm_layer(ndf * nf_mult), LeakyReLU(0.2)]
        prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        layers += [Conv2d(ndf * prev, ndf * nf_mult, 4, 1, 1),
                   norm_layer(ndf * nf_mult), LeakyReLU(0.2),
                   Conv2d(ndf * nf_mult, logit_nc, 4, 1, 1)]
        if use_sigmoid:
            layers.append(Sigmoid())
        self.model = Sequential(*layers)

    def forward(self, x, dtype=None):
        x = _front(x, self.scale_factor, dtype)
        return self.model(torch.cat([self.netA(x[:, 0:2]),
                                     self.netB(x[:, 2:3])], 1))


class DCGANDiscriminator(nn.Module):
    """The fixed 128 px DCGAN discriminator (reference
    models/networks.py:1074-1129): five k4 s2 convs without bias
    (nc -> ndf/2 -> ndf -> 2 -> 4 -> 8 ndf), BatchNorm after all but the
    first whatever --norm says, LeakyReLU(0.2), a k4 s1 p0 head and a
    Sigmoid: one score in (0, 1) a sample, shape (N,)."""

    def __init__(self, nc=3, ndf=64):
        super().__init__()
        layers = [Conv2d(nc, ndf // 2, 4, 2, 1, bias=False), LeakyReLU(0.2)]
        widths = [ndf // 2, ndf, ndf * 2, ndf * 4, ndf * 8]
        for a, b in zip(widths, widths[1:]):
            layers += [Conv2d(a, b, 4, 2, 1, bias=False), BatchNorm2d(b),
                       LeakyReLU(0.2)]
        layers += [Conv2d(ndf * 8, 1, 4, 1, 0, bias=False), Sigmoid()]
        self.model = Sequential(*layers)

    def forward(self, x, dtype=None):
        y = self.model(x if dtype is None else x.to(dtype))
        return y.reshape(y.shape[0], -1)[:, 0]
