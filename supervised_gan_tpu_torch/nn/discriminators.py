"""The PatchGAN discriminator of the DSGAN banks (NCHW).

Counterpart of supervised_gan_tpu/nn/discriminators.py:26-89 (`_trunk`,
`NLayerDiscriminator`), pixel path only.  For scale_factor > 1 the input
first goes through the fixed Gaussian blur + subsample front end
(ops.blur_downsample), which has no parameters.  Padding is 1 (the
reference's Python-2 padw).
"""

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
        """``dtype``: the compute dtype, applied after the front end (the
        JAX package blurs the input as it comes and casts at the stem)."""
        if self.scale_factor > 1:
            x = blur_downsample(x, self.scale_factor)
        if dtype is not None:
            x = x.to(dtype)
        return self.model(x)
