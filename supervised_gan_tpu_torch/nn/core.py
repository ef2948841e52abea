"""Layers of the network zoo as torch modules (NCHW activations).

Counterpart of supervised_gan_tpu/nn/core.py.  Parameter and buffer names
follow torch ``state_dict`` naming (``Sequential`` children keyed by
position), so the reference's ``.pth`` checkpoints and the ones the JAX
package writes (utils/pth.py there) load with ``strict=True``.

Weight init follows the reference's ``weights_init`` (nn/core.py:19-22 of
the JAX package): conv and convT weights N(0, 0.02), BatchNorm weight
N(1, 0.02) and bias 0, conv biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with
fan_in = in_nc * k * k for both conv kinds.

Layers compute in the dtype of their input: a model casts its inputs for
``--compute_dtype bfloat16`` and the weights are cast on the way into each
conv (float32 accumulation, float32 norm statistics).

A conv bias right before a mean-subtracting norm (allowing one bilinear
Upsample in between) is skipped in the forward, as the JAX package's
``_inert_bias_at`` peephole does (nn/core.py:102-115 and 228-236 there):
the norm removes it exactly, so it stays in the ``state_dict`` but gets no
gradient, and Adam leaves it frozen.

With ``_CONV3_IN_FUSED`` (the environment's ``SGAN_TPU_CONV3_IN=1``; off by
default, as in the JAX package, nn/core.py:88-94 there) and the kernels
switched on (not ``--no_pallas``: the JAX region needs PALLAS_ENABLED too,
nn/core.py:149 there) a [Conv2d 3x3 s1 p1, InstanceNorm2d, (Leaky)ReLU?]
run that ``ops.conv3x3_in_supported`` admits is ONE fused conv3x3 + IN
region (nn/core.py:149-176 there).  Its conv bias is passed in, not skipped: the
JAX region takes it, so it gets a gradient (sum of the norm's input
cotangent, rounding noise) and Adam moves it.

Dropout draws its masks, and GaussianNoise its injected noise, from a
``torch.Generator`` that the model assigns (``set_noise_generator``), the
port's counterpart of the JAX ``Ctx`` key.  In a data-parallel run each draw
is made at the global batch's shape and cut to the rank's rows
(parallel/mesh.py), so the ranks' masks and noise are the one-process run's;
under --spatial_mesh it is made at the global height too and cut to the
rank's rows where the tensor is row-sharded (parallel/spatial.py
``draw_like``).  The fused region runs under --spatial_mesh too: its gate
reads the global height, and over split rows its statistics are summed
over the sp group (ops/conv.py).
"""

import math
import os

import torch
from torch import nn

from .. import parallel
from ..parallel import spatial
from ..ops import (batch_norm, bilinear_upsample, conv2d, conv3x3_in_act,
                   conv3x3_in_supported, conv_transpose2d, instance_norm_act,
                   reflection_pad)
from ..ops.kernels import kernels_enabled

_CONV3_IN_FUSED = os.environ.get('SGAN_TPU_CONV3_IN', '0') == '1'


class Conv2d(nn.Module):
    def __init__(self, in_nc, out_nc, kernel, stride=1, padding=0, bias=True):
        super().__init__()
        self.in_nc, self.out_nc = in_nc, out_nc
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight = nn.Parameter(torch.empty(out_nc, in_nc, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_nc)) if bias else None

    def fan_in(self):
        return self.in_nc * self.kernel * self.kernel

    def forward(self, x, skip_bias=False):
        b = None if skip_bias else self.bias
        return conv2d(x, self.weight, b, self.stride, self.padding)


class ConvTranspose2d(Conv2d):
    """Weight in torch's (in, out, kh, kw) layout."""

    def __init__(self, in_nc, out_nc, kernel, stride=2, padding=1, bias=True,
                 output_padding=0):
        super().__init__(in_nc, out_nc, kernel, stride, padding, bias)
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(in_nc, out_nc, kernel, kernel))

    def forward(self, x, skip_bias=False):
        b = None if skip_bias else self.bias
        return conv_transpose2d(x, self.weight, b, self.stride,
                                self.padding, self.output_padding)


class BatchNorm2d(nn.Module):
    """affine BatchNorm with batch statistics always (the reference never
    calls ``.eval()``).  The running buffers exist only so checkpoints keep
    torch's BatchNorm keys; they are never read or updated."""

    def __init__(self, nc, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(nc))
        self.bias = nn.Parameter(torch.empty(nc))
        self.register_buffer('running_mean', torch.zeros(nc))
        self.register_buffer('running_var', torch.ones(nc))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.eps)


class InstanceNorm2d(nn.Module):
    """affine=False, no parameters; alone it is the IN kernel with no
    activation."""

    def __init__(self, nc=None, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return instance_norm_act(x, self.eps, None)


class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, slope=0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return torch.nn.functional.leaky_relu(x, self.slope)


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return torch.sigmoid(x)


class Dropout(nn.Module):
    """Keeps each element with probability 1 - p and scales it by
    1 / (1 - p), in training and sampling alike (the reference never calls
    ``.eval()``).  The mask comes from ``self.generator`` (on x's device)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError('Dropout needs a generator: call '
                               'set_noise_generator on its network')
        keep = 1.0 - self.p
        # drawn at the global batch's shape, this rank's rows kept
        mask = spatial.draw_like(x, lambda shape: parallel.rows(torch.rand(
            parallel.global_shape(shape), generator=self.generator,
            device=x.device))) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class GaussianNoise(nn.Module):
    """y + sigma * N(0, 1), drawn in y's dtype from ``self.generator`` (on
    y's device): the injected noise of the unet levels and the CRN upsample
    blocks (--add_gaussian_noise, --gaussian_sigma).  ``draw`` is the one
    place a draw is made."""

    def __init__(self, sigma=0.1):
        super().__init__()
        self.sigma = sigma
        self.generator = None

    def draw(self, shape, dtype, device):
        if self.generator is None:
            raise RuntimeError('GaussianNoise needs a generator: call '
                               'set_noise_generator on its network')
        return parallel.rows(torch.randn(
            parallel.global_shape(shape), generator=self.generator,
            dtype=dtype, device=device))

    def forward(self, y):
        return y + self.sigma * spatial.draw_like(
            y, lambda shape: self.draw(shape, y.dtype, y.device))


def set_noise_generator(net, generator):
    """Every Dropout and GaussianNoise of ``net`` draws from ``generator``."""
    for m in net.modules():
        if isinstance(m, (Dropout, GaussianNoise)):
            m.generator = generator


class ReflectionPad2d(nn.Module):
    """ReflectionPad2d by one int on every side (the resnet generator's
    pads; nn/core.py:422 there)."""

    def __init__(self, padding):
        super().__init__()
        self.padding = padding

    def forward(self, x):
        p = self.padding
        return reflection_pad(x, p, p, p, p)


class Upsample(nn.Module):
    """Bilinear x-scale upsample, align_corners=True."""

    def __init__(self, scale_factor=2, mode='bilinear'):
        super().__init__()
        if mode != 'bilinear':
            raise NotImplementedError('Upsample mode [%s] not yet ported' % mode)
        self.scale = scale_factor

    def forward(self, x):
        return bilinear_upsample(x, self.scale)


def _slope_of(layer):
    """The activation slope a fused kernel takes for ``layer``, or None when
    it is not ReLU / LeakyReLU."""
    if isinstance(layer, LeakyReLU):
        return layer.slope
    if isinstance(layer, ReLU):
        return 0.0
    return None


class Sequential(nn.Sequential):
    """Position-keyed container.  An InstanceNorm2d followed by ReLU or
    LeakyReLU runs as ONE call of the fused IN kernel with that slope
    (nn/core.py:208-216 of the JAX package), and a conv whose bias the next
    norm cancels runs without it (``_inert_bias_at``).  With
    ``_CONV3_IN_FUSED`` and the kernels on, a conv3x3 + IN (+ act) run is
    one fused region (``_conv3x3_in_at``)."""

    def forward(self, x):
        layers = list(self)
        i = 0
        while i < len(layers):
            layer = layers[i]
            if (_CONV3_IN_FUSED and kernels_enabled()
                    and self._conv3x3_in_at(i, x)):
                slope = _slope_of(layers[i + 2]) if i + 2 < len(layers) \
                    else None
                x = conv3x3_in_act(x, layer.weight, layer.bias,
                                   layers[i + 1].eps, slope)
                i += 2 if slope is None else 3
                continue
            if isinstance(layer, InstanceNorm2d):
                slope = _slope_of(layers[i + 1]) if i + 1 < len(layers) \
                    else None
                x = instance_norm_act(x, layer.eps, slope)
                i += 1 if slope is None else 2
                continue
            if (isinstance(layer, Conv2d) and layer.bias is not None
                    and self._inert_bias_at(i)):
                x = layer(x, skip_bias=True)
            else:
                x = layer(x)
            i += 1
        return x

    def _conv3x3_in_at(self, i, x):
        """True when layer i is a 3x3 s1 p1 conv followed by InstanceNorm2d
        whose input x the fused region takes (the JAX peephole's test)."""
        layers = list(self)
        layer = layers[i]
        return (type(layer) is Conv2d and layer.kernel == 3
                and layer.stride == 1 and layer.padding == 1
                and i + 1 < len(layers)
                and isinstance(layers[i + 1], InstanceNorm2d)
                and conv3x3_in_supported(x, layer.weight))

    def _inert_bias_at(self, i):
        """True when layer i's bias is cancelled exactly downstream: the
        next layer (allowing one constant-preserving Upsample in between)
        is a mean-subtracting norm."""
        layers = list(self)
        j = i + 1
        if j < len(layers) and isinstance(layers[j], Upsample):
            j += 1
        return j < len(layers) and isinstance(layers[j],
                                              (InstanceNorm2d, BatchNorm2d))


def init_weights(net, generator):
    """The reference's weights_init, drawn from ``generator`` (a CPU
    torch.Generator) in module order."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv2d):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.fan_in())
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, BatchNorm2d):
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()
    return net


def count_params(net):
    return sum(p.numel() for p in net.parameters())
