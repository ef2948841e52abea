"""What one reference step needs besides its nets: where its random draws
come from and in which precision its convolutions compute.

Draws.  The recipes draw their noise inputs, dropout masks and injected
Gaussian noise from one generator seeded with the run's seed, in the order
the step's forward passes reach them.  ``Draws`` is that generator: the same
seed and the same calls give the same numbers on one device.  A ``meta``
device gives empty tensors (the FLOP count needs shapes only).

Precision.  ``f32``: every op in float32 with TF32 off (the caller turns it
off).  ``fp8``: the control.  Each convolution reads its input and weight
rounded to float8 e4m3 with a per-tensor scale, and its backward reads the
incoming gradient rounded to float8 e5m2 with a per-tensor scale: the
precision one step below the configurations' bfloat16.
"""

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class Draws:
    """N(0, 1) and U(0, 1) draws from one seeded generator on ``device``;
    ``noise_dtype``: the dtype the injected Gaussian noise is drawn in (the
    configuration's compute dtype)."""

    def __init__(self, seed, device, noise_dtype=torch.float32):
        self.device = torch.device(device)
        self.noise_dtype = noise_dtype
        self.gen = None
        if self.device.type != 'meta':
            self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def randn(self, shape, dtype=torch.float32):
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return torch.randn(shape, generator=self.gen, dtype=dtype,
                           device=self.device).float()

    def rand(self, shape):
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return torch.rand(shape, generator=self.gen, device=self.device)


def _fp8(t, dtype, top):
    """t rounded to ``dtype`` under a per-tensor scale that maps max |t| to
    ``top``, back in float32."""
    amax = t.detach().abs().max().float().clamp_min(1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8Conv(torch.autograd.Function):
    """conv2d (or its transpose) on e4m3 inputs and weights, backward on an
    e5m2 gradient."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transpose):
        xq = _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = _fp8(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        ctx.cfg = (stride, padding, transpose)
        if transpose:
            return F.conv_transpose2d(xq, wq, None, stride, padding)
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, transpose = ctx.cfg
        gq = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        if transpose:
            # y = conv_transpose(x, w) is the input gradient of conv(., w)
            # at x: dx = conv(g, w), dw = weight gradient of conv(g) by x
            dx = F.conv2d(gq, wq, None, stride, padding)
            dw = conv2d_weight(gq, wq.shape, xq, stride, padding)
        else:
            dx = conv2d_input(xq.shape, wq, gq, stride, padding)
            dw = conv2d_weight(xq, wq.shape, gq, stride, padding)
        return dx, dw, None, None, None


class Precision:
    """The convolution every reference layer calls."""

    def __init__(self, name='f32'):
        if name not in ('f32', 'fp8'):
            raise ValueError('precision %r: f32 or fp8' % (name,))
        self.name = name

    def conv(self, x, w, b, stride, padding, transpose=False):
        if self.name == 'fp8':
            y = _Fp8Conv.apply(x, w, stride, padding, transpose)
            return y if b is None else y + b.view(1, -1, 1, 1)
        if transpose:
            return F.conv_transpose2d(x, w, b, stride, padding)
        return F.conv2d(x, w, b, stride, padding)


class Ctx:
    """One step's draws and precision."""

    def __init__(self, draws, precision='f32'):
        self.draws = draws
        self.prec = Precision(precision)
