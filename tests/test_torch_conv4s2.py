"""Kernel C, the port's k4 s2 p1 conv (plain version on the CPU), against
the JAX package: `conv4s2_same` in interpret mode where its gate holds (row
5 of PERF.md's table), and ops.conv.conv2d(stride 2, padding 1) at the 1-,
2- and 3-channel stems the gate refuses; then the Conv4s2 and ConvT4s2
autograd Functions' full backward (dx through the other kernel, dW through
torch.nn.grad.conv2d_weight, db) against autograd of the plain forward, and
against jax.vjp of the JAX ops.  Tolerance 1e-4: f32 sums of 16*Ci
products in another order (dW: relative to its largest entry, since each
sums every output pixel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu.ops.pallas import conv4s2 as p4
from supervised_gan_tpu_torch.ops import conv2d, conv_transpose2d
from supervised_gan_tpu_torch.ops.kernels import (conv4s2, conv4s2_plain,
                                                  convt4s2_plain)

from test_torch_layout import (assert_sum_close, conv_w, convt_w, nchw, nhwc,
                               rand, vec)


@pytest.fixture
def interpret():
    p3._set_interpret(True)
    yield
    p3._set_interpret(False)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("hw,ci,co", [(32, 64, 64), (32, 128, 64)])
def test_conv4s2_matches_pallas_interpret(interpret, hw, ci, co, bias):
    x = rand((1, hw, hw, ci), 0)
    w = rand((4, 4, ci, co), 1, 0.05)
    b = rand((co,), 2, 0.1) if bias else None
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    assert p4.supported(xj, wj, 2, 1)
    y = p4.conv4s2_same(xj, wj, None if b is None else jnp.asarray(b))
    ours = conv4s2(nchw(x), conv_w(w), vec(b))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ci", [1, 2, 3, 64])
def test_conv4s2_matches_xla_conv(ci):
    x = rand((1, 16, 12, ci), 3)
    w = rand((4, 4, ci, 32), 4, 0.1)
    b = rand((32,), 5, 0.1)
    y = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 2, 1)
    ours = conv4s2(nchw(x), conv_w(w), vec(b))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


def test_conv4s2_odd_sizes_match_torch():
    x = torch.from_numpy(rand((2, 3, 7, 9), 6))
    w = torch.from_numpy(rand((5, 3, 4, 4), 7, 0.2))
    torch.testing.assert_close(conv4s2(x, w),
                               torch.nn.functional.conv2d(x, w, None, 2, 1),
                               rtol=1e-4, atol=1e-4)


def _grads(fn, args, g):
    ts = [t.detach().clone().requires_grad_(True) for t in args]
    return torch.autograd.grad(fn(*ts), ts, g)


@pytest.mark.parametrize("ci", [3, 64])
def test_conv4s2_function_backward(ci):
    x, w, b = (rand((1, 16, 16, ci), 8), rand((4, 4, ci, 32), 9, 0.05),
               rand((32,), 10, 0.1))
    g = rand((1, 8, 8, 32), 11)
    args = [nchw(x), conv_w(w), vec(b)]
    ours = _grads(lambda *a: conv2d(*a, stride=2, padding=1), args, nchw(g))
    plain = _grads(conv4s2_plain, args, nchw(g))
    for o, p in zip(ours, plain):
        assert_sum_close(o, p)
    _, pull = jax.vjp(lambda *a: jconv.conv2d(*a, 2, 1), jnp.asarray(x),
                      jnp.asarray(w), jnp.asarray(b))
    rx, rw, rb = pull(jnp.asarray(g))
    assert_sum_close(ours[0], nchw(rx))
    assert_sum_close(ours[1], conv_w(rw))
    assert_sum_close(ours[2], np.asarray(rb))


@pytest.mark.parametrize("ci,co", [(64, 32), (32, 2)])
def test_convt4s2_function_backward(ci, co):
    x, w, b = (rand((1, 8, 8, ci), 12), rand((4, 4, ci, co), 13, 0.05),
               rand((co,), 14, 0.1))
    g = rand((1, 16, 16, co), 15)
    args = [nchw(x), convt_w(w), vec(b)]
    ours = _grads(lambda *a: conv_transpose2d(*a, stride=2, padding=1), args,
                  nchw(g))
    plain = _grads(convt4s2_plain, args, nchw(g))
    for o, p in zip(ours, plain):
        assert_sum_close(o, p)
    _, pull = jax.vjp(lambda *a: jconv.conv_transpose2d(*a, 2, 1),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rx, rw, rb = pull(jnp.asarray(g))
    assert_sum_close(ours[0], nchw(rx))
    assert_sum_close(ours[1], convt_w(rw))
    assert_sum_close(ours[2], np.asarray(rb))


def test_conv4s2_refuses_other_devices():
    with pytest.raises(ValueError):
        conv4s2(torch.empty((1, 4, 8, 8), device='meta'),
                torch.empty((4, 4, 4, 4), device='meta'))
