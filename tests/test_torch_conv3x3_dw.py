"""Kernel A, the port's conv3x3 weight gradient (plain version on the CPU),
against the JAX package: `_conv3x3_dw` and `_conv3x3_dw_v2` in interpret
mode (the Pallas dW kernels, rows 2 and 3 of PERF.md's table), and the
`_dw_9dot` dot form at shapes the Pallas gate refuses (Ci != Co); then the
Conv3x3 autograd Function's full backward against autograd of the plain
forward and against jax.vjp of the JAX op.

Tolerance: 1e-4 relative to the largest |dW| of the tensor (plus 1e-5):
each dW entry sums N*H*W f32 products in another order, so its rounding
scales with the sum's magnitude, not with the entry's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu_torch.ops import conv2d
from supervised_gan_tpu_torch.ops.kernels import (conv3x3_dw,
                                                  conv3x3_dw_plain,
                                                  conv3x3_plain)

from test_torch_layout import assert_sum_close, conv_w, nchw, rand


def dw_to_torch(dw_hwio):
    return conv_w(np.asarray(dw_hwio, np.float32))


@pytest.fixture
def interpret():
    p3._set_interpret(True)
    yield
    p3._set_interpret(False)


@pytest.mark.parametrize("c", [32, 64, 128])
def test_dw_matches_pallas_dw_interpret(interpret, c):
    h, w = 16, 1024 // c * 2
    x, g = rand((1, h, w, c), 0), rand((1, h, w, c), 1)
    ref = p3._conv3x3_dw(jnp.asarray(x), jnp.asarray(g))
    assert_sum_close(conv3x3_dw(nchw(x), nchw(g)), dw_to_torch(ref))


@pytest.mark.parametrize("c", [32, 64, 128])
def test_dw_matches_pallas_dw_v2_interpret(interpret, c):
    x, g = rand((1, 128, 128, c), 2), rand((1, 128, 128, c), 3)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    assert p3.dw_v2_supported(xj, gj)
    ref = p3._conv3x3_dw_v2(xj, gj)
    assert_sum_close(conv3x3_dw(nchw(x), nchw(g)), dw_to_torch(ref))


# the CRN's unequal-channel sites (stem, label embed, halving conv, head)
# and a batch of 2 with ragged sizes
@pytest.mark.parametrize("n,h,w,ci,co", [(1, 8, 8, 10, 64), (1, 16, 16, 2, 64),
                                         (1, 16, 16, 128, 64),
                                         (1, 32, 32, 64, 1),
                                         (2, 9, 13, 5, 7)])
def test_dw_matches_dw_9dot(n, h, w, ci, co):
    x, g = rand((n, h, w, ci), 4), rand((n, h, w, co), 5)
    ref = p3._dw_9dot(jnp.asarray(x), jnp.asarray(g))
    assert_sum_close(conv3x3_dw(nchw(x), nchw(g)), dw_to_torch(ref))


def test_dw_plain_is_float32_for_bf16_inputs():
    x = torch.from_numpy(rand((1, 4, 8, 8), 6))
    g = torch.from_numpy(rand((1, 3, 8, 8), 7))
    dw = conv3x3_dw(x.bfloat16(), g.bfloat16())
    assert dw.dtype == torch.float32
    ref = conv3x3_dw_plain(x.bfloat16().float(), g.bfloat16().float())
    assert_sum_close(dw, ref, rtol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_function_backward(bias):
    """dx, dW, db of the Function against autograd of conv3x3_plain and
    against jax.vjp of the JAX op (the Pallas custom VJP in interpret mode
    at this C_in == C_out shape)."""
    x = rand((1, 16, 32, 64), 8)
    w = rand((3, 3, 64, 64), 9, 0.05)
    b = rand((64,), 10, 0.1) if bias else None
    g = rand((1, 16, 32, 64), 11)
    args = [nchw(x), conv_w(w)] + ([torch.from_numpy(b)] if bias else [])
    for t in args:
        t.requires_grad_(True)
    y = conv2d(args[0], args[1], args[2] if bias else None, 1, 1)
    ours = torch.autograd.grad(y, args, nchw(g))
    plain_args = [t.detach().clone().requires_grad_(True) for t in args]
    y_plain = conv3x3_plain(*plain_args)
    plain = torch.autograd.grad(y_plain, plain_args, nchw(g))
    for o, p in zip(ours, plain):
        assert_sum_close(o, p)

    p3._set_interpret(True)
    try:
        xj, wj = jnp.asarray(x), jnp.asarray(w)
        assert p3.supported(xj, wj, 1, 1)
        bj = jnp.asarray(b) if bias else None
        _, pull = jax.vjp(lambda *a: p3.conv3x3_same(*a) if bias
                          else p3.conv3x3_same(a[0], a[1], None),
                          *([xj, wj] + ([bj] if bias else [])))
        ref = pull(jnp.asarray(g))
    finally:
        p3._set_interpret(False)
    assert_sum_close(ours[0], nchw(ref[0]))
    assert_sum_close(ours[1], dw_to_torch(ref[1]))
    if bias:
        assert_sum_close(ours[2], np.asarray(ref[2]))


def test_dw_refuses_other_devices():
    with pytest.raises(ValueError):
        conv3x3_dw(torch.empty((1, 4, 8, 8), device='meta'),
                   torch.empty((1, 4, 8, 8), device='meta'))
