"""Kernel B, the port's InstanceNorm + activation backward (plain version on
the CPU), against the JAX package: the streaming `_stream_bwd` kernels in
interpret mode (rows 10 and 11 of PERF.md's table) and the VJP of
`fused_instance_norm_act` with its FMA fold off (the f32 subtract form the
port computes); then the InstanceNormAct autograd Function against autograd
of the plain forward and against jax.vjp.  Tolerance 1e-4: f32 statistics
reduced in another order, dx of O(1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch.ops import instance_norm_act
from supervised_gan_tpu_torch.ops.kernels import (instance_norm_act_plain,
                                                  instance_norm_bwd)

from test_torch_layout import nchw, nhwc, rand

SLOPES = [None, 0.0, 0.2]


def _xg(shape, seed):
    return rand(shape, seed, 2.0) + 0.5, rand(shape, seed + 1)


def _stats(x):
    _, mean, rstd = instance_norm_act_plain(nchw(x), 1e-5, None,
                                            return_stats=True)
    return mean, rstd


@pytest.mark.parametrize("slope", SLOPES)
def test_in_bwd_matches_stream_bwd_interpret(monkeypatch, slope):
    x, g = _xg((1, 16, 16, 64), 0)
    xj = jnp.asarray(x)
    monkeypatch.setattr(sin, '_INTERPRET', True)
    assert sin.stream_supported(xj)
    _, mj, rj = sin._stream_fwd(xj, 1e-5, slope)
    ref = sin._stream_bwd(xj, jnp.asarray(g), mj, rj, slope)
    mean, rstd = _stats(x)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rj), rtol=1e-5)
    ours = instance_norm_bwd(nchw(x), nchw(g), mean, rstd, slope)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("slope", SLOPES)
def test_in_bwd_matches_fused_vjp(monkeypatch, slope):
    monkeypatch.setattr(sin, '_FMA', False)
    x, g = _xg((2, 8, 12, 16), 2)
    _, pull = jax.vjp(lambda v: sin.fused_instance_norm_act(v, 1e-5, slope),
                      jnp.asarray(x))
    (ref,) = pull(jnp.asarray(g))
    mean, rstd = _stats(x)
    ours = instance_norm_bwd(nchw(x), nchw(g), mean, rstd, slope)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("slope", SLOPES)
def test_instance_norm_function_backward(monkeypatch, slope):
    monkeypatch.setattr(sin, '_FMA', False)
    x, g = _xg((1, 12, 10, 8), 4)
    xt = nchw(x).requires_grad_(True)
    (ours,) = torch.autograd.grad(instance_norm_act(xt, 1e-5, slope), xt,
                                  nchw(g))
    xp = nchw(x).requires_grad_(True)
    (plain,) = torch.autograd.grad(instance_norm_act_plain(xp, 1e-5, slope),
                                   xp, nchw(g))
    torch.testing.assert_close(ours, plain, rtol=1e-4, atol=1e-4)
    _, pull = jax.vjp(lambda v: sin.fused_instance_norm_act(v, 1e-5, slope),
                      jnp.asarray(x))
    (ref,) = pull(jnp.asarray(g))
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_in_forward_stats_match_plain_definition():
    x, _ = _xg((2, 3, 5, 7), 6)
    y, mean, rstd = instance_norm_act_plain(nchw(x), 1e-5, 0.2,
                                            return_stats=True)
    xt = nchw(x).double()
    np.testing.assert_allclose(mean.numpy(), xt.mean((2, 3)).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        rstd.numpy(), (1 / torch.sqrt(xt.var((2, 3), unbiased=False) + 1e-5))
        .numpy(), rtol=1e-5)
    assert y.shape == (2, 7, 3, 5) and mean.shape == rstd.shape == (2, 7)


def test_in_bwd_refuses_other_devices():
    t = torch.empty((1, 4, 8, 8), device='meta')
    s = torch.empty((1, 4), device='meta')
    with pytest.raises(ValueError):
        instance_norm_bwd(t, t, s, s)
