"""The port's fused InstanceNorm + activation (plain version on the CPU)
against the JAX package: `fused_instance_norm_act` (its XLA form: the
whole-plane `_kernel` has no interpret switch, instance_norm.py:141), the
streaming `_stream_fwd` kernels in interpret mode, and ops.norm.
instance_norm.  Tolerance 1e-4: f32 statistics reduced in another order,
outputs of O(1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops import norm as jnorm
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch.ops.kernels import instance_norm_act

from test_torch_layout import nchw, nhwc, rand

SLOPES = [None, 0.0, 0.2]


def _x(shape, seed=0):
    # offset mean and non-unit scale, as a conv output would have
    return rand(shape, seed, 2.0) + 0.5


@pytest.mark.parametrize("slope", SLOPES)
def test_in_act_matches_fused_xla_form(slope):
    x = _x((2, 8, 12, 16))
    y = sin.fused_instance_norm_act(jnp.asarray(x), 1e-5, slope)
    ours = instance_norm_act(nchw(x), 1e-5, slope)
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("slope", SLOPES)
def test_in_act_matches_stream_kernels_interpret(monkeypatch, slope):
    x = _x((1, 16, 16, 64), 1)
    xj = jnp.asarray(x)
    monkeypatch.setattr(sin, '_INTERPRET', True)
    assert sin.stream_supported(xj)
    y, _, _ = sin._stream_fwd(xj, 1e-5, slope)
    ours = instance_norm_act(nchw(x), 1e-5, slope)
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


def test_in_matches_ops_instance_norm():
    x = _x((1, 32, 32, 4), 2)
    y = jnorm.instance_norm(jnp.asarray(x), 1e-5)
    ours = instance_norm_act(nchw(x), 1e-5, None)
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


def test_in_act_refuses_other_devices():
    with pytest.raises(ValueError):
        instance_norm_act(torch.empty((1, 4, 8, 8), device='meta'))
