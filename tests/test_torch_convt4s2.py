"""The port's convt4s2 (plain version on the CPU) against the JAX package's
Pallas kernel in interpret mode where supported() holds, against
ops.conv.conv_transpose2d at the G1 sites the Pallas gate leaves to XLA
(Ci = 8, Co = 2), and against torch's own conv_transpose2d as an oracle
independent of both packages.  Tolerance 1e-4: f32 sums of 4*Ci terms in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu.ops.pallas import convt4s2 as pt
from supervised_gan_tpu_torch.ops.kernels import convt4s2

from test_torch_layout import convt_w, nchw, nhwc, rand, vec


@pytest.fixture
def interpret():
    pt._set_interpret(True)
    yield
    pt._set_interpret(False)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("hw,ci,co", [(16, 64, 32), (8, 256, 256)])
def test_convt4s2_matches_pallas_interpret(interpret, hw, ci, co, bias):
    x = rand((1, hw, hw, ci), 0)
    w = rand((4, 4, ci, co), 1, 0.05)
    b = rand((co,), 2, 0.1) if bias else None
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    assert pt.supported(xj, wj)
    y = pt.convt4s2(xj, wj, None if b is None else jnp.asarray(b))
    ours = convt4s2(nchw(x), convt_w(w), vec(b))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


# G1's first (8 -> 256, no bias) and last (32 -> 2, no bias) sites
@pytest.mark.parametrize("hw,ci,co", [(4, 8, 256), (16, 32, 2)])
def test_convt4s2_matches_xla_convt(hw, ci, co):
    x = rand((1, hw, hw, ci), 3)
    w = rand((4, 4, ci, co), 4, 0.05)
    y = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), None, 2, 1)
    ours = convt4s2(nchw(x), convt_w(w))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,h,w,ci,co", [(2, 5, 7, 3, 6), (1, 8, 8, 16, 4)])
def test_convt4s2_matches_torch_oracle(n, h, w, ci, co):
    x = torch.from_numpy(rand((n, ci, h, w), 5))
    wt = torch.from_numpy(rand((ci, co, 4, 4), 6, 0.1))
    b = torch.from_numpy(rand((co,), 7, 0.1))
    torch.testing.assert_close(convt4s2(x, wt, b),
                               F.conv_transpose2d(x, wt, b, 2, 1),
                               rtol=1e-4, atol=1e-4)


def test_convt4s2_refuses_other_devices():
    x = torch.empty((1, 4, 8, 8), device='meta')
    w = torch.empty((4, 2, 4, 4), device='meta')
    with pytest.raises(ValueError):
        convt4s2(x, w)
