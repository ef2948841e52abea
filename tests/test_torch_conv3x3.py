"""The port's conv3x3 (plain version on the CPU) against the JAX package:
the Pallas kernel in interpret mode where its supported() holds, and
ops.conv.conv2d at the CRN's unequal-channel shapes.  Tolerance 1e-4: f32
products summed in another order (Ci*9 <= 1152 terms of O(1) size)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu_torch.ops.kernels import conv3x3, conv3x3_plain

from test_torch_layout import conv_w, nchw, nhwc, rand, vec


@pytest.fixture
def interpret():
    p3._set_interpret(True)
    yield
    p3._set_interpret(False)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(1, 16, 64, 16), (1, 16, 32, 64)])
def test_conv3x3_matches_pallas_interpret(interpret, shape, bias):
    c = shape[-1]
    x = rand(shape, 0)
    w = rand((3, 3, c, c), 1, 0.05)
    b = rand((c,), 2, 0.1) if bias else None
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    assert p3.supported(xj, wj, 1, 1)
    y = p3.conv3x3_same(xj, wj, None if b is None else jnp.asarray(b))
    ours = conv3x3(nchw(x), conv_w(w), vec(b))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


# the CRN's unequal-channel sites: blockh5 stem, label embed, the
# bilinear-block halving conv, the 1-channel head
@pytest.mark.parametrize("hw,ci,co", [(8, 10, 64), (16, 2, 64),
                                      (16, 128, 64), (32, 64, 1)])
def test_conv3x3_matches_xla_conv(hw, ci, co):
    x = rand((1, hw, hw, ci), 3)
    w = rand((3, 3, ci, co), 4, 0.05)
    b = rand((co,), 5, 0.1)
    y = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1, 1)
    ours = conv3x3(nchw(x), conv_w(w), vec(b))
    np.testing.assert_allclose(nhwc(ours), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


def test_conv3x3_plain_keeps_bf16():
    """bf16 in, bf16 out; the f32 accumulation differs from the f32 result
    only by the inputs' and the output's bf16 rounding (2e-2 on O(1))."""
    x = torch.from_numpy(rand((1, 8, 12, 12), 6))
    w = torch.from_numpy(rand((16, 8, 3, 3), 7, 0.1))
    y = conv3x3(x.bfloat16(), w.bfloat16())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), conv3x3_plain(x, w), rtol=2e-2,
                               atol=2e-2)


def test_conv3x3_refuses_other_devices():
    """Only CPU tensors take the plain version; any other device must reach
    the kernel or raise, never fall back."""
    x = torch.empty((1, 4, 8, 8), device='meta')
    w = torch.empty((4, 4, 3, 3), device='meta')
    with pytest.raises(ValueError):
        conv3x3(x, w)
