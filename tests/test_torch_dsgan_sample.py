"""The DSGAN sampler slice as a whole on the CPU: G1 (fcgan) -> bilinear_2
-> G2 (CRN), the port (plain versions of its kernels) against the JAX
package on the same weights and the same numpy noise, at a small config:
G1 ngf 8, 3 layers, noiseSize 2 -> 32^2; bilinear_2 -> 64^2; G2 ngf 16,
noise_nc2 4, noiseSize2 1.

The JAX side runs twice: with Pallas enabled in interpret mode (at this size
its supported() admits G2's 16 -> 16 conv at 64^2), and with Pallas off.
With Pallas on, its InstanceNorm is `fused_instance_norm_act`, set to the
f32 subtract form (SGAN_TPU_IN_FMA=0, as tests/test_fused_norm.py does for
its stream kernels): at noiseSize2 1 the coarsest block upsamples a 1x1 conv
output, so its 2x2 planes are constant (variance 0), and the default FMA
fold x*s + t leaves ~1e-5 of rounding there that the following norms scale
up to ~1e-2 at the output; the subtract form, like the port, gives 0.
Tolerance 2e-3, looser than the per-op 1e-4: InstanceNorm after a chain of
convs divides by small per-channel deviations, which magnifies the
reordered-sum differences layer after layer (and the port keeps the conv
biases the JAX side skips before a norm, nn/core.py:102-115 there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.nn import core as jcore
from supervised_gan_tpu.ops import bilinear_upsample as j_bilinear
from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu.ops.pallas import convt4s2 as pt
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.ops import bilinear_upsample
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, rand
from test_torch_layout import one_thread  # noqa: F401

G1_ARGS = (2, 0, 8, 'fcgan', 'instance', False)
G1_KW = dict(n_layers_G=3, use_fcn=True, noise_nc=4)
G2_ARGS = (2, 1, 16, 'crn', 'instance', False)
G2_KW = dict(n_layers_G=5, noise_nc=4, upsample_mode='bilinear',
             n_layers_CRN_block=2)


@pytest.fixture(scope='module')
def slice_setup():
    jg1, jg2 = jnn.define_G(*G1_ARGS, **G1_KW), jnn.define_G(*G2_ARGS, **G2_KW)
    p1, p2 = jax_params(jg1, 10), jax_params(jg2, 11)
    tg1, tg2 = tnn.define_G(*G1_ARGS, **G1_KW), tnn.define_G(*G2_ARGS, **G2_KW)
    tg1.load_state_dict(from_jax_params(tg1, p1), strict=True)
    tg2.load_state_dict(from_jax_params(tg2, p2), strict=True)
    noise1 = rand((1, 2, 2, 4), 12)
    noise2 = rand((1, 1, 1, 4), 13)
    return jg1, jg2, p1, p2, tg1, tg2, noise1, noise2


def _jax_sample(setup):
    jg1, jg2, p1, p2, _, _, n1, n2 = setup

    def sample(p1, p2, n1, n2):
        ctx = jnn.Ctx(jax.random.PRNGKey(0))
        a = jg1.apply(p1, n1, ctx)
        label = j_bilinear(a, 2)
        return a, label, jg2.apply(p2, label, n2, ctx)

    # a fresh function per call: the Pallas switch is read while tracing
    out = jax.jit(sample)(p1, p2, jnp.asarray(n1), jnp.asarray(n2))
    return [np.asarray(v, np.float32) for v in out]


def _port_sample(setup, dtype=torch.float32):
    _, _, _, _, tg1, tg2, n1, n2 = setup
    with torch.no_grad():
        a = tg1(nchw(n1).to(dtype))
        label = bilinear_upsample(a, 2)
        b = tg2(label, nchw(n2).to(dtype))
    return [nhwc(v) for v in (a, label, b)], (a, label, b)


@pytest.fixture
def pallas_mode(request, monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    before = jcore.PALLAS_ENABLED
    jcore.set_pallas_enabled(request.param)
    p3._set_interpret(request.param)
    pt._set_interpret(request.param)
    yield request.param
    jcore.set_pallas_enabled(before)
    p3._set_interpret(False)
    pt._set_interpret(False)


@pytest.mark.parametrize("pallas_mode", [True, False], indirect=True,
                         ids=["pallas_interpret", "xla"])
def test_sample_matches_jax(slice_setup, pallas_mode):
    ref = _jax_sample(slice_setup)
    ours, _ = _port_sample(slice_setup)
    assert [r.shape for r in ref] == [(1, 32, 32, 2), (1, 64, 64, 2),
                                      (1, 64, 64, 1)]
    for name, o, r in zip(('G1', 'transform', 'G2'), ours, ref):
        np.testing.assert_allclose(o, r, rtol=2e-3, atol=2e-3, err_msg=name)


def test_sample_bf16_runs_in_bf16(slice_setup):
    """--compute_dtype bfloat16: bf16 activations and weights into every
    kernel, f32 accumulation and statistics.  G1 and the transformed label
    stay within 2e-2 of the f32 sample (a few bf16 ulps of tanh outputs).
    G2 is checked for dtype and range only: at this toy size its coarsest
    InstanceNorm runs over 2x2 planes, which turns bf16 rounding into
    O(0.1) output changes on either package."""
    ours, _ = _port_sample(slice_setup)
    ours16, tensors = _port_sample(slice_setup, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tensors)
    for name, o, r in zip(('G1', 'transform'), ours16[:2], ours[:2]):
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=2e-2, err_msg=name)
    assert np.isfinite(ours16[2]).all() and np.abs(ours16[2]).max() <= 1.0
