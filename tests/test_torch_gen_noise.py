"""The generators' injected Gaussian noise (--add_gaussian_noise,
--gaussian_sigma) and the sigmoid / softmax output activations of the port
on the CPU, against the JAX package.

The unet (every level's output, before its skip concat) and the CRN (every
upsample block but the head's) add sigma N(0, 1).  The JAX package draws
level n's noise from fold_in(forward key, n) in call order; the test feeds
the port's GaussianNoise modules those same draws through their ``draw``
hook, so both sides add the same noise, at sigma 0.3 (not the default, so
the option's value is carried too).  Tolerance 2e-3, as the unet_128 and
the CRN forwards of tests/test_torch_train_modules.py and
tests/test_torch_dsgan_sample.py (InstanceNorm over 2x2 planes magnifies
reordered f32 sums); the noise moves the output far more than that.  The
activations: 1e-6."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.nn import generators as jgen
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.nn import generators as tgen
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, rand
from test_torch_layout import one_thread  # noqa: F401

SIGMA = 0.3
NETS = {
    # (define_G args, kw, input shape NHWC, noise shape NHWC or None,
    #  GaussianNoise modules)
    'unet_128': ((2, 1, 4, 'unet_128', 'instance', False), {},
                 (1, 128, 128, 2), None, 6),
    'unet_256': ((2, 1, 4, 'unet_256', 'instance', False), {},
                 (1, 256, 256, 2), None, 7),
    'crn': ((2, 1, 8, 'crn', 'instance', False),
            dict(n_layers_G=5, noise_nc=4, upsample_mode='bilinear',
                 n_layers_CRN_block=2), (1, 64, 64, 2), (1, 1, 1, 4), 5),
}


@pytest.fixture(autouse=True)
def subtract_form_in(monkeypatch):
    """The JAX fused IN in its f32 subtract form, as the port computes it."""
    monkeypatch.setattr(sin, '_FMA', False)


def _pair(name, seed=0):
    args, kw, _, _, _ = NETS[name]
    kw = dict(kw, add_gaussian_noise=True, gaussian_sigma=SIGMA)
    jnet, tnet = jnn.define_G(*args, **kw), tnn.define_G(*args, **kw)
    params = jax_params(jnet, seed)
    tnet.load_state_dict(from_jax_params(tnet, params), strict=True)
    return jnet, params, tnet


def replay_jax_draws(net, fkey):
    """Make every GaussianNoise of ``net`` draw what the JAX forward with
    key ``fkey`` draws: call n takes fold_in(fkey, n).  Returns the list of
    the shapes drawn (NCHW), in call order."""
    n = itertools.count()
    shapes = []

    def draw(shape, dtype, device):
        shapes.append(tuple(shape))
        nhwc_shape = (shape[0], shape[2], shape[3], shape[1])
        z = jax.random.normal(jax.random.fold_in(fkey, next(n)), nhwc_shape)
        return nchw(z).to(dtype=dtype, device=device)

    for m in net.modules():
        if isinstance(m, tnn.GaussianNoise):
            m.draw = draw
    return shapes


@pytest.mark.parametrize("name", ['unet_256', 'crn'])
def test_injected_noise_matches_jax(name):
    jnet, params, tnet = _pair(name)
    _, _, xs, ns, _ = NETS[name]
    inputs = [rand(xs, 1)] + ([] if ns is None else [rand(ns, 2)])
    # jitted: the eager JAX forward compiles op by op (~3x slower)
    jforward = jax.jit(lambda p, key, *a: jnet.apply(p, *a, jnn.Ctx(key)))
    fkey = jax.random.PRNGKey(7)
    shapes = replay_jax_draws(tnet, fkey)
    ref = np.asarray(jforward(params, fkey, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        ours = tnet(*map(nchw, inputs))
    assert len(shapes) == NETS[name][4]
    assert sum(isinstance(m, tnn.GaussianNoise) for m in tnet.modules()) \
        == NETS[name][4]
    np.testing.assert_allclose(nhwc(ours), ref, rtol=2e-3, atol=2e-3)
    # the noise is there: another key moves the JAX output well past the
    # tolerance
    other = np.asarray(jforward(params, jax.random.PRNGKey(8),
                                *map(jnp.asarray, inputs)))
    assert np.abs(other - ref).max() > 50 * 2e-3


@pytest.mark.parametrize("name", ['unet_128', 'crn'])
def test_noise_draws_from_the_generator(name):
    """The port's own draws come from the generator set_noise_generator
    gives it: one seed, one output; another seed, another."""
    _, _, tnet = _pair(name)
    _, _, xs, ns, _ = NETS[name]
    args = [nchw(rand(xs, 3))] + ([] if ns is None else [nchw(rand(ns, 4))])
    outs = []
    for seed in (1, 1, 2):
        tnn.set_noise_generator(tnet, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(tnet(*args))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_noise_keeps_the_state_dict_keys():
    """GaussianNoise holds no parameter: the keys (what a .pth file holds)
    are the same with the option and without it."""
    args, kw, _, _, _ = NETS['unet_256']
    plain = tnn.define_G(*args, **kw)
    noisy = tnn.define_G(*args, **dict(kw, add_gaussian_noise=True))
    assert list(plain.state_dict()) == list(noisy.state_dict())
    assert tnn.count_params(plain) == tnn.count_params(noisy)


def test_unset_generator_raises():
    _, _, tnet = _pair('unet_128')
    with pytest.raises(RuntimeError, match='set_noise_generator'):
        tnet(nchw(rand(NETS['unet_128'][2], 5)))


@pytest.mark.parametrize("activation", ['sigmoid', 'softmax', 'tanh',
                                        'none'])
def test_activations_match_jax(activation):
    """softmax over the channels: dim 1 of NCHW, the last axis of NHWC."""
    y = rand((2, 9, 7, 3), 6, 4.0)
    ref = np.asarray(jgen.activate(jnp.asarray(y), activation))
    ours = nhwc(tgen.activate(nchw(y), activation))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match='unknown activation'):
        tgen.activate(torch.zeros(1, 1, 1, 1), 'relu6')
