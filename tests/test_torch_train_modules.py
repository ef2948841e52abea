"""The modules of the DSGAN training slice on the CPU, each against the JAX
package with weights carried by from_jax_params and inputs made with numpy:
the PatchGAN D banks (with the blur front end and the sigmoid head), the
unet_128 F2, the blur itself, the losses (and bce_loss's bounded gradient at
saturated predictions), the image pools (decisions fed in), dropout, the
golden parameter counts and the inert biases.

Tolerances: 1e-5 for the blur and the losses (a few f32 operations);
2e-4 for a D bank (InstanceNorm over 6x6 to 16x16 planes after chains of
convs magnifies reordered sums); 2e-3 for unet_128 at 128 px, whose inner
norms run over 2x2 planes (as the sampler slice test states)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import pools as jpools
from supervised_gan_tpu.nn import losses as jlosses
from supervised_gan_tpu.ops import resample as jres
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.models import pools as tpools
from supervised_gan_tpu_torch.nn import losses as tlosses
from supervised_gan_tpu_torch.ops import blur_downsample
from supervised_gan_tpu_torch.ops import resample as tres
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, rand
from test_torch_layout import one_thread  # noqa: F401

CTX = jnn.Ctx(jax.random.PRNGKey(0))


@pytest.fixture(autouse=True)
def subtract_form_in(monkeypatch):
    """The JAX fused IN in its f32 subtract form, as the port computes it."""
    monkeypatch.setattr(sin, '_FMA', False)


@pytest.mark.parametrize("scale", [2, 4])
def test_blur_downsample_matches_jax(scale):
    x = rand((2, 20, 24, 3), 0)
    ref = jres.blur_downsample(jnp.asarray(x), scale)
    np.testing.assert_allclose(nhwc(blur_downsample(nchw(x), scale)),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tres.gauss_blur_kernel(scale),
                                  jres.gauss_blur_kernel(scale)[..., 0, 0])


D_CASES = [(2, 8, 3, 1, True), (2, 8, 3, 2, True), (3, 8, 4, 1, False),
           (3, 8, 2, 2, False)]


@pytest.mark.parametrize("in_nc,ndf,n_layers,scale,sigmoid", D_CASES)
def test_discriminator_matches_jax(in_nc, ndf, n_layers, scale, sigmoid):
    args = (in_nc, ndf, 'n_layers', n_layers, 'instance', sigmoid, scale)
    jd, td = jnn.define_D(*args), tnn.define_D(*args)
    params = jax_params(jd, 1)
    td.load_state_dict(from_jax_params(td, params), strict=True)
    x = rand((1, 64, 64, in_nc), 2)
    ref = jd.apply(params, jnp.asarray(x), CTX)
    with torch.no_grad():
        ours = td(nchw(x))
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_golden_d_bank_counts():
    """D1: 2 x 693,729; D2: 2,764,737 (3 layers) and 6,959,553 (4 layers)
    per member, the README DSGAN banks."""
    d1 = [tnn.define_D(2, 32, 'n_layers', 3, 'instance', True, s)
          for s in (1, 2)]
    d2 = [tnn.define_D(3, 64, 'n_layers', n, 'instance', True, s)
          for n, s in ((3, 1), (4, 1), (3, 2), (4, 2))]
    assert [tnn.count_params(d) for d in d1] == [693729] * 2
    assert [tnn.count_params(d) for d in d2] == [2764737, 6959553,
                                                 2764737, 6959553]


def _unet_pair(nff=4, dropout=False):
    args = (1, 2, nff, 'unet_128', 'instance', dropout)
    jf, tf = jnn.define_G(*args), tnn.define_G(*args)
    params = jax_params(jf, 3)
    tf.load_state_dict(from_jax_params(tf, params), strict=True)
    return jf, tf, params


def test_unet128_matches_jax():
    jf, tf, params = _unet_pair()
    assert tnn.count_params(tf) == jnn.count_params(params)
    x = rand((1, 128, 128, 1), 4)
    ref = jf.apply(params, jnp.asarray(x), CTX)
    with torch.no_grad():
        ours = tf(nchw(x))
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


def test_inert_biases_get_no_gradient():
    """The biases the JAX peephole skips (a conv right before a norm) get an
    exact zero gradient there and no gradient (None) here; every other
    parameter gets one on both sides."""
    jf, tf, params = _unet_pair()
    x = rand((1, 128, 128, 1), 5)
    g = rand((1, 128, 128, 2), 6)
    def loss(p):
        return jnp.sum(jf.apply(p, jnp.asarray(x), CTX) * jnp.asarray(g))

    jgrad = jax.jit(jax.grad(loss))(params)
    ref = from_jax_params(tf, jax.device_get(jgrad))
    (tf(nchw(x)) * nchw(g)).sum().backward()
    none = sorted(k for k, p in tf.named_parameters() if p.grad is None)
    zero = sorted(k for k, p in tf.named_parameters()
                  if not ref[k].abs().max() > 0)
    assert none == zero and len(none) == 11   # 5 down + 6 up convs
    assert all(k.endswith('bias') for k in none)


def test_dropout_keeps_p_and_scales():
    d = tnn.Dropout(0.5)
    d.generator = torch.Generator().manual_seed(7)
    x = torch.ones(200, 200)
    y = d(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    d.generator = torch.Generator().manual_seed(7)
    assert torch.equal(d(x), y)
    d.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(d(x), y)


def test_dropout_in_unet_draws_from_the_generator():
    _, tf, _ = _unet_pair(dropout=True)
    x = nchw(rand((1, 128, 128, 1), 7))
    outs = []
    for seed in (1, 1, 2):
        tnn.set_noise_generator(tf, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(tf(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lsgan", [True, False])
def test_gan_loss_matches_jax(real, lsgan):
    p = 1 / (1 + np.exp(-rand((1, 6, 6, 1), 8)))
    ref = jlosses.gan_loss(jnp.asarray(p), real, lsgan)
    ours = tlosses.gan_loss(nchw(p), real, lsgan)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_l1_and_multiclass_losses_match_jax():
    a, b, w = rand((1, 8, 8, 1), 9), rand((1, 8, 8, 1), 10), rand(
        (1, 8, 8, 1), 11) ** 2
    np.testing.assert_allclose(
        float(tlosses.weighted_l1_loss(nchw(a), nchw(b), nchw(w))),
        float(jlosses.weighted_l1_loss(*map(jnp.asarray, (a, b, w)))),
        rtol=1e-5)
    logits = rand((1, 5, 5, 3), 12)
    for label in range(3):
        np.testing.assert_allclose(
            float(tlosses.gan_loss_multiclass(nchw(logits), label)),
            float(jlosses.gan_loss_multiclass(jnp.asarray(logits), label)),
            rtol=1e-5)


def test_bce_gradient_bounded_at_saturation():
    """At p = 0 and p = 1 exactly the gradient is (p - t) / 1e-12, finite,
    as the JAX custom VJP gives; autograd of the clamped logs would not."""
    p = np.array([0.0, 1.0, 0.0, 1.0, 0.3], np.float32).reshape(1, 1, 1, 5)
    t = np.array([1.0, 0.0, 0.0, 1.0, 0.6], np.float32).reshape(1, 1, 1, 5)
    pt = torch.from_numpy(p).requires_grad_(True)
    loss = tlosses.bce_loss(pt, torch.from_numpy(t))
    (gp,) = torch.autograd.grad(loss, pt)
    ref_loss, ref_g = jax.value_and_grad(jlosses.bce_loss)(jnp.asarray(p),
                                                           jnp.asarray(t))
    assert torch.isfinite(gp).all() and np.isfinite(loss.item())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ref_g), rtol=1e-6)
    assert float(gp[0, 0, 0, 0]) == pytest.approx(-1 / 5 / 1e-12, rel=1e-5)


def _jax_draws(key, n):
    """The decisions JAX's pool_query draws for n images (pools.py:46-50)."""
    out = []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        out.append((float(jax.random.uniform(k1)),
                    int(jax.random.randint(k2, (), 0, 6))))
    return out


def test_pool_matches_jax_with_decisions_fed_in():
    jpool = jpools.init_pool(6, (2, 2, 1))
    tpool = tpools.init_pool(6, (1, 2, 2), 'cpu')
    key = jax.random.PRNGKey(7)
    for step in range(8):          # batch 4 x 8 crosses fill -> full
        batch = np.broadcast_to((np.arange(4, dtype=np.float32)
                                 + 10.0 * step).reshape(4, 1, 1, 1),
                                (4, 2, 2, 1))
        k = jax.random.fold_in(key, step)
        ref, jpool = jpools.pool_query(jpool, jnp.asarray(batch), k)
        ours = tpools.pool_query(tpool, nchw(batch), draws=_jax_draws(k, 4))
        np.testing.assert_array_equal(nhwc(ours), np.asarray(ref))
    np.testing.assert_array_equal(nhwc(tpool['images']),
                                  np.asarray(jpool['images']))
    assert tpool['num'] == int(jpool['num'])


def test_pool_semantics_and_generator():
    pool = tpools.init_pool(2, (1, 1, 1), 'cpu')
    gen = torch.Generator().manual_seed(0)
    for v in (1.0, 2.0):            # filling: pass through and store
        assert float(tpools.pool_query(pool, torch.full((1, 1, 1, 1), v),
                                       gen)) == v
    assert pool['num'] == 2
    outs = [float(tpools.pool_query(pool, torch.full((1, 1, 1, 1), 10.0 + i),
                                    gen)) for i in range(200)]
    swaps = sum(o != 10.0 + i for i, o in enumerate(outs))
    assert 60 < swaps < 140
    assert tpools.pool_query(None, torch.ones(1, 1, 1, 1)) is not None


def test_pool_sample_and_fill():
    pool = tpools.pool_fill(tpools.init_pool(8, (1, 1, 1), 'cpu'),
                            torch.arange(8.0).view(8, 1, 1, 1))
    assert pool['num'] == 8
    s = tpools.pool_sample(pool, 16, torch.Generator().manual_seed(1))
    vals = set(s.flatten().tolist())
    assert vals <= set(range(8)) and len(vals) > 2
