"""The fused conv3x3 + InstanceNorm (+ activation) region on the CPU: the
port's plain versions (conv3x3_in_stats_plain, instance_norm_apply_plain and
the Conv3x3InAct Function over them) against the JAX package's
`conv3x3_in_act` with its Pallas kernel in interpret mode; the port's gate
(`ops.conv3x3_in_supported`) against the JAX `supported`; the Sequential
peephole with the gate on and off; and the whole CRN with the gate on, on
both sides, forward and every parameter gradient.

Tolerances: 2e-4 forward and 2e-3 for dx, dW and db, as the JAX package's
own region tests (tests/test_pallas_conv.py:222 and :238); the statistics
1e-5 relative (one f32 fold of the same sums in another order).  The JAX
InstanceNorm runs its f32 subtract form (`_FMA` off, as
tests/test_torch_dsgan_sample.py does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.nn import core as jcore
from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu.ops.pallas import conv3x3_in as p3in
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.nn import core as tcore
from supervised_gan_tpu_torch.ops import conv as tconv
from supervised_gan_tpu_torch.ops.kernels import (Conv3x3InAct,
                                                  conv3x3_in_stats_plain,
                                                  functions,
                                                  instance_norm_apply_plain)
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import (assert_sum_close, conv_w, jax_params, nchw,
                               nhwc, rand, vec)
from test_torch_layout import one_thread  # noqa: F401

# one shape per packing factor P = 128 / C (8, 4, 2, 1), each admitted by
# the JAX gate in interpret mode
SHAPES = [(16, 16, 64), (32, 16, 32), (64, 16, 16), (128, 16, 8)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    p3._set_interpret(True)
    yield
    p3._set_interpret(False)


def _inputs(c, h, w, seed):
    return (rand((1, h, w, c), seed), rand((3, 3, c, c), seed + 1, 0.1),
            rand((c,), seed + 2, 0.1))


@pytest.mark.parametrize("slope", [None, 0.0, 0.2])
@pytest.mark.parametrize("c,h,w", SHAPES)
def test_region_forward_matches_jax(interpret, c, h, w, slope):
    x, wt, b = _inputs(c, h, w, 11)
    ref = p3in.conv3x3_in_act(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                              1e-5, slope)
    y, mean, rstd = conv3x3_in_stats_plain(nchw(x), conv_w(wt), vec(b))
    ours = instance_norm_apply_plain(y, mean, rstd, slope)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("c,h,w", SHAPES)
def test_stats_match_the_jax_kernel_fold(interpret, c, h, w):
    """y, mean and rstd against `_fwd_impl`, which folds the Pallas kernel's
    per-lane (sum, sum of squares) output (conv3x3_in.py:157-162 there)."""
    x, wt, b = _inputs(c, h, w, 21)
    yj, mj, rj = p3in._fwd_impl(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(b), 1e-5)
    y, mean, rstd = conv3x3_in_stats_plain(nchw(x), conv_w(wt), vec(b))
    np.testing.assert_allclose(nhwc(y), np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mean[0].numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd[0].numpy(), np.asarray(rj), rtol=1e-5)


@pytest.mark.parametrize("slope", [None, 0.2])
def test_region_vjp_matches_jax(interpret, slope):
    """dx, dW and db of Conv3x3InAct against jax.vjp of conv3x3_in_act."""
    x, wt, b = _inputs(64, 16, 32, 12)
    g = rand((1, 16, 32, 64), 15)
    _, vjp = jax.vjp(lambda x_, w_, b_: p3in.conv3x3_in_act(
        x_, w_, b_, 1e-5, slope), jnp.asarray(x), jnp.asarray(wt),
        jnp.asarray(b))
    gx, gw, gb = vjp(jnp.asarray(g))
    ts = [nchw(x).requires_grad_(True), conv_w(wt).requires_grad_(True),
          vec(b).requires_grad_(True)]
    y = Conv3x3InAct.apply(*ts, 1e-5, slope)
    dx, dw, db = torch.autograd.grad(y, ts, nchw(g))
    np.testing.assert_allclose(nhwc(dx), np.asarray(gx), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(dw.numpy(), conv_w(gw).numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), rtol=2e-3,
                               atol=2e-3)


# (N, H, W, C_in, C_out): admitted and refused shapes of the gate
GATE_SHAPES = [
    (1, 16, 64, 16, 16), (1, 16, 32, 32, 32), (1, 16, 16, 64, 64),
    (1, 16, 8, 128, 128), (1, 16, 8, 256, 256), (1, 32, 256, 4, 4),
    (1, 32, 128, 4, 4),       # P = 32: W / P = 4 is not a multiple of 8
    (1, 16, 64, 16, 32),      # C_in != C_out
    (2, 16, 16, 64, 64),      # batch 2
    (1, 8, 64, 16, 16),       # H < 16
    (1, 20, 16, 64, 64),      # H not a multiple of 8
    (1, 16, 16, 48, 48),      # C neither a divisor nor a multiple of 128
    (1, 16, 24, 64, 64),      # W / P = 12
    (1, 16, 20, 32, 32),      # W not divisible by P = 4
]


@pytest.mark.parametrize("shape", GATE_SHAPES, ids=str)
def test_gate_matches_jax_supported(interpret, monkeypatch, shape):
    n, h, w, ci, co = shape
    monkeypatch.setattr(tconv, 'CONV3_MIN_PIXELS', 0)
    theirs = p3.supported(jnp.zeros((n, h, w, ci)), jnp.zeros((3, 3, ci, co)),
                          1, 1)
    ours = tconv.conv3x3_in_supported(torch.zeros(n, ci, h, w),
                                      torch.zeros(co, ci, 3, 3))
    assert ours == theirs


def test_gate_keeps_the_pixel_minimum():
    """Default 512^2, as the JAX gate outside interpret mode."""
    assert tconv.CONV3_MIN_PIXELS == 512 * 512
    w = torch.zeros(64, 64, 3, 3)
    assert not tconv.conv3x3_in_supported(torch.zeros(1, 64, 256, 256), w)
    assert tconv.conv3x3_in_supported(torch.zeros(1, 64, 512, 512), w)


@pytest.fixture
def region_calls(monkeypatch):
    """Counts the region's forward calls (the Function's statistics call)."""
    calls = []
    orig = functions.conv3x3_in_stats

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return orig(*args)

    monkeypatch.setattr(functions, 'conv3x3_in_stats', counted)
    return calls


def _jax_seq_apply(seq, params, x, fused):
    old = (jcore.PALLAS_ENABLED, jcore._CONV3_IN_FUSED)
    jcore.set_pallas_enabled(True)
    jcore._CONV3_IN_FUSED = fused
    try:
        return np.asarray(seq.apply(params, jnp.asarray(x),
                                    jcore.Ctx(train=False)))
    finally:
        jcore.set_pallas_enabled(old[0])
        jcore._CONV3_IN_FUSED = old[1]


def _seqs(act):
    jseq = jcore.Sequential(jcore.Conv2d(64, 64, 3, 1, 1),
                            jcore.InstanceNorm2d(64), act[0])
    tseq = tcore.Sequential(tcore.Conv2d(64, 64, 3, 1, 1),
                            tcore.InstanceNorm2d(64), act[1])
    params = jax_params(jseq, 3)
    tseq.load_state_dict(from_jax_params(tseq, params), strict=True)
    return jseq, tseq, params


@pytest.mark.parametrize("act", ['relu', 'leaky'])
def test_sequential_gate_on_matches_jax(interpret, monkeypatch, region_calls,
                                        act):
    """[Conv2d 3x3, InstanceNorm2d, (Leaky)ReLU] with the gate on: one
    region call on the port's side, the JAX region's output, and a bias
    gradient (the JAX region takes the bias)."""
    acts = {'relu': (jcore.ReLU(), tcore.ReLU()),
            'leaky': (jcore.LeakyReLU(0.2), tcore.LeakyReLU(0.2))}[act]
    jseq, tseq, params = _seqs(acts)
    monkeypatch.setattr(tcore, '_CONV3_IN_FUSED', True)
    monkeypatch.setattr(tconv, 'CONV3_MIN_PIXELS', 0)
    x = rand((1, 16, 32, 64), 4)
    ref = _jax_seq_apply(jseq, params, x, fused=True)
    xt = nchw(x).requires_grad_(True)
    y = tseq(xt)
    assert region_calls == [(1, 64, 16, 32)]
    np.testing.assert_allclose(nhwc(y), ref, rtol=2e-4, atol=2e-4)
    y.sum().backward()
    assert tseq[0].bias.grad is not None


def test_sequential_gate_off_unchanged(interpret, monkeypatch, region_calls):
    """Gate off (the default): no region call, the split conv + IN path
    (JAX unfused, 1e-4), and the inert bias gets no gradient."""
    jseq, tseq, params = _seqs((jcore.ReLU(), tcore.ReLU()))
    assert not tcore._CONV3_IN_FUSED
    monkeypatch.setattr(tconv, 'CONV3_MIN_PIXELS', 0)
    x = rand((1, 16, 32, 64), 5)
    ref = _jax_seq_apply(jseq, params, x, fused=False)
    y = tseq(nchw(x))
    assert region_calls == []
    np.testing.assert_allclose(nhwc(y), ref, rtol=1e-4, atol=1e-4)
    y.sum().backward()
    assert tseq[0].bias.grad is None and tseq[0].weight.grad is not None


# G2 of the DSGAN at 128 px with ngf 16: the region runs at the 64^2 and
# 128^2 inter-block convs (P = 8 needs W / 8 a multiple of 8)
G2_ARGS = (2, 1, 16, 'crn', 'instance', False)
G2_KW = dict(n_layers_G=5, noise_nc=4, upsample_mode='bilinear',
             n_layers_CRN_block=2)
FUSED_BIASES = {'blockh1.1.model.1.bias', 'blockh1.1.model.4.bias',
                'blockh0.1.model.1.bias'}


@pytest.fixture(scope='module')
def gated_g2():
    jg2 = jnn.define_G(*G2_ARGS, **G2_KW)
    params = jax_params(jg2, 31)
    label = np.tanh(rand((1, 128, 128, 2), 32, 2.0))
    noise = rand((1, 2, 2, 4), 33)
    g = rand((1, 128, 128, 1), 34)
    mp = pytest.MonkeyPatch()
    old = (jcore.PALLAS_ENABLED, jcore._CONV3_IN_FUSED)
    try:
        mp.setattr(sin, '_FMA', False)
        p3._set_interpret(True)
        jcore.set_pallas_enabled(True)
        jcore._CONV3_IN_FUSED = True

        def loss(p):
            y = jg2.apply(p, jnp.asarray(label), jnp.asarray(noise),
                          jnn.Ctx(jax.random.PRNGKey(0)))
            return jnp.sum(y * jnp.asarray(g)), y

        (_, y_ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))

        tg2 = tnn.define_G(*G2_ARGS, **G2_KW)
        tg2.load_state_dict(from_jax_params(tg2, params), strict=True)
        mp.setattr(tcore, '_CONV3_IN_FUSED', True)
        mp.setattr(tconv, 'CONV3_MIN_PIXELS', 0)
        calls = []
        orig = functions.conv3x3_in_stats
        mp.setattr(functions, 'conv3x3_in_stats',
                   lambda *a: calls.append(tuple(a[0].shape)) or orig(*a))
        y = tg2(nchw(label), nchw(noise))
        y.backward(nchw(g))
    finally:
        mp.undo()
        p3._set_interpret(False)
        jcore.set_pallas_enabled(old[0])
        jcore._CONV3_IN_FUSED = old[1]
    return dict(port=tg2, y=y, y_ref=np.asarray(y_ref), calls=calls,
                grads=from_jax_params(tg2, jax.device_get(grads)))


def test_gated_g2_fuses_the_jax_sites(gated_g2):
    assert sorted(gated_g2['calls']) == [(1, 16, 64, 64), (1, 16, 64, 64),
                                         (1, 16, 128, 128)]


def test_gated_g2_forward_matches_jax(gated_g2):
    """2e-3, as the whole-sample test (tests/test_torch_dsgan_sample.py):
    InstanceNorm after a chain of convs magnifies reordered sums."""
    np.testing.assert_allclose(nhwc(gated_g2['y']), gated_g2['y_ref'],
                               rtol=2e-3, atol=2e-3)


def test_gated_g2_gradients_match_jax(gated_g2):
    """Every parameter's gradient, within 2e-3 of its largest entry (the
    region's dx, dW, db tolerance).  The biases the region takes get a
    gradient on both sides, rounding noise not compared in value; every
    other bias before a norm is inert: None here, exactly 0 there."""
    for name, p in gated_g2['port'].named_parameters():
        ref = gated_g2['grads'][name]
        if name in FUSED_BIASES:
            assert p.grad is not None and float(ref.abs().max()) > 0, name
        elif p.grad is None:
            assert name.endswith('bias') and not ref.abs().max() > 0, name
        else:
            assert_sum_close(p.grad, ref, rtol=2e-3, atol=1e-7)
