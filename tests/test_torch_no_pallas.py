"""The port's --no_pallas route on the CPU: every conv and norm site on its
PyTorch library call (F.conv2d, F.conv_transpose2d, F.instance_norm and
the activation), as the JAX package's --no_pallas sends every site to XLA.

  * the library route's conv2d, conv_transpose2d and instance_norm_act
    against the kernels' plain versions, f32 within 1e-5 and bf16 within
    2e-2, forward and gradients;
  * one DSGAN train step of the port under --no_pallas against the JAX
    package under --no_pallas, as tests/test_torch_train_step.py holds the
    kernels' route (its flags, weights, noise schedule and tolerances),
    with the region's gate (_CONV3_IN_FUSED) off and on, set on both
    packages: under --no_pallas it changes nothing on either side.  G2 is
    ngf 16 here, not 4, so that its 16 -> 16 convs at 64^2 and 128^2 are
    sites the region takes once its pixel minimum is 0 (P = 8 packed
    pixels, as tests/test_torch_conv3x3_in.py's gated G2), with the kernels
    on;
  * one sample of the sampler slice under --no_pallas against the JAX
    package's, within 2e-3 (tests/test_torch_dsgan_sample.py's tolerance;
    see sample_setup for its G2's depth);
  * the step, the sample and the sampler entry point with the five
    autograd Functions patched to raise: no site reaches them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.nn import core as jcore
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.nn import core as tcore
from supervised_gan_tpu_torch.ops import conv as tconv
from supervised_gan_tpu_torch.ops import (conv2d, conv_transpose2d,
                                          instance_norm_act)
from supervised_gan_tpu_torch.ops import kernels as K
from supervised_gan_tpu_torch.ops.kernels import functions
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_dsgan_sample import (G1_ARGS, G1_KW, G2_ARGS, G2_KW,
                                     _jax_sample, _port_sample)
from test_torch_layout import assert_sum_close, jax_params, nchw, rand
from test_torch_test_driver import _args as sampler_args
from test_torch_test_driver import ckpt_dir  # noqa: F401
from test_torch_train_step import (BANKS, FLAGS, LR, NETS, _batch,
                                   _port_modules, _sub)
from test_torch_layout import one_thread  # noqa: F401

FUNCTIONS = ('Conv3x3', 'Conv3x3InAct', 'Conv4s2', 'ConvT4s2',
             'InstanceNormAct')
NP_FLAGS = FLAGS + ['--ngf2', '16', '--no_pallas', '--pool_size', '0',
                    '--no_dropout2']
GATES = [False, True]


def _refuse(mp):
    """Patch every autograd Function over the kernels to raise."""
    for name in FUNCTIONS:
        def refuse(*args, name=name):
            raise AssertionError('--no_pallas reached %s' % name)
        mp.setattr(getattr(functions, name), 'apply', refuse)


@pytest.fixture
def kernels_off():
    K.set_kernels_enabled(False)
    yield
    K.set_kernels_enabled(True)


# ------------------------------------------------ the library route's ops -- #

def _conv_args(ci, co, h, w, k, seed, transposed=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, ci, h, w), generator=g)
    wshape = (ci, co, k, k) if transposed else (co, ci, k, k)
    return x, torch.randn(wshape, generator=g) * 0.2, torch.randn(
        (co,), generator=g)


def _in_args():
    g = torch.Generator().manual_seed(5)
    return (torch.randn((2, 3, 9, 7), generator=g) * 2 + 0.5,)


# case: (the op on the library route, the kernel's plain version, inputs)
CASES = {
    'conv3x3': (lambda x, w, b: conv2d(x, w, b, 1, 1), K.conv3x3_plain,
                lambda: _conv_args(5, 6, 9, 7, 3, 1)),
    'conv4s2': (lambda x, w, b: conv2d(x, w, b, 2, 1), K.conv4s2_plain,
                lambda: _conv_args(5, 6, 8, 10, 4, 2)),
    'convt4s2': (lambda x, w, b: conv_transpose2d(x, w, b), K.convt4s2_plain,
                 lambda: _conv_args(5, 6, 6, 7, 4, 3, transposed=True)),
}
for _name, _slope in (('in', None), ('in_relu', 0.0), ('in_leaky', 0.2)):
    CASES[_name] = (
        lambda x, s=_slope: instance_norm_act(x, 1e-5, s),
        lambda x, s=_slope: K.instance_norm_act_plain(x, 1e-5, s), _in_args)


def _forward_and_grads(fn, args, dtype, g):
    leaves = [a.to(dtype).requires_grad_(True) for a in args]
    y = fn(*leaves)
    (y.float() * g).sum().backward()
    return y, [a.grad for a in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize("case", sorted(CASES))
def test_library_route_matches_plain(kernels_off, monkeypatch, case, dtype):
    """Forward and gradients, f32 within 1e-5 and bf16 within 2e-2 (one
    bf16 ulp of values up to ~2): gradients of the largest entry, since
    dW and db sum every pixel."""
    lib, plain, make = CASES[case]
    args = make()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _refuse(monkeypatch)
    g = torch.randn(lib(*args).shape,
                    generator=torch.Generator().manual_seed(9))
    y, grads = _forward_and_grads(lib, args, dtype, g)
    y_ref, grads_ref = _forward_and_grads(plain, args, dtype, g)
    assert y.dtype == dtype and y.shape == y_ref.shape
    np.testing.assert_allclose(y.float().detach(), y_ref.float().detach(),
                               rtol=tol, atol=tol)
    for a, r in zip(grads, grads_ref):
        assert a.dtype == dtype
        assert_sum_close(a.float(), r.float(), rtol=tol, atol=tol)


def test_library_route_keeps_the_weight_gradient_f32(kernels_off):
    """Compute in x's dtype, the weight cast on the way in: its gradient
    lands in the parameter's float32."""
    x, w, b = _conv_args(5, 6, 8, 8, 3, 1)
    w = w.requires_grad_(True)
    b = b.requires_grad_(True)
    y = conv2d(x.to(torch.bfloat16), w, b, 1, 1)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32 and b.grad.dtype == torch.float32


def test_switch_routes_the_ops(kernels_off, monkeypatch):
    """Off: no Function reached; on: the Functions again."""
    _refuse(monkeypatch)
    x, w, b = _conv_args(5, 6, 8, 8, 3, 1)
    conv2d(x, w, b, 1, 1)
    instance_norm_act(x, 1e-5, 0.2)
    K.set_kernels_enabled(True)
    with pytest.raises(AssertionError, match='Conv3x3'):
        conv2d(x, w, b, 1, 1)
    with pytest.raises(AssertionError, match='InstanceNormAct'):
        instance_norm_act(x, 1e-5, 0.2)


# ------------------------------------------------------- the train step -- #

def _numpy_init(layer, key):
    """Stands in for the JAX package's jit_init: the test replaces the
    values, and the JAX init runs eagerly on the CPU, an XLA compile per op
    and shape."""
    return jax_params(layer, 0)


def _port_step(flags, params, noises, gate):
    """One port step under --no_pallas with the region's gate as given and
    the Functions patched to raise."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tcore, '_CONV3_IN_FUSED', gate)
        mp.setattr(tconv, 'CONV3_MIN_PIXELS', 0)
        tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
        assert not K.kernels_enabled()
        for kind, index, mod in _port_modules(tm):
            mod.load_state_dict(from_jax_params(mod, _sub(params, kind,
                                                          index)),
                                strict=True)
        tm.set_input(_batch())
        tm.draw_noises = lambda: dict(noises)
        _refuse(mp)
        tm.optimize_parameters()
        return tm
    finally:
        mp.undo()
        K.set_kernels_enabled(True)


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    """The JAX step under --no_pallas, compiled once with the region's gate
    off; with the gate on, its lowered program, which must be the same
    text; the port's step with the gate off and on."""
    flags = NP_FLAGS + ['--checkpoints_dir', str(tmp_path_factory.mktemp(
        'no_pallas'))]
    mp = pytest.MonkeyPatch()
    old_pallas = jcore.PALLAS_ENABLED
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        assert not jcore.PALLAS_ENABLED
        params = {n: jax_params(getattr(jm, 'net' + n), 20 + i)
                  for i, n in enumerate(NETS)}
        for j, b in enumerate(BANKS):
            params[b] = {str(i): jax_params(d, 30 + 10 * j + i)
                         for i, d in enumerate(getattr(jm, 'net' + b))}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        jm.set_input(_batch())
        key = jm.next_step_key()
        shapes = jm._noise_shapes()
        noises = {name: nchw(jax.random.normal(jax.random.fold_in(key, i),
                                               shapes[name]))
                  for i, name in enumerate(('noise1', 'noise2'))}

        captured = []
        orig = jbase.FlatAdam.apply_updates

        def capture(self, grads, state, p, leaves_lr):
            captured.append(grads)
            return orig(self, grads, state, p, leaves_lr)

        mp.setattr(jbase.FlatAdam, 'apply_updates', capture)

        def lowered(gate):
            # a fresh function, so the gate is read while tracing
            def step_with_grads(state, inputs, k, lrs):
                captured.clear()
                new, metrics, _ = jm._raw_step_fn(state, inputs, k, lrs)
                return new, metrics, list(captured)

            mp.setattr(jcore, '_CONV3_IN_FUSED', gate)
            return jax.jit(step_with_grads).lower(
                jm.state, jm._step_inputs(), key, jm.lrs())

        program = lowered(False)
        new, metrics, (g_d1, g_d2, g_g) = program.compile()(
            jm.state, jm._step_inputs(), key, jm.lrs())
        same_program = lowered(True).as_text() == program.as_text()
    finally:
        mp.undo()
        jcore.set_pallas_enabled(old_pallas)
    return dict(port={gate: _port_step(flags, params, noises, gate)
                      for gate in GATES},
                metrics=jax.device_get(metrics),
                grads=jax.device_get(dict(g_g, D1=g_d1, D2=g_d2)),
                params=jax.device_get(new['params']),
                same_program=same_program)


@pytest.mark.parametrize("gate", GATES, ids=['gate_off', 'gate_on'])
def test_metrics_match_jax(steps, gate):
    ours = steps['port'][gate].get_current_errors()
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(steps['metrics'][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("gate", GATES, ids=['gate_off', 'gate_on'])
@pytest.mark.parametrize("kind", NETS + BANKS)
def test_gradients_match_jax(steps, kind, gate):
    """1e-4 of the tensor's largest entry plus 1e-7; an inert bias has no
    gradient here and exactly 0 there, and no bias takes part in a
    region."""
    n_none = 0
    for k_, index, mod in _port_modules(steps['port'][gate]):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(steps['grads'], kind, index))
        for name, p in mod.named_parameters():
            r = ref[name]
            if p.grad is None:
                assert name.endswith('bias') and not r.abs().max() > 0, name
                n_none += 1
                continue
            err = float((p.grad - r).abs().max())
            assert err <= 1e-7 + 1e-4 * float(r.abs().max()), (name, err)
    assert n_none > 0 or kind in BANKS


@pytest.mark.parametrize("gate", GATES, ids=['gate_off', 'gate_on'])
@pytest.mark.parametrize("kind", NETS + BANKS)
def test_params_after_adam_match_jax(steps, kind, gate):
    """1e-6, plus 2 lr where |g| is under the gradient tolerance (Adam's
    first step turns a rounding-sized gradient into +-lr)."""
    for k_, index, mod in _port_modules(steps['port'][gate]):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(steps['params'], kind, index))
        g = from_jax_params(mod, _sub(steps['grads'], kind, index))
        for name, p in mod.named_parameters():
            gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
            allow = 1e-6 + 2 * LR * (g[name].abs() < gtol).float()
            assert torch.all((p.detach() - ref[name]).abs() <= allow), name


def test_gate_changes_nothing_under_no_pallas(steps):
    """The JAX step lowers to the same program with the gate on; the port's
    step gives the same metrics, gradients (None where None) and
    parameters, bit for bit."""
    assert steps['same_program']
    off, on = steps['port'][False], steps['port'][True]
    assert off.get_current_errors() == on.get_current_errors()
    for (_, _, a), (_, _, b) in zip(_port_modules(off), _port_modules(on)):
        for (name, pa), (_, pb) in zip(a.named_parameters(),
                                       b.named_parameters()):
            assert (pa.grad is None) == (pb.grad is None), name
            assert pa.grad is None or torch.equal(pa.grad, pb.grad), name
            assert torch.equal(pa, pb), name


def test_gate_has_sites_with_the_kernels_on(steps, monkeypatch):
    """Control: with the kernels on, the same G2 at the step's label runs
    the region where the gate is on, so the gate had sites to take."""
    tm = steps['port'][True]
    calls = []
    orig = functions.conv3x3_in_stats
    monkeypatch.setattr(functions, 'conv3x3_in_stats',
                        lambda *a: calls.append(tuple(a[0].shape))
                        or orig(*a))
    monkeypatch.setattr(tcore, '_CONV3_IN_FUSED', True)
    monkeypatch.setattr(tconv, 'CONV3_MIN_PIXELS', 0)
    with torch.no_grad():
        tm.netG2(tm.input_A, tm.draw_noises()['noise2'])
    assert sorted(calls) == [(1, 16, 64, 64), (1, 16, 64, 64),
                             (1, 16, 128, 128)]


# ------------------------------------------------------------- sampling -- #

@pytest.fixture(scope='module')
def sample_setup():
    """The slice of tests/test_torch_dsgan_sample.py at twice its size (G1
    4 layers, 64^2; G2 at 128^2), so that G2's coarsest block and noise are
    2^2.  At 64^2 G2's coarsest level is 1^2, upsampled: its InstanceNorm
    planes are constant, and aten's CPU instance norm (a folded x * rstd -
    mean * rstd) leaves ~3e-6 on them, not 0, which the following norms
    scale to ~8e-3 at the output.  That is the trap the JAX side's FMA fold
    sets in that test, which turns the fold off; aten's has no switch."""
    g1_kw = dict(G1_KW, n_layers_G=4)
    jg1, jg2 = jnn.define_G(*G1_ARGS, **g1_kw), jnn.define_G(*G2_ARGS, **G2_KW)
    p1, p2 = jax_params(jg1, 10), jax_params(jg2, 11)
    tg1, tg2 = tnn.define_G(*G1_ARGS, **g1_kw), tnn.define_G(*G2_ARGS, **G2_KW)
    tg1.load_state_dict(from_jax_params(tg1, p1), strict=True)
    tg2.load_state_dict(from_jax_params(tg2, p2), strict=True)
    return (jg1, jg2, p1, p2, tg1, tg2, rand((1, 2, 2, 4), 12),
            rand((1, 2, 2, 4), 13))


def test_sample_matches_jax(sample_setup, kernels_off, monkeypatch):
    monkeypatch.setattr(jcore, 'PALLAS_ENABLED', False)
    ref = _jax_sample(sample_setup)
    _refuse(monkeypatch)
    ours, _ = _port_sample(sample_setup)
    assert ref[2].shape == (1, 128, 128, 1)
    for name, o, r in zip(('G1', 'transform', 'G2'), ours, ref):
        np.testing.assert_allclose(o, r, rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("no_pallas", [True, False],
                         ids=['no_pallas', 'kernels'])
def test_sampler_entry_point_routes(ckpt_dir,  # noqa: F811
                                    tmp_path, monkeypatch, no_pallas):
    """python -m supervised_gan_tpu_torch.test --no_pallas reaches no
    Function; without the flag the first one raises."""
    _refuse(monkeypatch)
    args = (['--gpu_ids', '-1', '--how_many', '1']
            + sampler_args(ckpt_dir, str(tmp_path))
            + (['--no_pallas'] if no_pallas else []))
    try:
        if no_pallas:
            assert ttest.main(args)['nonfinite'] == 0
            assert not K.kernels_enabled()
        else:
            with pytest.raises(AssertionError, match='reached'):
                ttest.main(args)
    finally:
        K.set_kernels_enabled(True)
