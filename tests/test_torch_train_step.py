"""One whole DSGAN train step of the port (plain versions of its kernels)
against the JAX package's, on the CPU in f32, at 128 px (unet_128's seven
downs need it) with narrow widths, --pool_size 0 and --no_dropout2.

Both sides start from one parameter set (numpy-made, carried into the port
by from_jax_params), see the same batch, and draw the same noise: the port's
draw is replaced by JAX's key schedule (models/common.py:327-341 there,
fold_in(step key, 0) and (.., 1)).  The JAX step runs jitted with its Adam
calls wrapped to hand back the gradients they receive.  Compared: the six
metrics (1e-5), every parameter's gradient before Adam (1e-4 of the
tensor's largest entry, plus 1e-7: f32 sums in another order through up to
~40 layers; the inert biases get None here and exactly 0 there), and every
parameter after Adam (1e-6, plus 2*lr where |g| is below the gradient
tolerance: at step 1 Adam turns a gradient of rounding size into +-lr).

The weights are the numpy fill of test_torch_layout.jax_params, not the
reference's N(0, 0.02) init: at these narrow widths that init gives G1 a
nearly flat label, on which G2's f32 forward (either package's) is off a
float64 oracle by ~1e-5 and ReLU masks flip, so gradients would differ by
a few per cent for conditioning, not for semantics.

Also: a save -> --continue_train -> step round trip equals two straight
steps exactly (pools and dropout on), and the .pth files the port writes
load into the JAX package's utils/pth.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw
from test_torch_layout import one_thread  # noqa: F401

FLAGS = ['--dataroot', './datasets/unused', '--name', 'step',
         '--model', 'twostage_cycle', '--which_direction', 'AtoB',
         '--dataset_mode', 'single', '--loadSize', '128', '--fineSize', '128',
         '--transform_1to2', 'bilinear_2', '--batchSize', '1',
         '--which_channel', 'rg_b',
         '--which_model_netG1', 'fcgan', '--n_layers_G1', '4', '--ngf1', '4',
         '--which_model_netD1', 'n_layers', '--n_layers_D1', '2', '2',
         '--ndf1', '4', '--scale_factor1', '1', '2',
         '--lambda_D1', '0.5', '0.4',
         '--which_model_netG2', 'crn', '--ngf2', '4',
         '--upsample_mode2', 'bilinear', '--n_layers_CRN_block2', '2',
         '--which_model_netF2', 'unet_128', '--nff2', '4',
         '--which_model_netD2', 'n_layers', '--n_layers_D2', '2', '3',
         '--ndf2', '4', '--scale_factor2', '1', '2',
         '--lambda_D2', '0.3', '0.2', '--lambda_A', '10', '--lambda_B', '10',
         '--lambda_A_cycle', '5', '--noise_nc1', '4', '--noiseSize1', '2',
         '--noise_nc2', '4', '--noiseSize2', '2', '--norm', 'instance',
         '--no_dropout1', '--no_lsgan1', '--no_lsgan2', '--manualSeed', '0',
         '--display_id', '0', '--lr1', '0.0002', '--lr2', '0.0002']
LR = 2e-4
NETS = ('G1', 'G2', 'F2')
BANKS = ('D1', 'D2')


def _batch(seed=0):
    return {'A': np.random.RandomState(seed).uniform(
        -1, 1, (1, 128, 128, 3)).astype(np.float32), 'A_paths': ['x.png']}


def _port_modules(model):
    """[(kind, index, port module)] for every network of the model."""
    out = [(n, None, getattr(model, 'net' + n)) for n in NETS]
    for b in BANKS:
        out += [(b, str(i), d) for i, d in enumerate(getattr(model,
                                                             'net' + b))]
    return out


def _sub(tree, kind, index):
    return tree[kind] if index is None else tree[kind][index]


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp('step'))
    flags = FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '0',
                     '--no_dropout2']
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        jm = jcreate(JTrainOptions().parse(flags))
        params = {n: jax_params(getattr(jm, 'net' + n), 20 + i)
                  for i, n in enumerate(NETS)}
        for j, b in enumerate(BANKS):
            params[b] = {str(i): jax_params(d, 30 + 10 * j + i)
                         for i, d in enumerate(getattr(jm, 'net' + b))}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))

        tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
        for kind, index, mod in _port_modules(tm):
            mod.load_state_dict(from_jax_params(mod, _sub(params, kind,
                                                          index)),
                                strict=True)
        jm.set_input(_batch())
        tm.set_input(_batch())
        key = jm.next_step_key()
        shapes = jm._noise_shapes()
        n1 = jax.random.normal(jax.random.fold_in(key, 0), shapes['noise1'])
        n2 = jax.random.normal(jax.random.fold_in(key, 1), shapes['noise2'])
        tm.draw_noises = lambda: {'noise1': nchw(n1), 'noise2': nchw(n2)}

        captured = []
        orig = jbase.FlatAdam.apply_updates

        def capture(self, grads, state, p, leaves_lr):
            captured.append(grads)
            return orig(self, grads, state, p, leaves_lr)

        mp.setattr(jbase.FlatAdam, 'apply_updates', capture)

        def step_with_grads(state, inputs, k, lrs):
            captured.clear()
            new, metrics, _ = jm._raw_step_fn(state, inputs, k, lrs)
            return new, metrics, list(captured)

        new, metrics, (g_d1, g_d2, g_g) = jax.jit(step_with_grads)(
            jm.state, jm._step_inputs(), key, jm.lrs())
        tm.optimize_parameters()
        grads = dict(g_g, D1=g_d1, D2=g_d2)
        return dict(port=tm, metrics=jax.device_get(metrics),
                    grads=jax.device_get(grads),
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


def test_metrics_match_jax(steps):
    ours = steps['port'].get_current_errors()
    assert list(ours) == ['G2_GAN', 'G2_real_cycle', 'G2_fake_cycle', 'D2',
                          'G1_GAN', 'D1']
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(steps['metrics'][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", NETS + BANKS)
def test_gradients_match_jax(steps, kind):
    n_none = 0
    for k_, index, mod in _port_modules(steps['port']):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(steps['grads'], kind, index))
        for name, p in mod.named_parameters():
            r = ref[name]
            if p.grad is None:          # an inert bias: exactly 0 there
                assert name.endswith('bias') and not r.abs().max() > 0, name
                n_none += 1
                continue
            err = float((p.grad - r).abs().max())
            assert err <= 1e-7 + 1e-4 * float(r.abs().max()), (name, err)
    assert n_none > 0 or kind == 'D1' or kind == 'D2'


@pytest.mark.parametrize("kind", NETS + BANKS)
def test_params_after_adam_match_jax(steps, kind):
    for k_, index, mod in _port_modules(steps['port']):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(steps['params'], kind, index))
        g = from_jax_params(mod, _sub(steps['grads'], kind, index))
        for name, p in mod.named_parameters():
            gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
            allow = 1e-6 + 2 * LR * (g[name].abs() < gtol).float()
            assert torch.all((p.detach() - ref[name]).abs() <= allow), name


def _flags_rt(ckpt, *extra):
    return (FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '2',
                     '--gpu_ids', '-1'] + list(extra))


def test_continue_train_equals_straight_steps(tmp_path):
    straight = tcreate(TTrainOptions().parse(_flags_rt(str(tmp_path / 'a'))))
    for s in (0, 1):
        straight.set_input(_batch(s))
        straight.optimize_parameters()

    first = tcreate(TTrainOptions().parse(_flags_rt(str(tmp_path / 'b'))))
    first.set_input(_batch(0))
    first.optimize_parameters()
    first.save('latest')
    resumed = tcreate(TTrainOptions().parse(
        _flags_rt(str(tmp_path / 'b'), '--continue_train')))
    resumed.set_input(_batch(1))
    resumed.optimize_parameters()

    assert resumed.get_current_errors() == straight.get_current_errors()
    for (_, _, a), (_, _, b) in zip(_port_modules(straight),
                                    _port_modules(resumed)):
        for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                      b.named_parameters()):
            assert na == nb and torch.equal(pa, pb), na
    assert straight.pools['pool2']['num'] == resumed.pools['pool2']['num'] == 2


def test_port_pth_loads_in_jax(tmp_path):
    tm = tcreate(TTrainOptions().parse(_flags_rt(str(tmp_path))))
    tm.save('latest')
    jm_nets = {
        'G1': jnn.define_G(2, 0, 4, 'fcgan', 'instance', False, n_layers_G=4,
                           use_fcn=True, noise_nc=4),
        'G2': jnn.define_G(2, 1, 4, 'crn', 'instance', False, noise_nc=4,
                           upsample_mode='bilinear', n_layers_CRN_block=2),
        'F2': jnn.define_G(1, 2, 4, 'unet_128', 'instance', True),
        'D2_1': jnn.define_D(3, 4, 'n_layers', 3, 'instance', True, 2)}
    for label, jnet in jm_nets.items():
        path = os.path.join(str(tmp_path), 'step',
                            'latest_net_%s.pth' % label)
        params = jpth.load_pth(path, jnet)
        mod = (tm.netD2[1] if label == 'D2_1'
               else getattr(tm, 'net' + label))
        ref = from_jax_params(mod, params)
        for name, p in mod.named_parameters():
            assert torch.equal(p.detach(), ref[name]), (label, name)
