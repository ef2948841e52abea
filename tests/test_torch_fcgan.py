"""The stage-1 label GAN, `--model fcgan`, of the port on the CPU against the
JAX package's, at a small config (G deconv ngf 8 x 3 layers from 4 x 2^2
noise -> 32^2, a 2-scale D bank ndf 8, BCE losses, rg_b).

One f32 train step, as tests/test_torch_train_step.py does for the DSGAN:
both sides start from one numpy-made parameter set (from_jax_params), see
the same batch, and the port draws JAX's noises (fold_in(step key, 0), 3
and 5: the first fake, and the redraws after each of the --n_update_G 2 G
updates).  --pool_size 0 and --no_dropout.  Compared: the three metrics
(1e-5), the D gradient of the D update and the G gradient of the last G
update (1e-4 of the tensor's largest entry, plus 1e-7), and every parameter
after the step (1e-6, plus 2 lr per Adam step where |g| is below the
gradient tolerance: Adam turns a rounding-sized gradient into +-lr).

Also: one sample against the JAX sampler (1e-4, as the fcgan forward of
tests/test_torch_weights.py), a save -> --continue_train round trip equal to
two straight steps, the train and test entry points with --gpu_ids -1, and
interpolate between two kept noises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.options import TestOptions as JTestOptions
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch import train as ttrain
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TestOptions as TTestOptions
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc
from test_torch_layout import one_thread  # noqa: F401

ARCH = ['--model', 'fcgan', '--which_direction', 'A',
        '--dataset_mode', 'single', '--loadSize', '32', '--fineSize', '32',
        '--batchSize', '1', '--which_model_netG', 'deconv',
        '--n_layers_G', '3', '--ngf', '8', '--noise_nc', '4',
        '--noiseSize', '2', '--norm', 'instance', '--which_channel', 'rg_b',
        '--manualSeed', '0', '--display_id', '0']
TRAIN = ['--which_model_netD', 'n_layers', '--n_layers_D', '2', '2',
         '--ndf', '8', '--scale_factor', '1', '2', '--lambda_D', '0.5', '0.4',
         '--n_update_G', '2', '--no_lsgan']
FLAGS = ['--dataroot', './datasets/unused', '--name', 'fc'] + ARCH + TRAIN
LR = 2e-4


def _batch(seed=0):
    return {'A': np.random.RandomState(seed).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32), 'A_paths': ['x.png']}


def _port_modules(model):
    """[(kind, index, port module)]: G and each D of the bank."""
    return [('G', None, model.netG)] + [
        ('D', str(i), d) for i, d in enumerate(model.netD)]


def _sub(tree, kind, index):
    return tree[kind] if index is None else tree[kind][index]


def _numpy_init(layer, key):
    """Stands in for the JAX package's jit_init where the test replaces the
    values: its own init runs eagerly on the CPU, an XLA compile per op and
    shape (~15 s for this file's nets)."""
    return jax_params(layer, 0)


@pytest.fixture(scope='module')
def step(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp('fcgan_step'))
    flags = FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '0',
                     '--no_dropout']
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        params = {'G': jax_params(jm.netG, 40),
                  'D': {str(i): jax_params(d, 41 + i)
                        for i, d in enumerate(jm.netD)}}
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
        shape = jm._noise_shape()
        noises = iter([nchw(jax.random.normal(jax.random.fold_in(key, i),
                                              shape)) for i in (0, 3, 5)])
        tm.draw_noise = lambda: next(noises)

        captured = []
        orig = jbase.FlatAdam.apply_updates

        def capture(self, grads, state, p, leaves_lr):
            captured.append(grads)
            return orig(self, grads, state, p, leaves_lr)

        mp.setattr(jbase.FlatAdam, 'apply_updates', capture)

        def step_with_grads(state, inputs, k, lr):
            captured.clear()
            new, metrics, _ = jm._raw_step_fn(state, inputs, k, lr)
            return new, metrics, list(captured)

        new, metrics, (g_d, _, g_g) = jax.jit(step_with_grads)(
            jm.state, jm._step_inputs(), key, jm.old_lr)
        tm.optimize_parameters()
        assert next(noises, None) is None       # all three noises drawn
        return dict(port=tm, metrics=jax.device_get(metrics),
                    grads=jax.device_get({'G': g_g, 'D': g_d}),
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


def test_metrics_match_jax(step):
    ours = step['port'].get_current_errors()
    assert list(ours) == ['G_GAN', 'D_real', 'D_fake']
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(step['metrics'][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ['G', 'D'])
def test_gradients_match_jax(step, kind):
    for k_, index, mod in _port_modules(step['port']):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(step['grads'], kind, index))
        for name, p in mod.named_parameters():
            r = ref[name]
            if p.grad is None:          # an inert bias: exactly 0 there
                assert name.endswith('bias') and not r.abs().max() > 0, name
                continue
            err = float((p.grad - r).abs().max())
            assert err <= 1e-7 + 1e-4 * float(r.abs().max()), (name, err)


@pytest.mark.parametrize("kind", ['G', 'D'])
def test_params_after_step_match_jax(step, kind):
    """G takes two Adam steps (--n_update_G 2), D one."""
    n_steps = 2 if kind == 'G' else 1
    for k_, index, mod in _port_modules(step['port']):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(step['params'], kind, index))
        g = from_jax_params(mod, _sub(step['grads'], kind, index))
        for name, p in mod.named_parameters():
            gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
            allow = 1e-6 + 2 * n_steps * LR * (g[name].abs() < gtol).float()
            assert torch.all((p.detach() - ref[name]).abs() <= allow), name


def test_sample_matches_jax(tmp_path, monkeypatch):
    """The sampler's test(): the JAX-written G, the JAX sample's noise
    (--no_dropout: the two packages draw different dropout masks)."""
    monkeypatch.setattr(jnn, 'jit_init', _numpy_init)
    flags = (['--dataroot', './datasets/null', '--name', 'fc',
              '--checkpoints_dir', str(tmp_path), '--no_dropout'] + ARCH)
    jm0 = jcreate(JTrainOptions().parse(flags + TRAIN))
    os.makedirs(tmp_path / 'fc', exist_ok=True)
    jpth.save_pth(str(tmp_path / 'fc' / 'latest_net_G.pth'), jm0.netG,
                  jax_params(jm0.netG, 50))
    jm = jcreate(JTestOptions().parse(flags))
    jm.test()
    tm = tcreate(TTestOptions().parse(flags + ['--gpu_ids', '-1']))
    tm.draw_noise = lambda: nchw(jm.noise)
    tm.test()
    (fake,) = tm.outputs()
    np.testing.assert_allclose(nhwc(fake), np.asarray(jm.fake), rtol=1e-4,
                               atol=1e-4)
    assert list(tm.get_current_visuals()) == ['fake_label', 'fake_image']


def _flags_rt(ckpt, *extra):
    return (FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '2',
                     '--gpu_ids', '-1'] + list(extra))


def test_continue_train_equals_straight_steps(tmp_path):
    """Pools and dropout on: the full state carries Adam, the pool and the
    generators' states."""
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
    assert resumed.pools['pool']['num'] == 2


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    d = tmp_path_factory.mktemp('fc_data')
    os.makedirs(d / 'train')
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(
            np.uint8)).save(str(d / 'train' / ('%03d.png' % i)))
    return str(d)


def test_train_and_test_clis(dataroot, tmp_path):
    """The two entry points' main(), as the command line calls them."""
    ckpt, results = str(tmp_path / 'ckpt'), str(tmp_path / 'results')
    args = (['--gpu_ids', '-1', '--dataroot', dataroot, '--name', 'fc',
             '--checkpoints_dir', ckpt] + ARCH)
    r = ttrain.main(args + TRAIN + [
        '--pool_size', '2', '--niter', '1', '--niter_decay', '1',
        '--print_freq', '1', '--display_freq', '2', '--save_epoch_freq', '1'])
    assert r['steps'] == 4
    run = os.path.join(ckpt, 'fc')
    lines = [l for l in open(os.path.join(run, 'loss_log.txt'))
             if l.startswith('(epoch')]
    assert len(lines) == 4 and all('G_GAN: ' in l and 'D_real: ' in l
                                   and 'D_fake: ' in l for l in lines)
    files = set(os.listdir(run))
    for label in ('1', '2', 'latest'):
        want = {'%s_net_%s.pth' % (label, n) for n in ('G', 'D_0', 'D_1')}
        assert want | {'%s_state.pt' % label} <= files
    images = sorted(os.listdir(os.path.join(run, 'web', 'images')))
    assert images == sorted('epoch00%d_%s.png' % (e, v) for e in (1, 2)
                            for v in ('real_label', 'real_image',
                                      'fake_label', 'fake_image'))

    r = ttest.main(args + ['--results_dir', results, '--how_many', '2'])
    assert r['samples'] == 2 and r['nonfinite'] == 0
    assert os.path.exists(os.path.join(r['web_dir'], 'index.html'))
    assert sorted(os.listdir(os.path.join(r['web_dir'], 'images'))) == [
        '%04d_fake_%s.png' % (i, v) for i in (1, 2)
        for v in ('image', 'label')]


def test_sampler_prints_random_check(tmp_path, capsys):
    flags = (['--dataroot', './datasets/null', '--name', 'fc',
              '--checkpoints_dir', str(tmp_path), '--gpu_ids', '-1'] + ARCH)
    m = tcreate(TTrainOptions().parse(flags + TRAIN))
    m.save_network(m.netG, 'G', 'latest')
    sampler = tcreate(TTestOptions().parse(flags))
    capsys.readouterr()
    sampler.test()
    assert capsys.readouterr().out.startswith('Random check: ')


def test_interpolate_between_kept_noises(tmp_path):
    """set_fixed_noise keeps two test() draws; interpolate(alpha) runs G on
    their blend, its ends the two samples (no dropout: one mask a call;
    tests/test_torch_recon.py holds
    interpolate and reconstruction against the JAX package)."""
    m = tcreate(TTrainOptions().parse(_flags_rt(str(tmp_path),
                                                '--no_dropout')))
    ends = []
    for which in ('A', 'B'):
        m.test()
        m.set_fixed_noise(which)
        ends.append(m.fake)
    m.interpolate(0.5)
    assert torch.allclose(m.last_noise, (m.fixed_noiseA + m.fixed_noiseB) / 2)
    assert m.fake.shape == (1, 3, 32, 32)
    for alpha, end in ((0, ends[0]), (1, ends[1])):
        m.interpolate(alpha)
        assert torch.equal(m.fake, end)
