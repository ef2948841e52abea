"""SGAN step 2, `--model cgan`, of the port on the CPU against the JAX
package's: G unet_256 ngf 4 with injected Gaussian noise at 256 px (its 8
downs need it), a 2-scale D bank ndf 4 of n_layers 2 and 3 on cat(A, B),
BCE losses, --weight_L1 2 4, --n_update_G 2, --pool_size 0, --no_dropout.

One f32 train step, as tests/test_torch_fcgan.py does for stage 1: both
sides start from one numpy-made parameter set (from_jax_params) and see the
same batch, and the port's draws replay JAX's key schedule
(models/common.py build_gan_train_step there: the first forward's key
fold_in(step key, 1), the redraws after the two G updates 4 and 6; level n
of a forward draws fold_in(forward key, n)).  Compared: the four metrics
(1e-5), the D gradient of the D update and the G gradient of the last G
update (1e-4 of the tensor's largest entry, plus 1e-7), and every
parameter after the step (1e-6, plus 2 lr per Adam step where |g| is below
the gradient tolerance).

Also: a save -> --continue_train -> step round trip equal to two straight
steps (pools, dropout and the noise on), the .pth files loading into the
JAX package's utils/pth.py, and the conditional sampler, ``python -m
supervised_gan_tpu_torch.test --model cgan --gpu_ids -1``, against the JAX
model's test() on the same images and draws (1e-4).
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.data import CreateDataLoader as JCreateDataLoader
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TestOptions as JTestOptions
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch.models import cgan as tcgan
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc
from test_torch_layout import one_thread  # noqa: F401

ARCH = ['--model', 'cgan', '--which_direction', 'AtoB',
        '--dataset_mode', 'single', '--loadSize', '256', '--fineSize', '256',
        '--batchSize', '1', '--which_model_netG', 'unet_256', '--ngf', '4',
        '--noise_nc', '8', '--noiseSize', '4', '--norm', 'instance',
        '--add_gaussian_noise', '--which_channel', 'rg_b',
        '--manualSeed', '0', '--display_id', '0']
TRAIN = ['--which_model_netD', 'n_layers', '--n_layers_D', '2', '3',
         '--ndf', '4', '--scale_factor', '1', '2', '--lambda_D', '0.5', '0.4',
         '--lambda_A', '10', '--n_update_G', '2', '--weight_L1', '2', '4',
         '--no_lsgan', '--lr', '0.0002']
FLAGS = ['--dataroot', './datasets/unused', '--name', 'cg'] + ARCH + TRAIN
LR = 2e-4


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    a[..., :2] = np.sign(a[..., :2])          # binary label channels
    return {'A': a, 'A_paths': ['x.png']}


def _port_modules(model):
    return [('G', None, model.netG)] + [
        ('D', str(i), d) for i, d in enumerate(model.netD)]


def _sub(tree, kind, index):
    return tree[kind] if index is None else tree[kind][index]


def _numpy_init(layer, key):
    """Stands in for the JAX package's jit_init where the test replaces the
    values (its own init runs eagerly, an XLA compile per op)."""
    return jax_params(layer, 0)


class JaxDraws:
    """The port's draws replaced by the JAX forward keys: each call of
    draw_noise (one a recorded forward) takes the next key of ``keys`` for
    the noise input (fold_in(key, noise_index)) and the forward's
    GaussianNoise draws (fold_in(forward key, n), n from 0)."""

    def __init__(self, keys):
        self.keys = iter(keys)
        self.fkey, self.n = None, None

    def draw_noise(self, shape, noise_key):
        self.fkey = next(self.keys)
        self.n = itertools.count()
        z = jax.random.normal(noise_key, (shape[0], shape[2], shape[3],
                                          shape[1]))
        return nchw(z)

    def gauss(self, shape, dtype, device):
        z = jax.random.normal(jax.random.fold_in(self.fkey, next(self.n)),
                              (shape[0], shape[2], shape[3], shape[1]))
        return nchw(z).to(dtype=dtype, device=device)

    def install(self, model, noise_keys):
        noise_keys = iter(noise_keys)
        o = model.opt
        shape = (o.batchSize, o.noise_nc, o.noiseSize, o.noiseSize)
        model.draw_noise = lambda: self.draw_noise(shape, next(noise_keys))
        for m in model.netG.modules():
            if isinstance(m, tnn.GaussianNoise):
                m.draw = self.gauss


@pytest.fixture(scope='module')
def step(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp('cgan_step'))
    flags = FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '0',
                     '--no_dropout']
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        params = {'G': jax_params(jm.netG, 60),
                  'D': {str(i): jax_params(d, 61 + i)
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
        draws = JaxDraws([jax.random.fold_in(key, i) for i in (1, 4, 6)])
        draws.install(tm, [jax.random.fold_in(key, i) for i in (0, 3, 5)])

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

        new, metrics, (g_d, g_g1, g_g) = jax.jit(step_with_grads)(
            jm.state, jm._step_inputs(), key, jm.lrs())
        tm.optimize_parameters()
        assert next(draws.keys, None) is None     # three forwards recorded
        return dict(port=tm, metrics=jax.device_get(metrics),
                    grads=jax.device_get({'G': g_g['G'], 'D': g_d}),
                    first_grads=jax.device_get({'G': g_g1['G']}),
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


def test_metrics_match_jax(step):
    """G_GAN is the total (GAN + L1), as in the JAX package."""
    ours = step['port'].get_current_errors()
    assert list(ours) == ['G_GAN', 'G_L1', 'D_real', 'D_fake']
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
    """G takes two Adam steps (--n_update_G 2), D one: 2 lr of slack for
    each step whose gradient entry was below its tolerance."""
    for k_, index, mod in _port_modules(step['port']):
        if k_ != kind:
            continue
        ref = from_jax_params(mod, _sub(step['params'], kind, index))
        steps = [from_jax_params(mod, _sub(step[g], kind, index))
                 for g in (('first_grads', 'grads') if kind == 'G'
                           else ('grads',))]
        for name, p in mod.named_parameters():
            allow = 1e-6
            for g in steps:
                gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
                allow = allow + 2 * LR * (g[name].abs() < gtol).float()
            assert torch.all((p.detach() - ref[name]).abs() <= allow), name


def _flags_rt(ckpt, *extra):
    return (FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '2',
                     '--gpu_ids', '-1'] + list(extra))


def test_continue_train_equals_straight_steps(tmp_path):
    """Pools, dropout and the injected noise on: the full state carries
    Adam, the pool and the generators' states."""
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
    assert resumed.pools['fake']['num'] == 2


def test_lr_decay_is_single_rate_and_unclamped(tmp_path):
    m = tcreate(TTrainOptions().parse(_flags_rt(
        str(tmp_path), '--niter_decay', '1')))
    m.update_learning_rate()
    m.update_learning_rate()
    assert m.old_lr == pytest.approx(-LR)
    for o in (m.optG, m.optD):
        assert o.param_groups[0]['lr'] == pytest.approx(-LR)


def test_port_pth_loads_in_jax(tmp_path):
    tm = tcreate(TTrainOptions().parse(_flags_rt(str(tmp_path))))
    tm.save('latest')
    jnets = {'G': jnn.define_G(2, 1, 4, 'unet_256', 'instance', True,
                               add_gaussian_noise=True),
             'D_0': jnn.define_D(3, 4, 'n_layers', 2, 'instance', True, 1),
             'D_1': jnn.define_D(3, 4, 'n_layers', 3, 'instance', True, 2)}
    for label, jnet in jnets.items():
        params = jpth.load_pth(os.path.join(
            str(tmp_path), 'cg', 'latest_net_%s.pth' % label), jnet)
        mod = tm.netG if label == 'G' else tm.netD[int(label[-1])]
        ref = from_jax_params(mod, params)
        for name, p in mod.named_parameters():
            assert torch.equal(p.detach(), ref[name]), (label, name)
    assert os.path.exists(os.path.join(str(tmp_path), 'cg',
                                       'latest_state.pt'))


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    d = tmp_path_factory.mktemp('cg_data')
    os.makedirs(d / 'test')
    rng = np.random.RandomState(0)
    for i in range(3):
        a = np.zeros((256, 256, 3), np.uint8)
        a[..., 0] = (rng.rand(256, 256) > 0.7) * 255
        a[..., 1] = (rng.rand(256, 256) > 0.8) * 255
        a[..., 2] = rng.randint(0, 255, (256, 256))
        Image.fromarray(a).save(str(d / 'test' / ('%03d.png' % i)))
    return str(d)


def test_conditional_sampler_matches_jax(dataroot, tmp_path, monkeypatch):
    """The sampler entry point on a JAX-written G over the first 2 of 3
    images, against the JAX model's test() on the loader's same batches
    (--no_dropout: the packages draw different dropout masks; the injected
    noise replayed from the JAX sampler's keys)."""
    monkeypatch.setattr(sin, '_FMA', False)
    monkeypatch.setattr(jnn, 'jit_init', _numpy_init)
    ckpt = str(tmp_path / 'ckpt')
    flags = ['--dataroot', dataroot, '--name', 'cg', '--checkpoints_dir',
             ckpt, '--no_dropout', '--serial_batches', '--no_flip',
             '--no_rotate'] + ARCH
    jnet = jnn.define_G(2, 1, 4, 'unet_256', 'instance', False,
                        add_gaussian_noise=True)
    os.makedirs(os.path.join(ckpt, 'cg'))
    jpth.save_pth(os.path.join(ckpt, 'cg', 'latest_net_G.pth'), jnet,
                  jax_params(jnet, 70))

    jopt = JTestOptions().parse(flags + ['--how_many', '2'])
    jopt.nThreads, jopt.batchSize = 1, 1
    jm = jcreate(jopt)
    keys, refs = [], []
    take_key = jm.next_test_key
    jm.next_test_key = lambda: keys.append(take_key()) or keys[-1]
    for i, data in enumerate(JCreateDataLoader(jopt).load_data()):
        if i == 2:
            break
        jm.set_input(data)
        jm.test()
        refs.append(np.asarray(jm.fake_B))

    draws = JaxDraws([jax.random.fold_in(k, 1) for k in keys])
    noise_keys = iter([jax.random.fold_in(k, 0) for k in keys])
    outs = []
    orig_test = tcgan.CGANModel.test

    def test(self):
        o = self.opt
        shape = (o.batchSize, o.noise_nc, o.noiseSize, o.noiseSize)
        self.draw_noise = lambda: draws.draw_noise(shape, next(noise_keys))
        for m in self.netG.modules():
            if isinstance(m, tnn.GaussianNoise):
                m.draw = draws.gauss
        orig_test(self)
        outs.append(self.fake_B)

    monkeypatch.setattr(tcgan.CGANModel, 'test', test)
    r = ttest.main(flags + ['--gpu_ids', '-1', '--how_many', '2',
                            '--results_dir', str(tmp_path / 'results')])
    assert r['samples'] == 2 and r['nonfinite'] == 0
    assert len(outs) == 2
    for ours, ref in zip(outs, refs):
        np.testing.assert_allclose(nhwc(ours), ref, rtol=1e-4, atol=1e-4)
    assert sorted(os.listdir(os.path.join(r['web_dir'], 'images'))) == [
        '%03d_%s.png' % (i, v) for i in (0, 1) for v in ('fake_B', 'real_A')]
    monkeypatch.setattr(tcgan.CGANModel, 'test', orig_test)
    r = ttest.main(flags + ['--gpu_ids', '-1', '--how_many', '1',
                            '--save_as_single_image', '--results_dir',
                            str(tmp_path / 'single')])
    assert os.listdir(os.path.join(r['web_dir'], 'images')) == ['000_AB.png']
