"""--spatial_mesh on segmentation and segmentation_cycle
(supervised_gan_tpu_torch/parallel/spatial.py; nn/losses.py's segmentation
losses as shares of the global mean, models/segmentation.py's metrics on
gathered maps) on the CPU: two gloo sp ranks and a 2 x 2 data x sp grid,
each spawned once for the module, running tests/torch_spatial_recipes.py
``recipes_job``; the unsharded references run here.

  * two steps at --spatial_mesh 2, batch 1: segmentation with the weighted
    cross-entropy and with --use_sigmoid_ss (its weighted BCE), and
    segmentation_cycle, against the unsharded port: losses within 1e-5
    relative in float32; in float64 every tensor within 1e-9 (relative L2)
    and the losses within 1e-12; the accuracies (RandScore, meanIU) those
    of one process; the sp ranks bitwise equal;
  * the weighted-CE segmentation on a --data_mesh 2 --spatial_mesh 2 grid at
    batch 2, held the same way;
  * one segmentation step at --spatial_mesh 2 against the JAX package's
    --spatial_mesh 2 step on the 8-device virtual CPU mesh
    (tests/conftest.py) from the same parameters and batch: the metrics
    within rtol 5e-3 / atol 5e-4, the parameters within 5e-6 (2 lr where
    JAX's gradient is rounding-sized, as tests/test_torch_spatial_steps.py);
  * train_ss --spatial_mesh 2 as an entry point: the validation's
    RandScore and meanIU those of one process, the visuals whole, the
    `best` checkpoint written with its pool whole, --continue_train going
    on.
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
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch import train_ss as ttrain_ss
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

import torch_spatial_recipes as R
from test_torch_fcgan import _numpy_init
from test_torch_layout import jax_params
from test_torch_layout import one_thread  # noqa: F401
from test_torch_spatial_recipes import (check_losses_f32, check_ranks_equal,
                                        check_state_f64, launch, loader)

SEG = ['segmentation_weighted_ce', 'segmentation_sigmoid',
       'segmentation_cycle']
CASES = R.cases(SEG)
GRID_CASES = [('grid_seg', 'segmentation_weighted_ce', False, 2, R.GRID),
              ('f64_grid_seg', 'segmentation_weighted_ce', True, 2, R.GRID)]
JAX_RECIPE = 'segmentation_weighted_ce'
LR = 2e-4


def _port_modules(model):
    return [('G', None, model.netG)] + [
        ('D', str(i), d) for i, d in enumerate(model.netD)]


def _sub(tree, kind, index):
    return tree[kind] if index is None else tree[kind][index]


def jax_case(path, ckpt):
    """The JAX segmentation step at --spatial_mesh 2, batch 1, from
    numpy-made parameters: writes the port's case and initial state_dicts
    to ``path``; returns JAX's metrics, gradients and parameters after
    it."""
    flags = (R.COMMON + R.RECIPES[JAX_RECIPE][0]
             + ['--name', 'jax_seg', '--batchSize', '1',
                '--checkpoints_dir', ckpt])
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags + R.SP2))
        assert dict(jm.mesh.shape) == {'data': 1, 'sp': 2}
        params = {'G': jax_params(jm.netG, 80),
                  'D': {str(i): jax_params(d, 81 + i)
                        for i, d in enumerate(jm.netD)}}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        tm = tcreate(TTrainOptions().parse(flags))
        init = {'G': from_jax_params(tm.netG, params['G']),
                'D': from_jax_params(tm.netD, params['D'])}
        torch.save({'case': ('jax', JAX_RECIPE, False, 1, R.SP2),
                    'init': init}, path)
        jm.set_input(R.batch(JAX_RECIPE, 0, 1))
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

        new, metrics, grads = jax.jit(step_with_grads)(
            jm.state, jm._step_inputs(), jm.next_step_key(), jm._step_lrs())
        return dict(model=tm, metrics=jax.device_get(metrics),
                    grads=jax.device_get({'G': grads[-1]['G'],
                                          'D': grads[0]}),
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('spatial_seg'))
    case = os.path.join(out, 'jax_case.pt')
    jax_ref = jax_case(case, os.path.join(out, 'ckpt_jax_ref'))
    world = launch(R.recipes_job, out, CASES, case)
    grid = launch(R.recipes_job, out, GRID_CASES, data_mesh=2)
    ref = R.reference(out, CASES + GRID_CASES)
    return dict(world=world, grid=grid, load=loader(out), ref=ref,
                jax=jax_ref)


def test_grids_ran(runs):
    assert runs['world'] == 2 and runs['grid'] == 4


@pytest.mark.parametrize('label', [c[0] for c in CASES + GRID_CASES])
def test_ranks_hold_one_state(runs, label):
    check_ranks_equal(runs['load'], label, 4 if 'grid' in label else 2)


@pytest.mark.parametrize('label', [c[0] for c in CASES + GRID_CASES
                                   if not c[2]])
def test_sharded_losses_equal_unsharded_float32(runs, label):
    check_losses_f32(runs['load'](0, label)[1], runs['ref'][label][1])


@pytest.mark.parametrize('label', [c[0] for c in CASES + GRID_CASES
                                   if c[2]])
def test_sharded_state_equals_unsharded_float64(runs, label):
    ours, losses, _ = runs['load'](0, label)
    ref, ref_losses, _ = runs['ref'][label]
    check_state_f64(ours, ref, losses, ref_losses)


@pytest.mark.parametrize('label', [c[0] for c in CASES + GRID_CASES
                                   if c[2]])
def test_sharded_accuracies_equal_unsharded(runs, label):
    """RandScore and meanIU, read from maps gathered over the sp group, are
    one process's (float64: no pixel's class flips).  On the grid meanIU is
    the data rows' mean of their own (the --data_mesh reading of the train
    accuracies), not the whole batch's ratio: RandScore alone, a mean over
    images, is held there."""
    accs = runs['load'](0, label)[2]
    ref = runs['ref'][label][2]
    assert list(accs) == ['RandScore', 'meanIU'] == list(ref)
    for k, v in ref.items():
        if 'grid' in label and k == 'meanIU':
            continue
        assert abs(accs[k] - float(v)) <= 1e-12, (k, accs[k], v)


# ------------------------------------------------------------ against JAX -- #
def test_sharded_segmentation_step_metrics_match_jax_spatial_mesh(runs):
    _, ours, _ = runs['load'](0, 'jax')
    assert list(ours) == ['G_CE', 'G_GAN']
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(runs['jax']['metrics'][k]),
                                   rtol=5e-3, atol=5e-4, err_msg=k)


@pytest.mark.parametrize('kind', ['G', 'D'])
def test_sharded_segmentation_params_match_jax_spatial_mesh(runs, kind):
    """One Adam step each: 5e-6, and 2 lr where JAX's gradient is
    rounding-sized (Adam's first step turns it into +-lr)."""
    state, _, _ = runs['load'](0, 'jax')
    j = runs['jax']
    for k, index, mod in _port_modules(j['model']):
        if k != kind:
            continue
        ref = from_jax_params(mod, _sub(j['params'], k, index))
        g = from_jax_params(mod, _sub(j['grads'], k, index))
        prefix = kind if index is None else '%s.%s' % (kind, index)
        for name, _ in mod.named_parameters():
            ours = state['%s.%s' % (prefix, name)]
            gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
            allow = 5e-6 + 2 * LR * (g[name].abs() < gtol).float()
            assert torch.all((ours - ref[name]).abs() <= allow), (k, name)


# ------------------------------------------------------ the entry point -- #
@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp('sp_ss_data')
    rng = np.random.RandomState(0)
    for sub, n in (('train', 2), ('val', 1)):
        os.makedirs(root / sub)
        for i in range(n):
            a = np.zeros((128, 128, 3), np.uint8)
            a[..., 0] = (rng.rand(128, 128) > 0.6) * 255
            a[..., 1] = 255 - a[..., 0]
            a[..., 2] = rng.randint(0, 255, (128, 128))
            Image.fromarray(a).save(str(root / sub / ('%03d.png' % i)))
    return str(root)


def test_train_ss_entry_point_spatial_mesh(dataroot, tmp_path, monkeypatch):
    """train_ss --spatial_mesh 2 (segmentation with its D and a pool): the
    validation's accuracies are one process's, the displayed visuals whole,
    `best` written with the pool whole, and --continue_train goes on."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    flags = [f for f in R.COMMON if f not in ('./datasets/unused',
                                              '--dataroot')]
    args = flags + R.RECIPES['segmentation_weighted_ce'][0] + [
        '--dataroot', dataroot, '--name', 'ss', '--pool_size', '2',
        '--batchSize', '1', '--niter', '1', '--niter_decay', '0',
        '--print_freq', '1', '--display_freq', '1', '--save_epoch_freq',
        '1', '--best_metric', 'meanIU', '--nThreads', '1']
    one = ttrain_ss.main(args + ['--checkpoints_dir', str(tmp_path / 'one')])
    r = ttrain_ss.main(args + ['--checkpoints_dir', str(tmp_path / 'sp'),
                               '--spatial_mesh', '2'])
    assert r['steps'] == one['steps'] == 2
    assert list(r['val_accs'][0]) == ['RandScore', 'meanIU']
    for k, v in one['val_accs'][0].items():
        assert abs(r['val_accs'][0][k] - v) <= 1e-6, (k, r['val_accs'], v)
    assert r['best'] == r['val_accs'][0]['meanIU']
    run = tmp_path / 'sp' / 'ss'
    assert {'best_net_G.pth', 'best_state.pt', 'best_net_D_0.pth'} <= set(
        os.listdir(run))
    state = torch.load(str(run / 'best_state.pt'), weights_only=True)
    assert state['pools']['fake']['images'].shape == (2, 3, 128, 128)
    for v in ('image', 'label', 'prediction'):
        img = Image.open(str(run / 'web' / 'images'
                             / ('epoch001_%s.png' % v)))
        assert img.size == (128, 128)
    again = ttrain_ss.main(args + ['--checkpoints_dir', str(tmp_path / 'sp'),
                                   '--spatial_mesh', '2', '--continue_train',
                                   '--which_epoch', 'latest'])
    assert again['steps'] == 2 and len(again['val_accs']) == 1
