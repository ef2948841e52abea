"""--spatial_mesh train steps (supervised_gan_tpu_torch/parallel/spatial.py)
on the CPU: two gloo sp ranks, then a 2 x 2 data x sp grid of four, each
spawned once for the module and running tests/torch_spatial_jobs.py
``steps_job``; the unsharded references run here.

  * two steps of fcgan (the JAX package's tests/test_sharding.py SP_ARGS),
    of cgan (its CGAN_ARGS: dropout and pools on) and of twostage_cycle
    (tests/test_torch_train_step.py's widths, 128 px) at --spatial_mesh 2,
    batch 1, against the port's unsharded steps: losses within 1e-5
    relative in float32; in float64 every parameter, Adam moment and pool
    within 1e-9 (relative L2 per tensor) and the losses within 1e-12; the
    sp ranks' states bitwise equal;
  * two fcgan steps at --data_mesh 2 --spatial_mesh 2 (batch 2, four ranks)
    held the same way;
  * one fcgan step at --spatial_mesh 2 against the JAX package's
    --spatial_mesh 2 step on the 8-device virtual CPU mesh
    (tests/conftest.py) from the same parameters, batch and noises: the
    metrics within JAX's own tolerance for that test (rtol 5e-3, atol
    5e-4), the parameters within 5e-6 (2 lr an Adam step where JAX's
    gradient is rounding-sized, as tests/test_torch_parallel.py).
"""

import os
import types

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
from supervised_gan_tpu_torch import parallel
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

import torch_parallel_jobs as J
import torch_spatial_jobs as S
from test_torch_fcgan import LR, _numpy_init
from test_torch_layout import jax_params, nchw
from test_torch_layout import one_thread  # noqa: F401

JOIN_TIMEOUT = 600      # seconds the ranks may take, spawn included
GROUP_TIMEOUT = 300     # seconds a collective may wait for the other ranks
JAX_EXTRA = ['--pool_size', '0', '--no_dropout', '--n_update_G', '2']


def launch(fn, *args, data_mesh=0, spatial_mesh=2):
    opt = types.SimpleNamespace(
        data_mesh=data_mesh, spatial_mesh=spatial_mesh, dcn_num_processes=0,
        dcn_process_id=0, dcn_coordinator='', gpu_ids=[], batchSize=2,
        manualSeed=0, model='fcgan')
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('OMP_NUM_THREADS', '1')
        return parallel.launch(fn, opt, args, join_timeout=JOIN_TIMEOUT,
                               timeout_s=GROUP_TIMEOUT)
    finally:
        mp.undo()


def jax_case(path, ckpt):
    """The JAX fcgan step at --spatial_mesh 2, batch 1, from numpy-made
    parameters: writes the port's initial state_dicts and JAX's three
    noises to ``path``; returns JAX's metrics, gradients and parameters
    after it."""
    flags = J.config_flags('fcgan', ckpt, ['--batchSize', '1'] + JAX_EXTRA)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags + S.SP2))
        assert dict(jm.mesh.shape) == {'data': 1, 'sp': 2}
        params = {'G': jax_params(jm.netG, 40),
                  'D': {str(i): jax_params(d, 41 + i)
                        for i, d in enumerate(jm.netD)}}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        tm = tcreate(TTrainOptions().parse(flags))
        init = {'G': from_jax_params(tm.netG, params['G']),
                'D': from_jax_params(tm.netD, params['D'])}
        jm.set_input(S.batch('fcgan', 0, 1))
        key = jm.next_step_key()
        shape = jm._noise_shape()
        noises = [nchw(jax.random.normal(jax.random.fold_in(key, i), shape))
                  for i in (0, 3, 5)]
        torch.save({'init': init, 'noises': noises, 'extra': JAX_EXTRA},
                   path)
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
        return dict(modules={'G': tm.netG, 'D': tm.netD},
                    metrics=jax.device_get(metrics),
                    grads=jax.device_get({'G': g_g, 'D': g_d}),
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX step, one launch of two sp ranks (every STEP_CASE and the
    JAX-fed step), one of the 2 x 2 grid (GRID_CASES), then the unsharded
    references here."""
    out = str(tmp_path_factory.mktemp('spatial_steps'))
    case = os.path.join(out, 'jax_case.pt')
    jax_ref = jax_case(case, os.path.join(out, 'ckpt_jax_ref'))
    world = launch(S.steps_job, out, S.STEP_CASES, case)
    grid = launch(S.steps_job, out, S.GRID_CASES, data_mesh=2)
    ref = S.reference(out, S.STEP_CASES + S.GRID_CASES)

    def load(rank, name):
        return torch.load(os.path.join(out, 'rank%d_%s.pt' % (rank, name)),
                          weights_only=True)
    return dict(world=world, grid=grid, load=load, ref=ref, jax=jax_ref)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def test_grids_ran(runs):
    assert runs['world'] == 2 and runs['grid'] == 4


F32 = [c[0] for c in S.STEP_CASES + S.GRID_CASES if not c[2]]
F64 = [c[0] for c in S.STEP_CASES + S.GRID_CASES if c[2]]


@pytest.mark.parametrize('label', F32 + F64)
def test_ranks_hold_one_state(runs, label):
    s0, l0 = runs['load'](0, label)
    for r in range(4 if 'grid' in label else 2):
        s, losses = runs['load'](r, label)
        assert s.keys() == s0.keys() and losses == l0, r
        for k in s0:
            assert torch.equal(s0[k], s[k]), (r, k)


@pytest.mark.parametrize('label', F32)
def test_steps_ran_split(runs, label):
    """The sharded steps exchanged halos both ways, gathered replicated
    tensors, and all-reduced plane statistics (cgan, twostage_cycle: their
    IN planes of 16 rows or more) or BatchNorm's sums (fcgan's G; its D's
    IN planes are 8 rows and stay whole at 32 px)."""
    counts = runs['load'](0, label + '_collectives')
    for kind in ('fetch', 'fetch_grad', 'replicate', 'replicate_grad'):
        assert counts.get(kind, 0) > 0, (kind, counts)
    kind = 'sum_over' if 'fcgan' in label else 'sp_sum'
    assert counts.get(kind, 0) > 0, (kind, counts)


@pytest.mark.parametrize('label', F32)
def test_sharded_losses_equal_unsharded_float32(runs, label):
    _, ours = runs['load'](0, label)
    _, ref = runs['ref'][label]
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= 1e-5 * abs(v) + 1e-7, (k, ours[k], v)


@pytest.mark.parametrize('label', F64)
def test_sharded_state_equals_unsharded_float64(runs, label):
    ours, losses = runs['load'](0, label)
    ref, ref_losses = runs['ref'][label]
    assert next(iter(ours.values())).dtype == torch.float64
    for k, v in ref_losses.items():
        assert abs(losses[k] - v) <= 1e-12 * abs(v) + 1e-15, k
    assert ours.keys() == ref.keys()
    assert any(k.startswith('pool.') for k in ref) or 'fcgan' in label
    worst = max((rel_l2(ours[k], ref[k]), k) for k in ref)
    assert worst[0] <= 1e-9, worst


# ------------------------------------------------------------ against JAX -- #
def test_sharded_fcgan_step_metrics_match_jax_spatial_mesh(runs):
    _, ours = runs['load'](0, 'jax_fcgan')
    assert list(ours) == ['G_GAN', 'D_real', 'D_fake']
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(runs['jax']['metrics'][k]),
                                   rtol=5e-3, atol=5e-4, err_msg=k)


@pytest.mark.parametrize('kind', ['G', 'D'])
def test_sharded_fcgan_params_match_jax_spatial_mesh(runs, kind):
    """As tests/test_torch_parallel.py, 2 lr an Adam step where the JAX
    gradient is rounding-sized (G takes two steps, D one), but 5e-6 where
    it holds 1e-6: the largest gap elsewhere is 1.3e-6 (G's second conv
    after its two steps; every other tensor within 6e-8), against 2e-4
    that one Adam step moves a parameter."""
    state, _ = runs['load'](0, 'jax_fcgan')
    j = runs['jax']
    n_steps = 2 if kind == 'G' else 1
    mod = j['modules'][kind]
    ref = from_jax_params(mod, j['params'][kind])
    g = from_jax_params(mod, j['grads'][kind])
    for name, _ in mod.named_parameters():
        ours = state['%s.%s' % (kind, name)]
        gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
        allow = 5e-6 + 2 * n_steps * LR * (g[name].abs() < gtol).float()
        assert torch.all((ours - ref[name]).abs() <= allow), name
