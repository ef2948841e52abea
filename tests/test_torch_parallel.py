"""Data parallelism (--data_mesh, supervised_gan_tpu_torch/parallel/) on the
CPU: two gloo ranks, spawned once for the module (parallel.launch, one torch
thread a worker, a finite group timeout and join timeout), each running
tests/torch_parallel_jobs.py.

  * units: the cross-rank batch_norm's output and gradients against the
    unsharded batch_norm; the Dropout, GaussianNoise and BaseModel.noise
    draws, row for row, against the unsharded draws; a pool queried with
    the gathered batch against the unsharded query; the optimizer hook's
    mean of the ranks' gradients;
  * two steps at --data_mesh 2 of the JAX package's tests/test_sharding.py
    flag sets (fcgan, the cgan with dropout and pools, twostage with the
    multi-class D2) and of the main path's recipe, twostage_cycle (BN in G1,
    three pools), against the port's unsharded step at the global batch:
    losses within 1e-5 relative, every parameter, Adam moment and pool
    within 1e-4 relative L2 per tensor (twostage_cycle: see below), the two
    ranks' states bitwise equal;
  * one fcgan step at --data_mesh 2 against the JAX package's unsharded
    step on the same parameters, batch and noises (as
    tests/test_torch_fcgan.py holds the unsharded port).

twostage_cycle in float32 misses 1e-4 (measured on the CPU, one thread a
rank): after one step F2's Adam moments are up to 3.8e-4 (relative L2) off
the unsharded run's; after two, where Adam's first step has turned
rounding-sized gradients into +-lr, up to 2.3e-2 (G2's first moments up to
1.1e-3 apart elementwise), while its losses stay within 2.2e-7.  F2's
dropout and the two cycle terms carry it (without either every tensor is
within 4.3e-5), and in float64 the sharded and the unsharded runs agree
within 1e-12, so it is float32 rounding of the split batch amplified by
the step, not a different function.  So that recipe is held in float64,
two steps, within 1e-9 per tensor; in float32 after one step every tensor
within 1e-3 relative L2, and after two its losses within 1e-5 and its
parameters and pools within JAX's own sharding tolerance elementwise (rtol
5e-3, atol 5e-4).
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
from test_torch_fcgan import LR, _numpy_init
from test_torch_layout import jax_params, nchw
from test_torch_layout import one_thread  # noqa: F401

JOIN_TIMEOUT = 300      # seconds the two ranks may take, spawn included
GROUP_TIMEOUT = 120     # seconds a collective may wait for the other rank
F32 = ['fcgan', 'cgan', 'twostage']
JAX_EXTRA = ['--pool_size', '0', '--no_dropout', '--n_update_G', '2']


def launch_two(fn, *args):
    """``fn(opt, *args)`` in two spawned gloo ranks (one torch thread each)."""
    opt = types.SimpleNamespace(data_mesh=2, dcn_num_processes=0,
                                dcn_process_id=0, dcn_coordinator='',
                                gpu_ids=[], batchSize=2, manualSeed=0)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('OMP_NUM_THREADS', '1')
        return parallel.launch(fn, opt, args, join_timeout=JOIN_TIMEOUT,
                               timeout_s=GROUP_TIMEOUT)
    finally:
        mp.undo()


def jax_case(path, ckpt):
    """The JAX fcgan step at the global batch 2 from numpy-made parameters:
    writes the port's initial state_dicts and JAX's three noises to
    ``path``; returns JAX's metrics, gradients and parameters after it."""
    flags = J.config_flags('fcgan', ckpt, JAX_EXTRA)
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
        tm = tcreate(TTrainOptions().parse(flags))
        init = {'G': from_jax_params(tm.netG, params['G']),
                'D': from_jax_params(tm.netD, params['D'])}
        jm.set_input(J.batch('fcgan', 0))
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
    """One launch of two ranks: the units, the F32 configs and
    twostage_cycle sharded, the JAX-fed fcgan step, and twostage_cycle in
    float64 both sharded and (rank 0, in parallel.unsharded) not; then the
    unsharded float32 steps here."""
    out = str(tmp_path_factory.mktemp('parallel'))
    jax_ref = jax_case(os.path.join(out, 'jax_case.pt'),
                       os.path.join(out, 'ckpt_jax_ref'))
    world = launch_two(J.all_job, out, F32 + ['twostage_cycle'],
                       os.path.join(out, 'jax_case.pt'))
    ref = {name: J.run_config(name, os.path.join(out, 'ckpt_ref'))
           for name in F32 + ['twostage_cycle']}
    ref['twostage_cycle_1'] = J.run_config(
        'twostage_cycle', os.path.join(out, 'ckpt_ref'), steps=1)

    def load(rank, name):
        return torch.load(os.path.join(out, 'rank%d_%s.pt' % (rank, name)),
                          weights_only=True)
    return dict(world=world, load=load, ref=ref, jax=jax_ref)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


# ----------------------------------------------------------------- units -- #
def test_two_ranks_ran(runs):
    assert runs['world'] == 2


def test_batch_norm_forward_and_gradient_equal_unsharded(runs):
    x, w, b, cot = J.bn_inputs()
    y, gx, gw, gb = J.bn_grads(x, w, b, cot)
    r = [runs['load'](k, 'units')['bn'] for k in (0, 1)]
    # each rank holds its rows of y and of dL/dx; dL/dw is the ranks' sum
    torch.testing.assert_close(torch.cat([r[0][0], r[1][0]]), y, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(torch.cat([r[0][1], r[1][1]]), gx, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(r[0][2] + r[1][2], gw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(r[0][3] + r[1][3], gb, rtol=1e-5, atol=1e-5)


def test_sliced_global_draws_equal_unsharded_draws(runs):
    ref = J.draws(4)
    r = [runs['load'](k, 'units')['draws'] for k in (0, 1)]
    for key in ('dropout', 'gauss', 'noise'):
        assert r[0][key].shape[0] == ref[key].shape[0] // 2, key
        assert torch.equal(torch.cat([r[0][key], r[1][key]]), ref[key]), key


def test_gathered_pool_query_equals_unsharded(runs):
    g = torch.Generator().manual_seed(8)
    outs, images = J.pool_query(torch.randn(2, 4, 2, 4, 4, generator=g),
                                J.pool_rows())
    r = [runs['load'](k, 'units')['pool'] for k in (0, 1)]
    for i in range(2):
        assert torch.equal(torch.cat([r[0][0][i], r[1][0][i]]), outs[i])
    for k in (0, 1):
        assert torch.equal(r[k][1], images)     # the pool stays replicated


def test_gradient_hook_averages(runs):
    for k in (0, 1):
        h = runs['load'](k, 'units')['hook']
        # ranks' gradients 1, 2 and 2, 4: their means
        assert torch.equal(h['p_grad'], torch.full((3,), 1.5))
        assert torch.equal(h['q_grad'], torch.full((2, 2), 3.0))
        assert torch.equal(h['p'], runs['load'](0, 'units')['hook']['p'])
    u = runs['load'](0, 'units')
    assert u['mean_values'] == {'a': 0.5, 'b': 4.0}
    assert u['unsharded'] == (1, 4)


def test_one_process_has_no_collective():
    """--data_mesh 0 or 1 builds no group: every helper is the identity and
    no hook is registered."""
    assert not parallel.active() and parallel.world() == 1
    x = torch.arange(6.0).view(3, 2)
    assert parallel.rows(x) is x and parallel.gather_rows(x) is x
    assert parallel.mean_all_reduce(x) is x
    p = torch.nn.Parameter(torch.zeros(2))
    from supervised_gan_tpu_torch.models.base import adam
    o = adam([([p], 1e-3)], 0.5, torch.device('cpu'))
    assert not o._optimizer_step_pre_hooks


# ----------------------------------------------------------------- steps -- #
def _close_losses(ours, ref):
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= 1e-5 * abs(v) + 1e-7, (k, ours[k], v)


@pytest.mark.parametrize('name', F32 + ['twostage_cycle',
                                  'f64_twostage_cycle'])
def test_ranks_hold_one_state(runs, name):
    (s0, l0), (s1, l1) = runs['load'](0, name), runs['load'](1, name)
    assert s0.keys() == s1.keys() and l0 == l1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.parametrize('name', F32)
def test_sharded_steps_equal_unsharded(runs, name):
    ours, losses = runs['load'](0, name)
    ref, ref_losses = runs['ref'][name]
    _close_losses(losses, ref_losses)
    assert ours.keys() == ref.keys()
    worst = max((rel_l2(ours[k], ref[k]), k) for k in ref)
    assert worst[0] <= 1e-4, worst


def test_twostage_cycle_sharded_step_float32(runs):
    ours, losses = runs['load'](0, 'twostage_cycle_1')
    ref, ref_losses = runs['ref']['twostage_cycle_1']
    _close_losses(losses, ref_losses)
    assert ours.keys() == ref.keys()
    worst = max((rel_l2(ours[k], ref[k]), k) for k in ref)
    assert worst[0] <= 1e-3, worst


def test_twostage_cycle_sharded_steps_float32(runs):
    ours, losses = runs['load'](0, 'twostage_cycle')
    ref, ref_losses = runs['ref']['twostage_cycle']
    _close_losses(losses, ref_losses)
    assert ours.keys() == ref.keys()
    for k in ref:
        if not k.startswith('adam.'):
            err = (ours[k] - ref[k]).abs() - 5e-3 * ref[k].abs()
            assert float(err.max()) <= 5e-4, k


def test_twostage_cycle_sharded_steps_float64(runs):
    ours, losses = runs['load'](0, 'f64_twostage_cycle')
    ref, ref_losses = runs['load'](0, 'f64_ref_twostage_cycle')
    assert next(iter(ours.values())).dtype == torch.float64
    for k, v in ref_losses.items():
        assert abs(losses[k] - v) <= 1e-12 * abs(v), k
    assert ours.keys() == ref.keys()
    worst = max((rel_l2(ours[k], ref[k]), k) for k in ref)
    assert worst[0] <= 1e-9, worst


# ------------------------------------------------------------ against JAX -- #
def test_sharded_fcgan_step_metrics_match_jax(runs):
    _, ours = runs['load'](0, 'jax_fcgan')
    assert list(ours) == ['G_GAN', 'D_real', 'D_fake']
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(runs['jax']['metrics'][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize('kind', ['G', 'D'])
def test_sharded_fcgan_params_match_jax(runs, kind):
    """As tests/test_torch_fcgan.py: 1e-6, plus 2 lr an Adam step where the
    JAX gradient is rounding-sized (G takes two steps, D one)."""
    state, _ = runs['load'](0, 'jax_fcgan')
    j = runs['jax']
    n_steps = 2 if kind == 'G' else 1
    mod = j['modules'][kind]
    ref = from_jax_params(mod, j['params'][kind])
    g = from_jax_params(mod, j['grads'][kind])
    for name, _ in mod.named_parameters():
        ours = state['%s.%s' % (kind, name)]
        gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
        allow = 1e-6 + 2 * n_steps * LR * (g[name].abs() < gtol).float()
        assert torch.all((ours - ref[name]).abs() <= allow), name
