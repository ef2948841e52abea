"""--spatial_mesh on the two-stage family and the cgan family
(supervised_gan_tpu_torch/parallel/spatial.py) on the CPU: two gloo sp
ranks spawned once for the module, running tests/torch_spatial_recipes.py
``recipes_job``; the unsharded references run here.

Two steps of each recipe at --spatial_mesh 2, batch 1, at the widths of its
own CPU test, against the port's unsharded steps: twostage with
--use_multi_class_GAN (the 3-class D2, pools pool2_1 and pool2_2), twostage
with --no_cgan's D2, twostage_factd (the factorized D2's padded product),
cgan_cycle, cgan2, cgan2_cycle and cgan_causal (the unaligned set's third
input, the cycle losses, the pools).  In float32 the losses within 1e-5
relative; in float64 every parameter, Adam moment and pool within 1e-9
(relative L2 per tensor) and the losses within 1e-12; the sp ranks' states
bitwise equal; the steps exchanged halos and all-reduced IN sums.
"""

import os
import types

import pytest
import torch

from supervised_gan_tpu_torch import parallel

import torch_spatial_recipes as R
from test_torch_layout import one_thread  # noqa: F401

JOIN_TIMEOUT = 900      # seconds the ranks may take, spawn included
GROUP_TIMEOUT = 300     # seconds a collective may wait for the other ranks
RECIPES = ['twostage_multiclass', 'twostage_no_cgan', 'twostage_factd',
           'cgan_cycle', 'cgan2', 'cgan2_cycle', 'cgan_causal']
CASES = R.cases(RECIPES)


def launch(fn, *args, data_mesh=0, spatial_mesh=2):
    """``fn(opt, *args)`` in the grid's spawned gloo ranks (one torch thread
    each)."""
    opt = types.SimpleNamespace(
        data_mesh=data_mesh, spatial_mesh=spatial_mesh, dcn_num_processes=0,
        dcn_process_id=0, dcn_coordinator='', gpu_ids=[],
        batchSize=max(data_mesh, 1), manualSeed=0, model='fcgan')
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('OMP_NUM_THREADS', '1')
        return parallel.launch(fn, opt, args, join_timeout=JOIN_TIMEOUT,
                               timeout_s=GROUP_TIMEOUT)
    finally:
        mp.undo()


def loader(out):
    def load(rank, name):
        return torch.load(os.path.join(out, 'rank%d_%s.pt' % (rank, name)),
                          weights_only=True)
    return load


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('spatial_recipes'))
    world = launch(R.recipes_job, out, CASES)
    return dict(world=world, load=loader(out), ref=R.reference(out, CASES))


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def check_ranks_equal(load, label, n_ranks):
    s0 = load(0, label)
    for r in range(1, n_ranks):
        s = load(r, label)
        assert s[0].keys() == s0[0].keys() and s[1] == s0[1], r
        assert s[2] == s0[2], r
        for k in s0[0]:
            assert torch.equal(s0[0][k], s[0][k]), (r, k)


def check_losses_f32(ours, ref):
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= 1e-5 * abs(v) + 1e-7, (k, ours[k], v)


def check_state_f64(ours, ref, losses, ref_losses, noise=()):
    """Every tensor within 1e-9 relative L2 and the losses within 1e-12;
    the tensors named in ``noise`` (moments of a gradient that is 0 in
    exact arithmetic) within 1e-12 absolute."""
    assert next(iter(ours.values())).dtype == torch.float64
    for k, v in ref_losses.items():
        assert abs(losses[k] - v) <= 1e-12 * abs(v) + 1e-15, k
    assert ours.keys() == ref.keys()
    worst = max((rel_l2(ours[k], ref[k]), k) for k in ref if k not in noise)
    assert worst[0] <= 1e-9, worst
    for k in noise:
        assert float((ours[k] - ref[k]).norm()) <= 1e-12, k


def test_two_ranks_ran(runs):
    assert runs['world'] == 2


@pytest.mark.parametrize('label', [c[0] for c in CASES])
def test_ranks_hold_one_state(runs, label):
    check_ranks_equal(runs['load'], label, 2)


@pytest.mark.parametrize('recipe', RECIPES)
def test_steps_ran_split(runs, recipe):
    """Halos both ways, replicated tensors gathered, IN sums all-reduced."""
    counts = runs['load'](0, recipe + '_collectives')
    for kind in ('fetch', 'fetch_grad', 'replicate', 'replicate_grad',
                 'sp_sum'):
        assert counts.get(kind, 0) > 0, (kind, counts)


@pytest.mark.parametrize('recipe', RECIPES)
def test_sharded_losses_equal_unsharded_float32(runs, recipe):
    check_losses_f32(runs['load'](0, recipe)[1], runs['ref'][recipe][1])


@pytest.mark.parametrize('recipe', RECIPES)
def test_sharded_state_equals_unsharded_float64(runs, recipe):
    label = 'f64_' + recipe
    ours, losses, _ = runs['load'](0, label)
    ref, ref_losses, _ = runs['ref'][label]
    assert any(k.startswith('pool.') for k in ref)
    if recipe == 'twostage_multiclass':
        assert {'pool.pool2_1', 'pool.pool2_2'} <= set(ref)
    check_state_f64(ours, ref, losses, ref_losses)
