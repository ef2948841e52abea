"""The DSGAN recipe's training options, one whole f32 step of the port
(plain versions of its kernels) against the JAX package's, on the CPU at
128 px with the narrow widths of tests/test_torch_train_step.py, one case
each: (a) --use_multi_class_GAN (3-class D2, pools pool2_1 and pool2_2),
(b) the fake_fake pairs in --GAN_losses_D2 and --GAN_losses_G2 (pool2
queried twice) with --use_fixed_noise1 (noise1 from a pool of draws made
at init), (c) --no_cgan (D2 on the image alone), (d) the fake_fake pairs
with --detach_G1_from_G2_y.

Both sides start from one numpy-made parameter set and see the same batch,
the same noise (the port's draws replaced by JAX's: fold_in(step key, 0)
and (.., 1), models/common.py:327-341 there; with (b) the noise pool's
images copied and its slot drawn from the JAX key) and the same pool
decisions: the pools hold one image (--pool_size 1), so the second pool2
query of a step meets a full pool, and each decision is drawn from the JAX
query's key (models/pools.py pool_query there) and staged as the port's
rows.  No dropout (--no_dropout2).  Case (b)'s noise pool holds 3 draws:
with 5, JAX's f32 step puts G2's gradient 0.65% of its largest entry off a
float64 replay of the port's step, which the port's f32 step matches to
1e-5, and with 3 and 7 JAX's matches too: conditioning of that one draw,
as test_torch_train_step.py describes, not a difference of semantics.  Tolerances as there: the metrics 1e-5;
every gradient before Adam 1e-4 of the tensor's largest entry, plus 1e-7;
every parameter after Adam 1e-6, plus 2 lr where |g| is below the gradient
tolerance.

Also: a save -> --continue_train -> step round trip with the noise pool
and the two-query pool2 equal to two straight steps.  The helpers serve
tests/test_torch_twostage.py too.
"""

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
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.models.pools import decide
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, one_thread  # noqa: F401
from test_torch_train_step import FLAGS, LR

PAIRS = ['--GAN_losses_D2', 'real_fake', 'fake_fake',
         '--GAN_losses_G2', 'real_fake', 'fake_fake']
CASES = {'multi_class_fixed_noise_detach_y': [
    '--use_multi_class_GAN', '--GAN_losses_G2', 'real_fake', 'fake_fake',
    '--detach_G1_from_G2_y', '--use_fixed_noise1', '--noise_pool_size', '3'],
    'fake_fake_no_cgan': PAIRS + ['--no_cgan']}


def _batch(seed=0):
    return {'A': np.random.RandomState(seed).uniform(
        -1, 1, (1, 128, 128, 3)).astype(np.float32), 'A_paths': ['x.png']}


def _numpy_init(layer, key):
    """Stands in for the JAX package's jit_init, whose values the test
    replaces (it runs eagerly on the CPU, an XLA compile per op)."""
    return jax_params(layer, 0)


def port_modules(model):
    """[(label, bank index or None, port module)] of every network."""
    out = []
    for label, net in model.nets().items():
        if isinstance(net, torch.nn.ModuleList):
            out += [(label, str(i), d) for i, d in enumerate(net)]
        else:
            out.append((label, None, net))
    return out


def _sub(tree, label, index):
    return tree[label] if index is None else tree[label][index]


def _jax_rows(tm, key, batch_size):
    """The port's pool rows of one step (its pool_queries order) from the
    JAX step's draws: the noise pool's slots from fold_in(key, 0), D1's
    query from fold_in(key, 3), D2's from the two halves of
    split(fold_in(key, 4)) (real_fake or class 1 the first, fake_fake or
    class 2 the second); per image split(key, batch) then (uniform, slot)
    of split(image key)."""
    k = lambda i: jax.random.fold_in(key, i)      # noqa: E731
    d2_keys = jax.random.split(k(4))
    d2 = iter(tm.d2_pairs())
    rows = []
    for name in tm.pool_queries():
        pool = tm.pools[name]
        size = None if pool is None else pool['images'].shape[0]
        if name == 'noise1':
            rows += [(int(s), 0, 1) for s in jax.random.randint(
                k(0), (batch_size,), 0, size)]
            continue
        qkey = k(3) if name == 'pool1' else d2_keys[
            0 if next(d2) == 'real_fake' else 1]
        if pool is None:
            continue
        for ik in jax.random.split(qkey, batch_size):
            ku, ks = jax.random.split(ik)
            rows += decide(pool, [(float(jax.random.uniform(ku)),
                                   int(jax.random.randint(ks, (), 0,
                                                          size)))])
    return torch.tensor(rows, dtype=torch.int64).view(1, -1, 3)


def jax_vs_port_step(flags, sample=False):
    """One step of the port and of the JAX package on one parameter set,
    batch and draws; returns {port, jax, metrics, grads, params} (the two
    models, JAX's metrics, gradients as its Adam calls receive them,
    parameters after the step).  With ``sample``, first one test() of each
    on one noise draw: {'samples': (JAX's, the port's)}, each (fake_A,
    fake_B_from_fake_A)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
        params = {}
        for i, label in enumerate(tm.nets()):
            net = getattr(jm, 'net' + label)
            params[label] = (
                {str(j): jax_params(d, 30 + 10 * i + j)
                 for j, d in enumerate(net)} if isinstance(net, list)
                else jax_params(net, 20 + i))
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        for label, index, mod in port_modules(tm):
            mod.load_state_dict(from_jax_params(mod, _sub(params, label,
                                                          index)),
                                strict=True)
        out = {}
        if sample:
            tkey = jm._host_fold(2)             # the key of JAX's test()
            tnoise = iter([nchw(jax.random.normal(jax.random.fold_in(
                tkey, i), s)) for i, s in enumerate(
                    jm._noise_shapes().values())])
            tm.noise = lambda shape: next(tnoise)
            jm.test()
            tm.test()
            out['samples'] = ((jm.fake_A, jm.fake_B_from_fake_A),
                              tm.outputs())
        jm.set_input(_batch())
        tm.set_input(_batch())
        key = jm.next_step_key()
        shapes = jm._noise_shapes()
        draws = []
        if tm.opt.use_fixed_noise1:
            tm.pools['noise1']['images'].copy_(
                nchw(jm.state['pools']['noise1']['images']))
        else:
            draws.append(nchw(jax.random.normal(jax.random.fold_in(key, 0),
                                                shapes['noise1'])))
        draws.append(nchw(jax.random.normal(jax.random.fold_in(key, 1),
                                            shapes['noise2'])))
        noises = iter(draws)
        tm.noise = lambda shape: next(noises)
        rows = _jax_rows(tm, key, tm.opt.batchSize)
        tm.stage_rows = lambda k: rows

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
        assert next(noises, None) is None
        return dict(out, port=tm, jax=jm, metrics=jax.device_get(metrics),
                    grads=jax.device_get(dict(g_g, D1=g_d1, D2=g_d2)),
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


def assert_step_matches(r, metrics_order):
    """The metrics, every gradient and every parameter after Adam of a
    jax_vs_port_step result, at the tolerances above.  A parameter with no
    gradient on the port's side (an inert bias, or a D the loss does not
    reach) has exactly 0 on the JAX side."""
    ours = r['port'].get_current_errors()
    assert list(ours) == list(metrics_order)
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(r['metrics'][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for label, index, mod in port_modules(r['port']):
        g = from_jax_params(mod, _sub(r['grads'], label, index))
        after = from_jax_params(mod, _sub(r['params'], label, index))
        for name, p in mod.named_parameters():
            where = (label, index, name)
            if p.grad is None:
                assert not g[name].abs().max() > 0, where
            else:
                err = float((p.grad - g[name]).abs().max())
                assert err <= 1e-7 + 1e-4 * float(g[name].abs().max()), (
                    where, err)
            gtol = 1e-7 + 1e-4 * float(g[name].abs().max())
            allow = 1e-6 + 2 * LR * (g[name].abs() < gtol).float()
            assert torch.all((p.detach() - after[name]).abs() <= allow), where


def step_flags(ckpt, *extra):
    return (FLAGS + ['--checkpoints_dir', ckpt, '--pool_size', '1',
                     '--no_dropout2'] + list(extra))


@pytest.mark.parametrize('case', list(CASES))
def test_step_matches_jax(tmp_path, case):
    r = jax_vs_port_step(step_flags(str(tmp_path), *CASES[case]))
    assert_step_matches(r, ('G2_GAN', 'G2_real_cycle', 'G2_fake_cycle',
                            'D2', 'G1_GAN', 'D1'))
    pools = r['port'].pools
    if case == 'multi_class_fixed_noise_detach_y':
        assert pools['pool2_1']['num'] == pools['pool2_2']['num'] == 1
        assert 'pool2' not in pools
        assert r['port'].netD2[0].model[-2].weight.shape[0] == 3
    else:
        assert pools['pool2']['num'] == 1
        assert pools['pool2']['images'].shape[1] == 1


def _flags_rt(ckpt, *extra):
    return (FLAGS + PAIRS + ['--checkpoints_dir', ckpt, '--pool_size', '2',
                             '--use_fixed_noise1', '--noise_pool_size', '3',
                             '--gpu_ids', '-1'] + list(extra))


def test_continue_train_with_noise_pool_and_two_queries(tmp_path):
    """Pools and dropout on: two straight steps against one step, a save, a
    --continue_train model and its step, bitwise."""
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
    for (_, _, a), (_, _, b) in zip(port_modules(straight),
                                    port_modules(resumed)):
        for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                      b.named_parameters()):
            assert na == nb and torch.equal(pa, pb), na
    for name in ('pool1', 'pool2', 'noise1'):
        assert torch.equal(straight.pools[name]['images'],
                           resumed.pools[name]['images']), name
    assert straight.pools['pool2']['num'] == resumed.pools['pool2']['num'] == 2
    assert resumed.pool_queries() == ['noise1', 'pool1', 'pool2', 'pool2']
