"""The cycle recipes `--model cgan_cycle` and `--model cgan2_cycle` of the
port on the CPU against the JAX package's, and the harness the slice's
other step tests share (tests/test_torch_cgan2.py,
tests/test_torch_segmentation_cycle.py).

Narrow geometry, as tests/test_recipes.py:65-91: unet_128 G1 and G2 at
128 px, ngf 4, a 2-scale D1 bank ndf 4 of n_layers 1 and 2, --pool_size 1,
--no_dropout{,1,2} (the packages draw different dropout masks).  One f32
train step from one numpy-made parameter set on one batch, the port's
draws replaying the JAX step's key schedule (models/common.py
build_gan_train_step there): each recorded forward draws noise1 and noise2
from fold_in(step key, i) and i + 1 and takes fold_in(step key, i + 2) as
its forward key; the n-th generator call of a forward runs on
fold_in(forward key, n), where its injected Gaussian noise draws
fold_in(call key, level); each pool query takes the next key, and each of
its images (uniform, slot) from split(split(query key, batch)[i]).  The
port's own pool decisions (models/base.py stage_rows) take those draws, so
the rejection probability is the port's.  A pool can start full, the same
image in both packages, so the step swaps or rejects.

Tolerances of tests/test_torch_cgan.py: the metrics 1e-5; the gradient
each Adam step received (the last one for the port) 1e-4 of the tensor's
largest entry, plus 1e-7; every parameter after the step 1e-6, plus 2 lr
for each Adam step whose gradient entry was below the gradient tolerance.

Cases: cgan_cycle with --n_update_G 2 (the forward recorded again after
each G update), --weight_L1 2 4 and BCE GAN losses; cgan2_cycle on
unaligned input with --train_D_on_fake_fake_pair, --lambda_fake_cycle 0.5
and a full pool.  Each also writes its .pth files and loads them into the
JAX package's utils/pth.py, and loads the JAX step's parameters, written
by utils/pth.py, with --continue_train (strict).  The recipes' chunked
steps: train_chunk == eager steps, bitwise, for cgan_cycle.

With --add_gaussian_noise the JAX package's f32 step is no reference for
the generators' gradients: at the first step's draws (seed 0 and seed 1
alike) its G2 gradient lands 1-4.5% of the largest entry off the same
forward replayed by the JAX package with the nets in float64, which the
port's f32 gradient matches to 1e-4 (an InstanceNorm over 2x2 planes
magnifies reordered f32 sums, as tests/test_torch_twostage_flags.py found
for one noise draw).  So the noisy cycle's gradient is held against that
float64 replay (test_noisy_cycle_gradient_matches_jax_float64); the
injected noise's forward is tests/test_torch_gen_noise.py's.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.nn import core as jcore
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.models import base as tbase
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, one_thread  # noqa: F401

LR = 2e-4
PX = 128
G_NETS = ['--which_model_netG1', 'unet_128', '--ngf1', '4',
          '--which_model_netG2', 'unet_128', '--ngf2', '4',
          '--no_dropout1', '--no_dropout2']
D1 = ['--which_model_netD1', 'n_layers', '--n_layers_D1', '1', '2',
      '--ndf1', '4', '--scale_factor1', '1', '2', '--lambda_D1', '0.5',
      '0.4']


def flags(ckpt, name, model, mode, *extra):
    return (['--dataroot', './datasets/unused', '--name', name,
             '--model', model, '--dataset_mode', mode,
             '--which_direction', 'AtoB', '--which_channel', 'rg_b',
             '--loadSize', str(PX), '--fineSize', str(PX),
             '--batchSize', '1', '--norm', 'instance', '--manualSeed', '0',
             '--checkpoints_dir', ckpt, '--display_id', '0',
             '--pool_size', '1', '--lr', str(LR), '--lr1', str(LR),
             '--lr2', str(LR), '--no_dropout'] + list(extra))


CASES = {
    'cgan_cycle': ('cgan_cycle', 'single', G_NETS + D1 + [
        '--n_update_G', '2', '--weight_L1', '2', '4', '--no_lsgan1']),
    'cgan2_cycle': ('cgan2_cycle', 'unaligned', G_NETS + D1 + [
        '--train_D_on_fake_fake_pair', '--lambda_fake_cycle', '0.5']),
}


def batch(seed=0, unaligned=False):
    """Binary label channels r, g and an image channel b; with
    ``unaligned`` a B image whose r, g are another label."""
    rng = np.random.RandomState(seed)
    out = {'A_paths': ['a%d.png' % seed]}
    for side in ('AB' if unaligned else 'A'):
        a = rng.uniform(-1, 1, (1, PX, PX, 3)).astype(np.float32)
        a[..., :2] = np.sign(a[..., :2])
        out[side] = a
    if unaligned:
        out['B_paths'] = ['b%d.png' % seed]
    return out


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


def sub(tree, label, index):
    return tree[label] if index is None else tree[label][index]


class JaxKeys:
    """The port's draws replaced by the JAX step's: noises, forward keys,
    generator-call keys and their Gaussian-noise draws, pool draws."""

    def __init__(self, model, key, noise_idx, fkey_idx, pool_idx,
                 fold_calls=True):
        k = lambda i: jax.random.fold_in(key, i)      # noqa: E731
        self.noise_keys = iter([k(i) for i in noise_idx])
        self.fkeys = iter([k(i) for i in fkey_idx])
        self.pool_keys = iter([k(i) for i in pool_idx])
        self.fold_calls = fold_calls
        self.fkey = self.call = None
        model.noise = self.noise
        rec = model._record
        model._record = lambda *a: (self.next_forward(), rec(*a))[1]
        for label, net in model.nets().items():
            if isinstance(net, torch.nn.ModuleList):
                continue
            net.register_forward_pre_hook(lambda *a: self.next_call())
            for m in net.modules():
                if isinstance(m, tnn.GaussianNoise):
                    m.draw = self.gauss

    def noise(self, shape):
        b, c, h, w = shape
        return nchw(jax.random.normal(next(self.noise_keys), (b, h, w, c)))

    def next_forward(self, fkey=None):
        self.fkey = next(self.fkeys) if fkey is None else fkey
        self.calls = itertools.count()

    def next_call(self):
        self.call = (jax.random.fold_in(self.fkey, next(self.calls))
                     if self.fold_calls else self.fkey)
        self.level = itertools.count()

    def gauss(self, shape, dtype, device):
        z = jax.random.normal(jax.random.fold_in(self.call, next(self.level)),
                              (shape[0], shape[2], shape[3], shape[1]))
        return nchw(z).to(dtype=dtype, device=device)

    def draw_decisions(self, pool, n, generator):
        size = pool['images'].shape[0]
        out = []
        for ik in jax.random.split(next(self.pool_keys), n):
            ku, ks = jax.random.split(ik)
            out.append((float(jax.random.uniform(ku)),
                        int(jax.random.randint(ks, (), 0, size))))
        return out

    def done(self):
        return all(next(it, None) is None
                   for it in (self.noise_keys, self.fkeys, self.pool_keys))


def jax_vs_port_step(flags_, batch_, schedule, updates, full_pools=(),
                     before=None, jax_flags=()):
    """One step of each package on one parameter set, batch and key
    schedule ({'noise', 'fkey', 'pool'}: fold_in indices of the step key,
    in draw order).  ``updates``: the label of each Adam step in order (a
    D bank's, or None for the G optimizer's, whose gradients are keyed by
    net).  ``full_pools``: pools that start full of one random image.
    ``before(jax model, port model)`` runs on the loaded models and batch
    before the step; ``jax_flags`` are the JAX model's only.  Returns
    {port, jax, init, metrics, grads (label -> [one a step]), params}."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        # the JAX model init sets it from --no_pallas: restored on exit
        mp.setattr(jcore, 'PALLAS_ENABLED', jcore.PALLAS_ENABLED)
        jm = jcreate(JTrainOptions().parse(flags_ + list(jax_flags)))
        tm = tcreate(TTrainOptions().parse(flags_ + ['--gpu_ids', '-1']))
        params = {}
        for i, label in enumerate(tm.nets()):
            net = getattr(jm, 'net' + label)
            params[label] = (
                {str(j): jax_params(d, 30 + 10 * i + j)
                 for j, d in enumerate(net)} if isinstance(net, list)
                else jax_params(net, 20 + i))
        jstate = dict(jm.state, params=jax.tree_util.tree_map(jnp.asarray,
                                                               params))
        for label, index, mod in port_modules(tm):
            mod.load_state_dict(from_jax_params(mod, sub(params, label,
                                                         index)),
                                strict=True)
        for n, name in enumerate(full_pools):
            img = np.random.RandomState(90 + n).uniform(
                -1, 1, jstate['pools'][name]['images'].shape).astype(
                    np.float32)
            jstate['pools'] = dict(jstate['pools'], **{name: {
                'images': jnp.asarray(img),
                'num': jnp.asarray(img.shape[0], jnp.int32)}})
            tm.pools[name]['images'].copy_(nchw(img))
            tm.pools[name]['num'] = img.shape[0]
        jm.state = jstate
        jm.set_input(batch_)
        tm.set_input(batch_)
        if before is not None:
            before(jm, tm)
        key = jm.next_step_key()
        keys = JaxKeys(tm, key, schedule['noise'], schedule['fkey'],
                       schedule['pool'])
        mp.setattr(tbase, 'draw_decisions', keys.draw_decisions)

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

        new, metrics, caps = jax.jit(step_with_grads)(
            jm.state, jm._step_inputs(), key, jm._step_lrs())
        tm.optimize_parameters()
        assert keys.done()
        grads = {}
        for label, g in zip(updates, jax.device_get(caps), strict=True):
            for lab, tree in ({label: g} if label else g).items():
                grads.setdefault(lab, []).append(tree)
        return dict(port=tm, jax=jm, init=params,
                    metrics=jax.device_get(metrics), grads=grads,
                    params=jax.device_get(new['params']))
    finally:
        mp.undo()


def assert_step_matches(r):
    """The metrics (in the recipe's order), gradients and parameters after
    the step of a jax_vs_port_step result, at the tolerances above.  A
    parameter with no gradient on the port's side (an inert bias) has
    exactly 0 on the JAX side."""
    tm = r['port']
    ours = tm.get_current_errors()
    assert list(ours) == list(tm.METRICS_ORDER)
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(r['metrics'][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for label, index, mod in port_modules(tm):
        steps = [from_jax_params(mod, g if index is None else g[index])
                 for g in r['grads'][label]]
        after = from_jax_params(mod, sub(r['params'], label, index))
        for name, p in mod.named_parameters():
            where = (label, index, name)
            g = steps[-1][name]
            if p.grad is None:
                assert not g.abs().max() > 0, where
            else:
                err = float((p.grad - g).abs().max())
                assert err <= 1e-7 + 1e-4 * float(g.abs().max()), (where,
                                                                    err)
            allow = 1e-6
            for s in steps:
                gtol = 1e-7 + 1e-4 * float(s[name].abs().max())
                allow = allow + 2 * LR * (s[name].abs() < gtol).float()
            assert torch.all((p.detach() - after[name]).abs() <= allow), where


def assert_pth_both_ways(r, tmp_path, flags_):
    """The port's .pth files load into the JAX nets (utils/pth.py) equal to
    the port's parameters; the JAX step's parameters, written by
    utils/pth.py, load into the port's nets with --continue_train."""
    tm, jm = r['port'], r['jax']
    tm.save('latest')
    jdir = os.path.join(str(tmp_path), 'jx')
    os.makedirs(jdir)
    for label, index, mod in port_modules(tm):
        name = label if index is None else '%s_%s' % (label, index)
        jnet = getattr(jm, 'net' + label)
        jnet = jnet if index is None else jnet[int(index)]
        loaded = jpth.load_pth(os.path.join(tm.save_dir, 'latest_net_%s.pth'
                                            % name), jnet)
        ref = from_jax_params(mod, loaded)
        for n, p in mod.named_parameters():
            assert torch.equal(p.detach(), ref[n]), (name, n)
        jpth.save_pth(os.path.join(jdir, 'jx_net_%s.pth' % name), jnet,
                      sub(r['params'], label, index))
    back = tcreate(TTrainOptions().parse(
        flags_ + ['--gpu_ids', '-1', '--continue_train', '--which_epoch',
                  'jx', '--checkpoints_dir', str(tmp_path), '--name',
                  'jx']))
    for label, index, mod in port_modules(back):
        ref = from_jax_params(mod, sub(r['params'], label, index))
        for n, p in mod.named_parameters():
            assert torch.equal(p.detach(), ref[n]), (label, index, n)


@pytest.mark.parametrize('case', list(CASES))
def test_step_matches_jax(tmp_path, case):
    model, mode, extra = CASES[case]
    f = flags(str(tmp_path), case, model, mode, *extra)
    if case == 'cgan_cycle':
        # noises, forward key; D1's pool; the redraw after each G update
        schedule = {'noise': [0, 1, 4, 5, 7, 8], 'fkey': [2, 6, 9],
                    'pool': [3]}
        r = jax_vs_port_step(f, batch(), schedule, ['D1', None, None])
        assert set(r['port']._taps) == {'fake_B', 'fake_A', 'recon_A'}
    else:
        schedule = {'noise': [0, 1], 'fkey': [2], 'pool': [3]}
        r = jax_vs_port_step(f, batch(unaligned=True), schedule,
                             ['D1', None], full_pools=['pool1'])
        assert r['port'].pools['pool1']['num'] == 1
    assert_step_matches(r)
    assert_pth_both_ways(r, tmp_path, f)


def _rt_flags(ckpt, *extra):
    return flags(ckpt, 'rt', 'cgan_cycle', 'single', *(
        G_NETS + D1 + ['--add_gaussian_noise', '--pool_size', '2']
        + list(extra)))


def test_continue_train_and_chunk_equal_straight_steps(tmp_path):
    """Pools and the injected noise on: two straight steps, one step + save
    + --continue_train + one step, and a chunk of two steps are equal,
    bitwise; the lr decay is TwoGroupModel's, clamped and three-rate."""
    straight = tcreate(TTrainOptions().parse(
        _rt_flags(str(tmp_path / 'a')) + ['--gpu_ids', '-1']))
    for s in (0, 1):
        straight.set_input(batch(s))
        straight.optimize_parameters()

    first = tcreate(TTrainOptions().parse(
        _rt_flags(str(tmp_path / 'b')) + ['--gpu_ids', '-1']))
    first.set_input(batch(0))
    first.optimize_parameters()
    first.save('latest')
    resumed = tcreate(TTrainOptions().parse(
        _rt_flags(str(tmp_path / 'b'), '--continue_train')
        + ['--gpu_ids', '-1']))
    resumed.set_input(batch(1))
    resumed.optimize_parameters()

    chunked = tcreate(TTrainOptions().parse(
        _rt_flags(str(tmp_path / 'c')) + ['--gpu_ids', '-1']))
    chunked.train_chunk([batch(0), batch(1)])

    for other in (resumed, chunked):
        assert other.get_current_errors() == straight.get_current_errors()
        for (_, _, a), (_, _, b) in zip(port_modules(straight),
                                        port_modules(other)):
            for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                          b.named_parameters()):
                assert na == nb and torch.equal(pa, pb), na
        assert torch.equal(straight.pools['pool1']['images'],
                           other.pools['pool1']['images'])
    assert resumed.pools['pool1']['num'] == 2

    m = tcreate(TTrainOptions().parse(
        _rt_flags(str(tmp_path / 'd'), '--niter_decay', '1', '--lr2',
                  '1e-4') + ['--gpu_ids', '-1']))
    m.update_learning_rate()
    m.update_learning_rate()
    assert (m.old_lr, m.old_lr1, m.old_lr2) == (0, 0, 0)
    assert [g['lr'] for g in m.optG.param_groups] == [0, 0]


def test_noisy_cycle_gradient_matches_jax_float64():
    """G1 and G2 (unet_128, ngf 4, --add_gaussian_noise) on the cgan_cycle
    step's forward keys, the BCE and cycle terms of its G loss: the port's
    f32 gradients against the JAX package's nets run in float64 (its BCE
    computes in f32), the same float64 noise draws fed to both (cast to
    f32 on the port's side), 1e-4 of each tensor's largest entry."""
    from supervised_gan_tpu.nn.losses import bce_loss as jbce
    from supervised_gan_tpu.utils.prng import fold_in as np_fold_in
    from supervised_gan_tpu_torch.nn.losses import bce_loss as tbce
    nets = [((2, 1), 20), ((1, 2), 21)]
    j = [jnn.define_G(i, o, 4, 'unet_128', 'instance', False,
                      add_gaussian_noise=True) for (i, o), _ in nets]
    t = [tnn.define_G(i, o, 4, 'unet_128', 'instance', False,
                      add_gaussian_noise=True) for (i, o), _ in nets]
    params = [jax_params(n, seed) for n, (_, seed) in zip(j, nets)]
    for net, p in zip(t, params):
        net.load_state_dict(from_jax_params(net, p), strict=True)
    b = batch()
    a, bb = b['A'][..., :2], b['A'][..., 2:]
    key = np_fold_in(np.asarray(jax.random.PRNGKey(0)), 3)   # step 1's key
    fk = [jax.random.fold_in(jax.random.fold_in(key, 2), i)
          for i in range(3)]

    def loss(pp):
        f64 = jnp.float64
        fake_b = j[0].apply(pp[0], jnp.asarray(a, f64), jnn.Ctx(fk[0]))
        fake_a = j[1].apply(pp[1], jnp.asarray(bb, f64), jnn.Ctx(fk[1]))
        recon = j[1].apply(pp[1], fake_b, jnn.Ctx(fk[2]))
        ta = (jnp.asarray(a, f64) + 1) / 2
        return (jbce((fake_a + 1) / 2, ta) * 10
                + jbce((recon + 1) / 2, ta) * 10)

    call = {}

    def draw(shape, dtype, device):
        # the JAX nets draw their noise in float64 (GaussianNoise there
        # draws in y's dtype)
        z = jax.random.normal(jax.random.fold_in(call['key'],
                                                 next(call['level'])),
                              (shape[0], shape[2], shape[3], shape[1]),
                              jnp.float64)
        return nchw(np.array(z))

    def run(net, x, i):
        call['key'], call['level'] = fk[i], itertools.count()
        return net(x)

    for net in t:
        for m in net.modules():
            if isinstance(m, tnn.GaussianNoise):
                m.draw = draw
    mp = pytest.MonkeyPatch()
    jax.config.update('jax_enable_x64', True)
    try:
        mp.setattr(sin, '_FMA', False)
        grads = jax.device_get(jax.jit(jax.grad(loss))(
            jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                   params)))
        fake_b = run(t[0], nchw(a), 0)
        fake_a = run(t[1], nchw(bb), 1)
        recon = run(t[1], fake_b, 2)
    finally:
        jax.config.update('jax_enable_x64', False)
        mp.undo()
    ta = (nchw(a) + 1) / 2
    (tbce((fake_a + 1) / 2, ta) * 10 + tbce((recon + 1) / 2, ta) * 10
     ).backward()
    for net, g in zip(t, grads):
        ref = from_jax_params(net, g)
        for name, p in net.named_parameters():
            if p.grad is None:          # an inert bias
                assert not ref[name].abs().max() > 0, name
                continue
            err = float((p.grad - ref[name]).abs().max())
            assert err <= 1e-7 + 1e-4 * float(ref[name].abs().max()), (
                name, err)
