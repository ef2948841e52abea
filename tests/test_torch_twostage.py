"""--model twostage (DSGAN without F2) and --model twostage_factd (its
factorized D2) of the port against the JAX package's, on the CPU at 128 px
with the narrow widths of tests/test_torch_train_step.py, both with the
real_fake and fake_fake pairs, --pool_size 1, no dropout: one f32 train
step (tests/test_torch_twostage_flags.py jax_vs_port_step: one parameter
set, batch, noise and pool decisions; its tolerances), one sample on one
noise draw before it (1e-4, as the DSGAN sampler's tests), and the .pth
files the port writes, loaded into the JAX package's networks by its
utils/pth.py.  The D banks here pair each D1 with a D2 whose map is two
pixels larger (28 -> 30 at scale 1, 12 -> 14 at scale 2, D1's maps
upsampled), so factd's products pad.

Also mul_padded against the JAX package's (models/common.py:104 there) at
an even and an odd split and at equal sizes, exactly; and each recipe
through the train entry point (one --steps_per_dispatch chunk of 2 steps)
and the sampler's, --gpu_ids -1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.models.common import mul_padded as jmul_padded
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch import train as ttrain
from supervised_gan_tpu_torch.models.common import mul_padded
from supervised_gan_tpu_torch.options import TestOptions as TTestOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import nchw, nhwc
from test_torch_train_driver import _args, dataroot  # noqa: F401
from test_torch_twostage_flags import (PAIRS, assert_step_matches,
                                       jax_vs_port_step, port_modules,
                                       step_flags)
from test_torch_twostage_flags import one_thread  # noqa: F401

BANKS = ['--n_layers_D1', '2', '2', '--n_layers_D2', '2', '2']


@pytest.fixture(scope='module', params=['twostage', 'twostage_factd'])
def run(request, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp(request.param))
    return jax_vs_port_step(step_flags(ckpt, '--model', request.param,
                                       *(PAIRS + BANKS)), sample=True)


def test_step_matches_jax(run):
    assert_step_matches(run, ('G2_GAN', 'D2', 'G1_GAN', 'D1'))
    assert run['port'].pools['pool2']['num'] == 1


def test_sample_matches_jax(run):
    for ref, ours in zip(*run['samples']):
        np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_port_pth_loads_in_jax(run):
    tm, jm = run['port'], run['jax']
    tm.save('latest')
    for label, index, mod in port_modules(tm):
        name = label if index is None else '%s_%s' % (label, index)
        jnet = getattr(jm, 'net' + label)
        jnet = jnet if index is None else jnet[int(index)]
        params = jpth.load_pth(os.path.join(tm.save_dir,
                                            'latest_net_%s.pth' % name),
                               jnet)
        ref = from_jax_params(mod, params)
        for n, p in mod.named_parameters():
            assert torch.equal(p.detach(), ref[n]), (name, n)


@pytest.mark.parametrize('sizes', [((6, 8), (10, 12)), ((5, 6), (8, 11)),
                                   ((7, 9), (7, 9))],
                         ids=['even', 'odd', 'equal'])
def test_mul_padded_matches_jax(sizes):
    (h1, w1), (h2, w2) = sizes
    rng = np.random.RandomState(h1 + w2)
    a = rng.standard_normal((2, h1, w1, 3)).astype(np.float32)
    b = rng.standard_normal((2, h2, w2, 3)).astype(np.float32)
    ref = np.asarray(jmul_padded(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(nhwc(mul_padded(nchw(a), nchw(b))), ref)


def _sampler_args(args):
    """``args`` without the flags the sampler does not take (each with its
    values)."""
    opts = TTestOptions()
    opts.initialize()
    known = {a for act in opts.parser._actions for a in act.option_strings}
    out, keep = [], True
    for a in args:
        if a.startswith('--'):
            keep = a in known
        if keep:
            out.append(a)
    return out


@pytest.mark.parametrize('model', ['twostage', 'twostage_factd'])
def test_train_and_sample_entry_points(dataroot, tmp_path, model):
    """Two steps as one --steps_per_dispatch chunk through the train entry
    point (finite losses, the checkpoints), then 2 samples from them
    through the sampler's."""
    ckpt = str(tmp_path / 'ckpt')
    args = _args(dataroot, ckpt) + ['--model', model] + PAIRS + BANKS
    args[args.index('--niter_decay') + 1] = '0'
    r = ttrain.main(['--gpu_ids', '-1'] + args + [
        '--steps_per_dispatch', '2', '--print_freq', '2'])
    assert r['steps'] == 2 and r['chunks'] == [2]
    run_dir = os.path.join(ckpt, 'step')
    vals = [l.split(')', 1)[1].split() for l in open(
        os.path.join(run_dir, 'loss_log.txt')) if l.startswith('(epoch')][-1]
    assert vals[::2] == ['G2_GAN:', 'D2:', 'G1_GAN:', 'D1:']
    assert all(np.isfinite(float(v)) for v in vals[1::2])
    nets = ['G1', 'G2', 'D1_0', 'D1_1', 'D2_0', 'D2_1']
    assert {'latest_net_%s.pth' % n for n in nets} <= set(os.listdir(run_dir))
    s = ttest.main(['--gpu_ids', '-1', '--how_many', '2', '--results_dir',
                    str(tmp_path / 'results')] + _sampler_args(args))
    assert s['samples'] == 2 and s['nonfinite'] == 0
    assert sorted(os.listdir(os.path.join(s['web_dir'], 'images'))) == [
        '%04d_%s.png' % (i, v) for i in (1, 2)
        for v in ('fake_A', 'fake_B_fake_A')]
