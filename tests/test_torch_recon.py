"""fcgan latent inversion (models/fcgan.py reconstruction), interpolation
and the recon entry point of the port against the JAX package's, on the
CPU at the 32 px config of tests/test_torch_fcgan.py (--no_dropout).

The JAX package minimizes with optax.lbfgs and its zoom line search, the
port with torch.optim.LBFGS and a strong-Wolfe one: two correct L-BFGS on
this nonconvex objective reach different local minima, so the port is held
to the optimizer's contract, not step for step: the objective and its
gradient at one noise equal JAX's (jax.value_and_grad of its objective,
1e-5); the trials start from JAX's draws (fold_in(master key, 200 +
trial)); the negative log-likelihoods are JAX's float64 formula, exactly;
the best fit is no worse than its start (err <= err(z0) + 1e-5, as JAX's
tests/test_utils_extra.py asserts); and on a strictly convex quadratic in a
noise-shaped z, lbfgs_minimize reaches optax.lbfgs's minimizer within 1e-5.
interpolate(0) and (1) are G at the two kept noises, and interpolate(0.5)
equals JAX's (1e-5).  The entry point, 32 px, --gpu_ids -1: its page and
its last line.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.nn.losses import bce_loss as jbce_loss
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch import recon as trecon
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.models.fcgan import (RECON_TRIALS,
                                                   lbfgs_minimize)
from supervised_gan_tpu_torch.nn.losses import bce_loss
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_fcgan import ARCH, TRAIN
from test_torch_layout import jax_params, nchw, nhwc
from test_torch_twostage_flags import one_thread  # noqa: F401

FLAGS = (['--dataroot', './datasets/unused', '--name', 'rc', '--no_dropout']
         + ARCH + TRAIN)


def _batch(seed=0):
    return {'A': np.random.RandomState(seed).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32), 'A_paths': ['x.png']}


def _nll(z, dim):
    """fcgan.py's nll there: float64 on the host."""
    z = np.asarray(z, np.float64).ravel()
    return 0.5 * (z @ z) + 0.5 * dim * np.log(2 * np.pi)


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """The JAX and the port fcgan on one G (numpy-made) and one batch."""
    flags = FLAGS + ['--checkpoints_dir', str(tmp_path_factory.mktemp('rc'))]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jnn, 'jit_init', lambda layer, key: jax_params(layer, 0))
        jm = jcreate(JTrainOptions().parse(flags))
    finally:
        mp.undo()
    params = jax_params(jm.netG, 60)
    jm.state = dict(jm.state, params=dict(jm.state['params'],
                                          G=jax.tree_util.tree_map(
                                              jnp.asarray, params)))
    tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
    tm.netG.load_state_dict(from_jax_params(tm.netG, params), strict=True)
    jm.set_input(_batch())
    tm.set_input(_batch())
    return jm, tm


def _jax_objective(jm):
    """The objective of JAX's reconstruction (fcgan.py:289-291 there)."""
    label = (jm.input + 1) / 2.0
    G = jm.state['params']['G']
    fkey = jax.random.fold_in(jm.master_key, 98)
    return lambda noise: jbce_loss((jm._g_fwd_raw(G, noise, fkey) + 1) / 2.0,
                                   label)


def test_objective_and_gradient_match_jax(models):
    jm, tm = models
    z = np.random.RandomState(3).standard_normal(
        jm._noise_shape()).astype(np.float32)
    value, grad = jax.jit(jax.value_and_grad(_jax_objective(jm)))(
        jnp.asarray(z))
    zt = nchw(z).requires_grad_(True)
    ours = tm.recon_objective(zt, tm.input)
    ours.backward()
    np.testing.assert_allclose(float(ours), float(value), rtol=1e-5)
    g = np.asarray(grad)
    assert np.abs(nhwc(zt.grad) - g).max() <= 1e-5 * np.abs(g).max()


def test_reconstruction_from_jax_draws(models):
    """The trials start at JAX's draws; the log-likelihoods are its float64
    formula exactly; the best fit is no worse than its start."""
    jm, tm = models
    shape = jm._noise_shape()
    draws = [np.asarray(jax.random.normal(
        jax.random.fold_in(jm.master_key, 200 + t), shape))
        for t in range(RECON_TRIALS)]
    asked = []

    def draw(trial):
        asked.append(trial)
        return nchw(draws[trial])

    tm.draw_recon_noise = draw
    try:
        err, ll, ll_init = tm.reconstruction()
    finally:
        del tm.draw_recon_noise
    assert asked == list(range(RECON_TRIALS))
    dim = int(np.prod(shape[1:]))
    assert ll == _nll(nhwc(tm.last_noise), dim)
    assert ll_init in [_nll(d, dim) for d in draws]
    assert np.isfinite(err) and tm.fake.shape == (1, 3, 32, 32)
    with torch.no_grad():
        init_err = float(bce_loss((tm.fake_init + 1) / 2, (tm.real + 1) / 2))
        refit = float(tm.recon_objective(tm.last_noise, tm.real))
    assert err == refit
    assert err <= init_err + 1e-5
    assert all(p.requires_grad for p in tm.netG.parameters())


def test_lbfgs_reaches_optax_minimizer_on_a_convex_quadratic():
    rng = np.random.RandomState(4)
    shape = (1, 4, 2, 2)
    n = int(np.prod(shape))
    q = rng.standard_normal((n, n))
    a = (q.T @ q / n + np.eye(n)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    z0 = rng.standard_normal(shape).astype(np.float32)

    def f_jax(z):
        d = z.ravel() - c
        return 0.5 * d @ (jnp.asarray(a) @ d)

    solver = optax.lbfgs()

    @jax.jit
    def update(z, state):
        value, grad = jax.value_and_grad(f_jax)(z)
        updates, state = solver.update(grad, state, z, value=value,
                                       grad=grad, value_fn=f_jax)
        return optax.apply_updates(z, updates), state

    z, state = jnp.asarray(z0), solver.init(jnp.asarray(z0))
    for _ in range(50):
        z, state = update(z, state)
    at, ct = torch.from_numpy(a), torch.from_numpy(c)

    def f_torch(z):
        d = z.reshape(-1) - ct
        return 0.5 * d @ (at @ d)

    ours = lbfgs_minimize(f_torch, torch.from_numpy(z0))
    assert np.abs(ours.numpy() - np.asarray(z)).max() <= 1e-5


def test_interpolate_matches_jax(models):
    jm, tm = models
    a, b = (np.random.RandomState(s).standard_normal(
        jm._noise_shape()).astype(np.float32) for s in (5, 6))
    for which, z in (('A', a), ('B', b)):
        jm.noise, tm.last_noise = jnp.asarray(z), nchw(z)
        jm.set_fixed_noise(which)
        tm.set_fixed_noise(which)
    for alpha, z in ((0, a), (1, b)):
        tm.interpolate(alpha)
        with torch.no_grad():
            assert torch.equal(tm.fake, tm._generate(nchw(z)))
    jm.interpolate(0.5)
    tm.interpolate(0.5)
    np.testing.assert_allclose(nhwc(tm.fake), np.asarray(jm.fake), rtol=1e-5,
                               atol=1e-5)
    assert tm.real is tm.input


def test_recon_entry_point(tmp_path, capsys):
    data = tmp_path / 'data' / 'test'
    os.makedirs(data)
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3)).astype(
            np.uint8)).save(str(data / ('%03d.png' % i)))
    args = (['--gpu_ids', '-1', '--dataroot', str(tmp_path / 'data'),
             '--name', 'rc', '--checkpoints_dir', str(tmp_path / 'ckpt')]
            + ARCH + ['--no_dropout'])
    m = tcreate(TTrainOptions().parse(args + TRAIN))
    m.save_network(m.netG, 'G', 'latest')
    capsys.readouterr()
    r = trecon.main(args + ['--how_many', '1', '--results_dir',
                            str(tmp_path / 'results')])
    out = capsys.readouterr().out
    assert r['images'] == 1 and len(r['seconds']) == 1
    assert os.path.exists(os.path.join(r['web_dir'], 'index.html'))
    assert sorted(os.listdir(os.path.join(r['web_dir'], 'images'))) == [
        '000_%s.png' % v for v in ('fake_image', 'fake_label', 'real_image',
                                   'real_label')]
    last = out.strip().splitlines()[-1]
    num = r'(-?\d+\.\d{4})'
    match = re.fullmatch(
        'BCE: mean %s std %s; noise: mean %s std %s; noise init: mean %s '
        'std %s' % ((num,) * 6), last)
    assert match, last
    assert float(match.group(1)) == pytest.approx(r['bce'][0], abs=1e-4)
    assert float(match.group(5)) == pytest.approx(r['nll_init'][0], abs=1e-4)
