"""The stage-1 label GAN with the factorized generator, `--model fcgan
--which_model_netG fcgan_star`, of the port on the CPU against the JAX
package's: the README stage-1 command's structure (rg, G 5 layers from 2 x
4 noise channels, a 3-scale D bank of n_layers 3 at scales 1, 2, 4, BCE,
--n_update_G 2) at ngf / ndf 4 and 128 px (noiseSize 2).

One f32 train step, as tests/test_torch_fcgan.py holds the stage-1 step:
one numpy-made parameter set on both sides (from_jax_params), the same
batch, JAX's noises (fold_in(step key, 0), 3 and 5), --pool_size 0 and
--no_dropout.  Compared (test_torch_zoo.py assert_step_matches): the three
metrics within 1e-5 relative, the D update's and the last G update's
gradients within 1e-4 of each tensor's largest entry, and every parameter
after the step within 1e-4 of its largest entry (plus 2 lr per Adam step
where the gradient is rounding-sized).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, one_thread  # noqa: F401
from test_torch_zoo import _numpy_init, assert_step_matches, jax_step

FLAGS = ['--dataroot', './datasets/unused', '--name', 'z1',
         '--model', 'fcgan', '--which_direction', 'A',
         '--dataset_mode', 'single', '--loadSize', '128',
         '--fineSize', '128', '--batchSize', '1', '--input_nc', '2',
         '--which_model_netG', 'fcgan_star', '--n_layers_G', '5',
         '--ngf', '4', '--which_model_netD', 'n_layers',
         '--n_layers_D', '3', '3', '3', '--ndf', '4',
         '--scale_factor', '1', '2', '4', '--lambda_D', '0.5', '0.4', '0.1',
         '--noise_nc', '8', '--noiseSize', '2', '--norm', 'instance',
         '--no_dropout', '--n_update_G', '2', '--no_lsgan',
         '--which_channel', 'rg', '--lr', '0.0002', '--manualSeed', '0',
         '--display_id', '0', '--pool_size', '0']


def fcgan_step_vs_jax(flags, seed):
    """One f32 step of a --model fcgan command on both packages from one
    parameter set (``seed``: G's, then one per D) and JAX's noises:
    {port model, JAX metrics, gradients, parameters after the step}."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        params = {'G': jax_params(jm.netG, seed),
                  'D': {str(i): jax_params(d, seed + 1 + i)
                        for i, d in enumerate(jm.netD)}}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
        tm.netG.load_state_dict(from_jax_params(tm.netG, params['G']),
                                strict=True)
        for i, d in enumerate(tm.netD):
            d.load_state_dict(from_jax_params(d, params['D'][str(i)]),
                              strict=True)
        px = jm.opt.fineSize
        batch = {'A': np.random.RandomState(seed).uniform(
            -1, 1, (1, px, px, 3)).astype(np.float32), 'A_paths': ['x.png']}
        jm.set_input(batch)
        tm.set_input(batch)
        key = jm.next_step_key()
        shape = jm._noise_shape()
        noises = iter([nchw(jax.random.normal(jax.random.fold_in(key, i),
                                              shape)) for i in (0, 3, 5)])
        tm.draw_noise = lambda: next(noises)
        new, metrics, (g_d, _, g_g) = jax_step(jm, key, jm.old_lr, mp)
        tm.optimize_parameters()
        assert next(noises, None) is None      # all three noises drawn
        return dict(port=tm, metrics=metrics, grads={'G': g_g, 'D': g_d},
                    params=new['params'])
    finally:
        mp.undo()


def check_fcgan_step(step, kind):
    m = step['port']
    if kind == 'metrics':
        ours = m.get_current_errors()
        assert list(ours) == ['G_GAN', 'D_real', 'D_fake']
        for k, v in ours.items():
            np.testing.assert_allclose(v, float(step['metrics'][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    elif kind == 'G':                  # two Adam steps (--n_update_G 2)
        assert_step_matches(m.netG, step['grads']['G'], step['params']['G'],
                            2)
    else:                              # each D one
        for i, d in enumerate(m.netD):
            assert_step_matches(d, step['grads']['D'][str(i)],
                                step['params']['D'][str(i)], 1)


@pytest.fixture(scope='module')
def step():
    return fcgan_step_vs_jax(FLAGS, 80)


@pytest.mark.parametrize('kind', ['metrics', 'G', 'D'])
def test_fcgan_star_step_matches_jax(step, kind):
    check_fcgan_step(step, kind)


def test_fcgan_star_noise_halves(step):
    """The first half of the noise channels feeds tower b (the image), the
    second tower a (the label): the label channel is tower a's alone, on
    the second half."""
    g = step['port'].netG
    z = torch.randn(1, 8, 2, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = g(z)
        a = g.conv5a(g.conv4a(g.conv3a(g.conv2a(g.conv1a(g.conv0a(
            z[:, 4:]))))))
    assert torch.allclose(y[:, :1], torch.tanh(a), atol=1e-6)
    assert y.shape == (1, 2, 128, 128)
