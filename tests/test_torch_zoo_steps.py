"""Two more paths of the zoo on the CPU against the JAX package, at narrow
widths, each one f32 train step (test_torch_zoo.py assert_step_matches:
metrics within 1e-5 relative, gradients within 1e-4 of each tensor's
largest entry, every parameter after the step within 1e-4 of its largest
entry plus 2 lr per Adam step where the gradient is rounding-sized):

  * Z2, SGAN step 2 with the autoencoder G and the separable D: `--model
    cgan --which_model_netG autoencoder --n_layers_G 5
    --which_model_netD n_layers_sep` on rg_b (the D judges cat(2 label
    channels, 1 image channel)), n_layers_D 3 and 4 at scales 1 1,
    WeightedL1 2 4, --n_update_G 2, ngf / ndf 4, 64 px;
  * Z3, JointGAN with the DCGAN pair: `--model fcgan --which_model_netG
    dcgan --which_model_netD dcgan` on rg_b, 128 px (DCGAN's fixed size)
    from 100 x 1^2 noise, one D (the per-sample score, shape (N,)), BCE,
    ngf / ndf 8.

--pool_size 0 and --no_dropout; the autoencoder ignores the noise, so Z2
needs none of JAX's draws, and Z3 takes JAX's noises as the stage-1 step
does.  In Z2 the port's D bank takes the JAX step's updated D before the G
updates (its own updated D checked first), as chip_smoke.py's card-vs-CPU
steps do: Adam's first step turns a rounding-sized D gradient into +-lr,
and the two D banks that result moved the last G update's gradient by up
to 1.5e-4 of its largest entry; with one D bank the two G updates'
gradients agree within 2e-5.  Then the train and test entry points on Z3
on the CPU, 2 steps, its checkpoints loaded back strictly into both
packages' nets.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch import train as ttrain
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils import pth as tpth
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, one_thread  # noqa: F401
from test_torch_zoo import _numpy_init, assert_step_matches, jax_step
from test_torch_zoo_fcgan_star import check_fcgan_step, fcgan_step_vs_jax

Z2 = ['--dataroot', './datasets/unused', '--name', 'z2',
      '--model', 'cgan', '--which_direction', 'AtoB',
      '--dataset_mode', 'single', '--loadSize', '64', '--fineSize', '64',
      '--batchSize', '1', '--input_nc', '2', '--output_nc', '1',
      '--which_model_netG', 'autoencoder', '--n_layers_G', '5',
      '--ngf', '4', '--which_model_netD', 'n_layers_sep',
      '--n_layers_D', '3', '4', '--ndf', '4', '--scale_factor', '1', '1',
      '--lambda_D', '0.5', '0.5', '--lambda_A', '10', '--noise_nc', '8',
      '--noiseSize', '4', '--norm', 'instance', '--n_update_G', '2',
      '--weight_L1', '2', '4', '--no_lsgan', '--add_gaussian_noise',
      '--which_channel', 'rg_b', '--lr', '0.0002', '--manualSeed', '0',
      '--display_id', '0', '--pool_size', '0', '--no_dropout']
Z3_ARCH = ['--model', 'fcgan', '--which_direction', 'A',
           '--dataset_mode', 'single', '--loadSize', '128',
           '--fineSize', '128', '--batchSize', '1',
           '--which_model_netG', 'dcgan', '--ngf', '8', '--noise_nc', '100',
           '--noiseSize', '1', '--norm', 'instance', '--no_dropout',
           '--which_channel', 'rg_b', '--manualSeed', '0', '--display_id', '0']
Z3_TRAIN = ['--which_model_netD', 'dcgan', '--n_layers_D', '3', '--ndf', '8',
            '--scale_factor', '1', '--lambda_D', '1', '--n_update_G', '2',
            '--no_lsgan', '--lr', '0.0002']
Z3 = ['--dataroot', './datasets/unused', '--name', 'z3'] + Z3_ARCH + Z3_TRAIN


@pytest.fixture(scope='module')
def z2_step(tmp_path_factory):
    flags = Z2 + ['--checkpoints_dir', str(tmp_path_factory.mktemp('z2'))]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('SGAN_TPU_PACK_STATE', '0')
        mp.setattr(sin, '_FMA', False)
        mp.setattr(jnn, 'jit_init', _numpy_init)
        jm = jcreate(JTrainOptions().parse(flags))
        params = {'G': jax_params(jm.netG, 90),
                  'D': {str(i): jax_params(d, 91 + i)
                        for i, d in enumerate(jm.netD)}}
        jm.state = dict(jm.state, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
        assert type(tm.netG).__name__ == 'AutoEncoder'
        assert [type(d).__name__ for d in tm.netD] == [
            'NLayerDiscriminatorSep'] * 2
        tm.netG.load_state_dict(from_jax_params(tm.netG, params['G']),
                                strict=True)
        for i, d in enumerate(tm.netD):
            d.load_state_dict(from_jax_params(d, params['D'][str(i)]),
                              strict=True)
        rng = np.random.RandomState(9)
        a = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
        a[..., :2] = np.sign(a[..., :2])          # binary label channels
        batch = {'A': a, 'A_paths': ['x.png']}
        jm.set_input(batch)
        tm.set_input(batch)
        key = jm.next_step_key()
        new, metrics, (g_d, _, g_g) = jax_step(jm, key, jm.lrs(), mp)
        updated_d = []
        step = tm._step

        def hand_over(optimizer, loss):
            step(optimizer, loss)
            if optimizer is tm.optD:
                updated_d.append(
                    [{n: (p.detach().clone(), None if p.grad is None
                           else p.grad.clone())
                      for n, p in d.named_parameters()} for d in tm.netD])
                with torch.no_grad():
                    for i, d in enumerate(tm.netD):
                        ref = from_jax_params(d, new['params']['D'][str(i)])
                        for n, p in d.named_parameters():
                            p.copy_(ref[n])

        tm._step = hand_over
        tm.optimize_parameters()
        assert len(updated_d) == 1
        return dict(port=tm, metrics=metrics, updated_d=updated_d[0],
                    grads={'G': g_g['G'], 'D': g_d}, params=new['params'])
    finally:
        mp.undo()


@pytest.mark.parametrize('kind', ['metrics', 'G', 'D'])
def test_z2_cgan_autoencoder_sep_step_matches_jax(z2_step, kind):
    m = z2_step['port']
    if kind == 'metrics':
        ours = m.get_current_errors()
        assert list(ours) == ['G_GAN', 'G_L1', 'D_real', 'D_fake']
        for k, v in ours.items():
            np.testing.assert_allclose(v, float(z2_step['metrics'][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    elif kind == 'G':
        assert_step_matches(m.netG, z2_step['grads']['G'],
                            z2_step['params']['G'], 2)
    else:                          # each D as its own update left it
        for i, d in enumerate(m.netD):
            own = z2_step['updated_d'][i]
            with torch.no_grad():
                for n, p in d.named_parameters():
                    p.copy_(own[n][0])
                    p.grad = own[n][1]
            assert_step_matches(d, z2_step['grads']['D'][str(i)],
                                z2_step['params']['D'][str(i)], 1)


@pytest.fixture(scope='module')
def z3_step():
    return fcgan_step_vs_jax(Z3, 100)


@pytest.mark.parametrize('kind', ['metrics', 'G', 'D'])
def test_z3_fcgan_dcgan_step_matches_jax(z3_step, kind):
    check_fcgan_step(z3_step, kind)


def test_z3_d_scores_a_sample(z3_step):
    m = z3_step['port']
    with torch.no_grad():
        outs = m.bank_apply(m.netD, m.input)
    assert len(outs) == 1 and outs[0].shape == (1,)
    assert 0 < float(outs[0][0]) < 1                 # the in-model Sigmoid


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    d = tmp_path_factory.mktemp('z3_data')
    os.makedirs(d / 'train')
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (128, 128, 3)).astype(
            np.uint8)).save(str(d / 'train' / ('%03d.png' % i)))
    return str(d)


def test_z3_train_and_test_clis(dataroot, tmp_path):
    """The train entry point on Z3 for 2 steps, its sampler for 2 samples,
    and each checkpoint loaded back strictly: into the port's nets and into
    the JAX package's (utils/pth.py load_pth, its shape check)."""
    ckpt, results = str(tmp_path / 'ckpt'), str(tmp_path / 'results')
    args = (['--gpu_ids', '-1', '--dataroot', dataroot, '--name', 'z3',
             '--checkpoints_dir', ckpt] + Z3_ARCH)
    r = ttrain.main(args + Z3_TRAIN + [
        '--pool_size', '2', '--niter', '1', '--niter_decay', '0',
        '--print_freq', '1', '--display_freq', '2', '--save_epoch_freq', '1'])
    assert r['steps'] == 2
    run = os.path.join(ckpt, 'z3')
    assert {'latest_net_G.pth', 'latest_net_D_0.pth', '1_net_G.pth',
            'latest_state.pt'} <= set(os.listdir(run))
    nets = {'G': (lambda m: m.define_G(3, 0, 8, 'dcgan', 'instance', False,
                                       noise_nc=100)),
            'D_0': (lambda m: m.define_D(3, 8, 'dcgan', norm='instance'))}
    for label, build in nets.items():
        path = os.path.join(run, 'latest_net_%s.pth' % label)
        net = tpth.load_pth(path, build(tnn))
        assert all(torch.isfinite(p).all() for p in net.parameters())
        jnet = build(jnn)
        loaded = jpth.load_pth(path, jnet)
        assert jnn.count_params(loaded) == tnn.count_params(net)
    r = ttest.main(args + ['--results_dir', results, '--how_many', '2'])
    assert r['samples'] == 2 and r['nonfinite'] == 0
    assert sorted(os.listdir(os.path.join(r['web_dir'], 'images'))) == [
        '%04d_fake_%s.png' % (i, v) for i in (1, 2)
        for v in ('image', 'label')]
