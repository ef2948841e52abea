"""`--model segmentation_cycle` of the port on the CPU against the JAX
package's, and its train_ss / test_ss runs.

The step: G1 and G2 unet_128 ngf 4 at 128 px (image b -> classes r, g;
classes -> image), a 1-scale D2 ndf 4 on (label, image) pairs, the class
--weights 1 2, BCE GAN losses, --pool_size 1 starting full; one f32 step
through tests/test_torch_cgan_cycle.py's harness and tolerances (noise1,
noise2 and the forward key from fold_in(step key, 0..2), D2's pool from 3).
The JAX side runs with --no_pallas (every layer on XLA) and its
InstanceNorm variance centered, E[(x - mean)^2]: the package's own
E[x^2] - mean^2 in f32 (ops/norm.py:27-32 there, and the fused kernels')
cancels on G2's planes, whose input is G1's softmax (mean 0.5), and puts
JAX's f32 G2 gradient 4.7e-4 and G1's 1.4e-4 of their largest entries off
the port's, whose own f32 gradients lie within 1.3e-5 of a float64 run of
the same nets (the port takes E[x^2] - mean^2 too, with torch's
reductions); with the centered variance the two agree within 1e-4.
Before the step, the val-mode forward (noise at --noiseSizeVal) of both
packages on the same parameters: the logits within 2e-3 (InstanceNorm over
2x2 planes, as tests/test_torch_segmentation.py), the unweighted cross
entropy within 1e-5 and the accumulators within 1e-3.  The .pth files go
both ways.

train_ss and test_ss, through their entry points' argument parsing, for
one epoch on a synthetic 128 px set: the checkpoints of every net, the val
accuracies and the best one, test_ss's summary and images in [0, 1]; then
--sequential_train loads the nets --which_model_to_load names from that
run, strictly, and leaves the others at their init.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from supervised_gan_tpu.nn import core as jcore

from supervised_gan_tpu_torch import test_ss as ttest_ss
from supervised_gan_tpu_torch import train_ss as ttrain_ss
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions

from test_torch_cgan_cycle import (assert_pth_both_ways, assert_step_matches,
                                   jax_vs_port_step)
from test_torch_layout import nhwc, one_thread  # noqa: F401

LR = 2e-4
G_NETS = ['--which_model_netG1', 'unet_128', '--ngf1', '4',
          '--which_model_netG2', 'unet_128', '--ngf2', '4',
          '--no_dropout1', '--no_dropout2', '--which_channel', 'b_rg',
          '--which_metric', 'RandScore', 'meanIU']
TRAIN = ['--which_model_netD2', 'n_layers', '--n_layers_D2', '1',
         '--ndf2', '4', '--scale_factor2', '1', '--lambda_D2', '0.7',
         '--pool_size', '1', '--lambda_A', '1', '--lr', str(LR),
         '--lr1', str(LR), '--lr2', str(LR)]


def _arch(ckpt, name):
    return (['--dataroot', './datasets/unused', '--name', name,
             '--model', 'segmentation_cycle', '--dataset_mode', 'single',
             '--loadSize', '128', '--fineSize', '128', '--batchSize', '1',
             '--norm', 'instance', '--manualSeed', '0', '--display_id', '0',
             '--checkpoints_dir', ckpt] + G_NETS)


def _flags(ckpt, name, *extra):
    return _arch(ckpt, name) + TRAIN + list(extra)


def _batch():
    """tests/test_segmentation.py make_batch: one-hot label channels."""
    arr = np.random.RandomState(0).uniform(
        -1, 1, (1, 128, 128, 3)).astype(np.float32)
    arr[..., 0] = np.sign(arr[..., 0])
    arr[..., 1] = -arr[..., 0]
    return {'A': arr, 'A_paths': ['x.png']}


def _val_forward(jm, tm):
    for m in (jm, tm):
        m.reset_accs()
        m.forward(val_mode=True)
        m.accum_accs()
        m.compute_cross_entropy_loss()
    assert tuple(tm.draw_noise(val=True).shape) == (1, 8, 2, 2)
    np.testing.assert_allclose(nhwc(tm.logit), np.asarray(jm.logit),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tm.get_current_errors()['G_CE'],
                               jm.get_current_errors()['G_CE'], rtol=1e-5)
    for k, v in tm.get_current_accs().items():
        np.testing.assert_allclose(v, jm.get_current_accs()[k], atol=1e-3,
                                   err_msg=k)


def _centered_instance_norm(x, eps=1e-5):
    """The JAX package's XLA InstanceNorm (ops/norm.py:23-33 there) with
    the variance centered, E[(x - mean)^2], in place of E[x^2] - mean^2."""
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=(1, 2), keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=(1, 2), keepdims=True)
    return ((x32 - mean) * lax.rsqrt(var + eps)).astype(x.dtype)


def test_step_matches_jax(tmp_path, monkeypatch):
    f = _flags(str(tmp_path), 'sc', '--weights', '1', '2', '--no_lsgan2',
               '--noiseSizeVal', '2')
    monkeypatch.setattr(jcore, 'instance_norm', _centered_instance_norm)
    r = jax_vs_port_step(f, _batch(), {'noise': [0, 1], 'fkey': [2],
                                       'pool': [3]}, ['D2', None],
                         full_pools=['pool2'], before=_val_forward,
                         jax_flags=['--no_pallas'])
    assert_step_matches(r)
    tm = r['port']
    assert tm.pools['pool2']['images'].shape[1] == 3     # 2 classes + image
    assert list(tm.get_current_visuals()) == ['image', 'label',
                                               'prediction', 'recon']
    assert_pth_both_ways(r, tmp_path, f)


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp('ssc_data')
    rng = np.random.RandomState(0)
    for sub, n in (('train', 2), ('val', 1), ('test', 2)):
        os.makedirs(root / sub)
        for i in range(n):
            a = np.zeros((128, 128, 3), np.uint8)
            a[..., 0] = (rng.rand(128, 128) > 0.6) * 255
            a[..., 1] = 255 - a[..., 0]
            a[..., 2] = rng.randint(0, 255, (128, 128))
            Image.fromarray(a).save(str(root / sub / ('%03d.png' % i)))
    return str(root)


def test_train_ss_test_ss_and_sequential(dataroot, tmp_path, capsys):
    ck = str(tmp_path / 'ck')
    common = _flags(ck, 'ssc') + ['--dataroot', dataroot, '--gpu_ids', '-1']
    r = ttrain_ss.main(common + [
        '--niter', '1', '--niter_decay', '0', '--print_freq', '1',
        '--save_epoch_freq', '1', '--best_metric', 'meanIU',
        '--nThreads', '1'])
    assert r['steps'] == 2 and len(r['val_accs']) == 1
    assert r['best'] == r['val_accs'][0]['meanIU']
    run = os.path.join(ck, 'ssc')
    files = set(os.listdir(run))
    for label in ('best', 'latest', '1'):
        assert {'%s_net_%s.pth' % (label, n)
                for n in ('G1', 'G2', 'D2_0')} <= files
        assert '%s_state.pt' % label in files
    capsys.readouterr()
    r = ttest_ss.main(_arch(ck, 'ssc') + [
        '--dataroot', dataroot, '--gpu_ids', '-1', '--results_dir',
        str(tmp_path / 'res'), '--which_epoch', 'best', '--phase', 'test'])
    out = capsys.readouterr().out
    assert 'Segmentation results:' in out and 'RandScore: ' in out \
        and 'meanIU: ' in out and 'cross entropy loss: mean ' in out
    assert r['images'] == 2 and np.isfinite(r['ce_mean'])
    assert all(0 <= v <= 1 for v in r['accs'].values())
    images = sorted(os.listdir(os.path.join(r['web_dir'], 'images')))
    assert images == ['%03d_%s.png' % (i, v) for i in (0, 1)
                      for v in ('image', 'label', 'prediction')]

    fresh = tcreate(TTrainOptions().parse(
        _flags(str(tmp_path / 'f'), 'f') + ['--gpu_ids', '-1']))
    seq = tcreate(TTrainOptions().parse(
        _flags(str(tmp_path / 's'), 's') + [
            '--gpu_ids', '-1', '--sequential_train', '--pretrained_model_dir',
            run, '--which_epoch_sequential', 'best',
            '--which_model_to_load', 'G1', 'D2']))
    for label, net in seq.nets().items():
        nets = net if isinstance(net, torch.nn.ModuleList) else [net]
        refs = fresh.nets()[label]
        refs = refs if isinstance(refs, torch.nn.ModuleList) else [refs]
        for i, (m, ref) in enumerate(zip(nets, refs)):
            name = label if label != 'D2' else 'D2_%d' % i
            saved = torch.load(os.path.join(run, 'best_net_%s.pth' % name))
            want = saved if label in ('G1', 'D2') else ref.state_dict()
            for k, v in m.state_dict().items():
                assert torch.equal(v, want[k]), (label, k)
