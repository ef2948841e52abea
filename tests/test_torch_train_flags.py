"""The DSGAN recipe's training options through the port's training entry
point on the CPU: 2 steps of the narrow DSGAN config of
tests/test_torch_train_driver.py (its synthetic set, pools and dropout on)
with each of --use_multi_class_GAN, the fake_fake pairs,
--use_fixed_noise1 and --no_cgan: finite losses in the JAX package's
metric order, every network's checkpoint and the full state.  Apart from
that file, so that its long --profile_dir tests and these run on two
workers."""

import os

import numpy as np
import pytest

from supervised_gan_tpu_torch import train as ttrain

from test_torch_train_driver import NETS, _args, dataroot  # noqa: F401
from test_torch_twostage_flags import one_thread  # noqa: F401


@pytest.mark.parametrize("extra", [
    ['--use_multi_class_GAN'],
    ['--GAN_losses_D2', 'real_fake', 'fake_fake', '--GAN_losses_G2',
     'real_fake', 'fake_fake'],
    ['--use_fixed_noise1', '--noise_pool_size', '4'],
    ['--no_cgan']], ids=['multi_class', 'fake_fake', 'fixed_noise1',
                         'no_cgan'])
def test_training_flags_train_two_steps(dataroot, tmp_path, extra):
    """Each of the recipe's training options, 2 steps through the entry
    point: finite losses, every network's checkpoint and the full state."""
    ckpt = str(tmp_path / 'ckpt')
    args = _args(dataroot, ckpt)
    args[args.index('--niter_decay') + 1] = '0'
    r = ttrain.main(['--gpu_ids', '-1'] + args + extra)
    assert r['steps'] == 2
    run = os.path.join(ckpt, 'step')
    lines = [l.split(')', 1)[1].split() for l in open(
        os.path.join(run, 'loss_log.txt')) if l.startswith('(epoch: 1')]
    assert len(lines) == 2
    for vals in lines:
        assert vals[::2] == ['G2_GAN:', 'G2_real_cycle:', 'G2_fake_cycle:',
                             'D2:', 'G1_GAN:', 'D1:']
        assert all(np.isfinite(float(v)) for v in vals[1::2])
    files = set(os.listdir(run))
    assert {'latest_net_%s.pth' % n for n in NETS} | {'latest_state.pt'} \
        <= files
