"""The port's training entry point,
``python -m supervised_gan_tpu_torch.train``, on the CPU: a tiny synthetic
single-PNG dataset (label in R and G, image in B), 2 iterations of a narrow
DSGAN config with pools and dropout on.
Checked: the loss lines, the numbered / latest checkpoints (the per-net
.pth files and the port's full state), the web/ page, the lr decay print,
the set-up's timed sections it returns and prints, that without
--gpu_ids -1 and with no CUDA device it raises, and --profile_dir's trace
of steps 10-20 with the port's spans (the DSGAN options through this
entry point: tests/test_torch_train_flags.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu_torch import train as ttrain
from supervised_gan_tpu_torch.ops import kernels as K

from test_torch_train_step import FLAGS
from test_torch_layout import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the subprocess's torch on one thread, as one_thread sets it in-process
ONE_THREAD_ENV = dict(os.environ, OMP_NUM_THREADS='1')
NETS = ['G1', 'G2', 'F2', 'D1_0', 'D1_1', 'D2_0', 'D2_1']


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    d = tmp_path_factory.mktemp('data')
    os.makedirs(d / 'train')
    rng = np.random.RandomState(0)
    for i in range(2):
        a = np.zeros((160, 160, 3), np.uint8)
        a[..., 0] = (rng.rand(160, 160) > 0.7) * 255
        a[..., 1] = (rng.rand(160, 160) > 0.8) * 255
        a[..., 2] = rng.randint(0, 255, (160, 160))
        Image.fromarray(a).save(str(d / 'train' / ('%03d.png' % i)))
    return str(d)


def _args(dataroot, ckpt):
    args = list(FLAGS)
    args[args.index('--dataroot') + 1] = dataroot
    args[args.index('--loadSize') + 1] = '144'
    return args + ['--checkpoints_dir', ckpt, '--pool_size', '2',
                   '--niter', '1', '--niter_decay', '1', '--print_freq', '1',
                   '--display_freq', '2', '--save_epoch_freq', '1']


def test_train_cli_two_steps(dataroot, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    args = _args(dataroot, ckpt)
    args[args.index('--niter_decay') + 1] = '0'
    cmd = [sys.executable, '-m', 'supervised_gan_tpu_torch.train',
           '--gpu_ids', '-1'] + args
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=ONE_THREAD_ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith('(epoch: 1')]
    assert len(lines) == 2
    for key in ('G2_GAN', 'G2_real_cycle', 'G2_fake_cycle', 'D2', 'G1_GAN',
                'D1'):
        assert all(key + ': ' in l for l in lines)
    run = os.path.join(ckpt, 'step')
    files = set(os.listdir(run))
    for label in ('1', 'latest'):
        assert {'%s_net_%s.pth' % (label, n) for n in NETS} <= files
        assert '%s_state.pt' % label in files
    assert open(os.path.join(run, 'loss_log.txt')).read().count(
        '(epoch: 1') == 2
    web = os.path.join(run, 'web')
    assert os.path.exists(os.path.join(web, 'index.html'))
    images = os.listdir(os.path.join(web, 'images'))
    assert sorted(images) == sorted(
        'epoch001_%s.png' % v for v in (
            'real_A', 'fake_B_real_A', 'fake_A', 'fake_B_fake_A',
            'fake_A_real_B', 'real_B', 'recon_real_A', 'recon_fake_A'))


def test_train_decays_lr_and_returns_steps(dataroot, tmp_path, capsys):
    """It also returns and prints, after the first dispatch, the set-up's
    timed sections (totals of the process, utils/profile.py TIMES), and
    their totals again at the end."""
    r = ttrain.main(['--gpu_ids', '-1']
                    + _args(dataroot, str(tmp_path / 'ckpt')))
    assert r['steps'] == 4 and len(r['step_seconds']) == 4
    assert r['times']['models.init'][0] >= 1
    assert r['times']['dispatch.eager_step'][0] >= 4
    assert all(s > 0 for _, s in r['times'].values())
    out = capsys.readouterr().out.splitlines()
    (line,) = [l for l in out if l.startswith('set-up: ')]
    assert 'models.init ' in line and 'dispatch.eager_step ' in line
    (end,) = [l for l in out if l.startswith('timed sections: ')]
    assert 'dispatch.eager_step ' in end


def test_train_without_cuda_raises(dataroot, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='gpu_ids -1'):
        ttrain.main(_args(dataroot, str(tmp_path / 'ckpt')))


def test_profile_dir_writes_a_trace_of_steps_10_to_20(dataroot, tmp_path,
                                                      capsys):
    """20 steps (10 epochs of 2 images) with --profile_dir: one Chrome
    trace written there, of host activity on the CPU, and the JAX driver's
    line.  --no_pallas keeps the traced steps to library calls: the plain
    versions' per-tap ops would make the CPU trace ten times larger."""
    prof = str(tmp_path / 'prof')
    args = _args(dataroot, str(tmp_path / 'ckpt'))
    for flag, value in (('--niter', '10'), ('--niter_decay', '0'),
                        ('--print_freq', '100'), ('--display_freq', '100'),
                        ('--save_epoch_freq', '100')):
        args[args.index(flag) + 1] = value
    try:
        r = ttrain.main(['--gpu_ids', '-1', '--no_pallas', '--profile_dir',
                         prof] + args)
    finally:
        K.set_kernels_enabled(True)
    assert r['steps'] == 20
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    assert r['trace']['path'] == os.path.join(prof, files[0])
    assert 'profiler trace written to %s' % prof in capsys.readouterr().out
    with open(r['trace']['path']) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'aten::conv2d' for e in events)
    # the port's spans: per-step dispatches, each step eager on the CPU
    names = {e.get('name') for e in events}
    assert {'dispatch.stage_inputs', 'dispatch.host_inputs',
            'dispatch.to_device', 'dispatch.stage_rows',
            'dispatch.eager_step'} <= names


def test_profile_dir_not_written_short(dataroot, tmp_path, capsys):
    """A run that ends before step 20 writes no trace."""
    prof = str(tmp_path / 'prof')
    args = _args(dataroot, str(tmp_path / 'ckpt'))
    for flag, value in (('--niter', '6'), ('--niter_decay', '0'),
                        ('--print_freq', '100'), ('--display_freq', '100'),
                        ('--save_epoch_freq', '100')):
        args[args.index(flag) + 1] = value
    try:
        r = ttrain.main(['--gpu_ids', '-1', '--no_pallas', '--profile_dir',
                         prof] + args)
    finally:
        K.set_kernels_enabled(True)
    assert r['steps'] == 12 and r['trace'] is None
    assert not os.path.exists(prof)
    assert 'profiler trace not written' in capsys.readouterr().out
