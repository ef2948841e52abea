"""The training entry point data-parallel on the CPU:
``python -m supervised_gan_tpu_torch.train --data_mesh 2 --gpu_ids -1`` (two
gloo workers spawned by the one process) and the same run over two
processes, each ``--dcn_num_processes 2 --dcn_process_id p --data_mesh 2``
with one worker, meeting at ``--dcn_coordinator`` (as tests/test_dcn.py
holds JAX's 2 x 4 devices to one 8-device process).  The config is
tests/torch_parallel_jobs.py's fcgan (dropout and a pool on) on four 32 px
PNGs, batch 2, one epoch of two steps.

Checked: both runs' checkpoints load into the port's nets with
strict=True; the --data_mesh 2 run's equal the unsharded run's within 1e-4
relative L2 per tensor (its test_torch_parallel.py bound); the two-process
run's equal the --data_mesh 2 run's bitwise, as does a --data_mesh 2 run
with --steps_per_dispatch 2 (its chunk runs step by step); rank 0 alone
wrote the loss log (each print once).  And train_ss: the segmentation
recipe with a D and the class-weighted cross entropy (whose weight sum is
the global batch's), at --data_mesh 2 against one process: its latest and
best checkpoints within 1e-4, the same validation accuracies.  The runs go
at once, each with a timeout and its own process group of the OS, which a
timeout kills whole.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu_torch import parallel
from supervised_gan_tpu_torch.models import create_model
from supervised_gan_tpu_torch.options import TrainOptions

import torch_parallel_jobs as J
from test_torch_layout import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD_ENV = dict(os.environ, OMP_NUM_THREADS='1')
TIMEOUT = 300
NETS = ['G', 'D_0', 'D_1']
# tests/test_torch_segmentation.py's segmentation with a D, the
# cross-entropy head weighted by class
SEG = ['--model', 'segmentation', '--name', 'ss', '--dataset_mode', 'single',
       '--loadSize', '128', '--fineSize', '128', '--batchSize', '2',
       '--manualSeed', '0', '--display_id', '0', '--gpu_ids', '-1',
       '--which_direction', 'AtoB', '--which_model_netG', 'unet_128',
       '--ngf', '4', '--noise_nc', '4', '--noiseSize', '4',
       '--norm', 'instance', '--no_dropout', '--which_channel', 'b_rg',
       '--which_metric', 'RandScore', 'meanIU',
       '--which_model_netD', 'n_layers', '--n_layers_D', '2', '--ndf', '4',
       '--scale_factor', '1', '--lambda_D', '0.5', '--no_lsgan',
       '--weights', '1', '2', '--pool_size', '2', '--lambda_A', '1',
       '--niter', '1', '--niter_decay', '0', '--print_freq', '4',
       '--save_epoch_freq', '1', '--best_metric', 'meanIU', '--nThreads', '1']


def _flags(dataroot, ckpt):
    flags = J.config_flags('fcgan', ckpt)
    flags[flags.index('--dataroot') + 1] = dataroot
    return flags + ['--niter', '1', '--niter_decay', '0', '--print_freq', '4',
                    '--display_freq', '2', '--save_epoch_freq', '1']


def _start(args, entry='train'):
    return subprocess.Popen(
        [sys.executable, '-m', 'supervised_gan_tpu_torch.' + entry] + args,
        cwd=ROOT, env=ONE_THREAD_ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(procs):
    """Each process's output; a process past the deadline is killed with
    its workers, and a failed one fails the test."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dp')
    data = root / 'data'
    os.makedirs(data / 'train')
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(str(data / 'train' / ('%d.png' % i)))
    seg = root / 'seg'
    for sub, n in (('train', 4), ('val', 1)):
        os.makedirs(seg / sub)
        for i in range(n):
            a = np.zeros((128, 128, 3), np.uint8)
            a[..., 0] = (rng.rand(128, 128) > 0.6) * 255
            a[..., 1] = 255 - a[..., 0]
            a[..., 2] = rng.randint(0, 255, (128, 128))
            Image.fromarray(a).save(str(seg / sub / ('%03d.png' % i)))
    ck = {k: str(root / k)
          for k in ('dp', 'dcn', 'one', 'chunk', 'ss_dp', 'ss_one')}
    port = parallel.mesh.free_port()
    procs = [_start(_flags(str(data), ck['dp']) + ['--data_mesh', '2'])]
    procs += [_start(_flags(str(data), ck['dcn']) + [
        '--data_mesh', '2', '--dcn_num_processes', '2',
        '--dcn_process_id', str(p), '--dcn_coordinator',
        '127.0.0.1:%d' % port]) for p in (0, 1)]
    procs.append(_start(_flags(str(data), ck['chunk']) + [
        '--data_mesh', '2', '--steps_per_dispatch', '2']))
    procs.append(_start(SEG + ['--dataroot', str(seg), '--checkpoints_dir',
                               ck['ss_dp'], '--data_mesh', '2'], 'train_ss'))
    try:
        from supervised_gan_tpu_torch import train as ttrain
        from supervised_gan_tpu_torch import train_ss as ttrain_ss
        one = ttrain.main(_flags(str(data), ck['one']))
        ss_one = ttrain_ss.main(SEG + ['--dataroot', str(seg),
                                       '--checkpoints_dir', ck['ss_one']])
    finally:
        outs = _finish(procs)
    return dict(ck=ck, one=one, ss_one=ss_one, outs=outs)


def _nets(ckpt, label):
    """The fcgan's nets with ``<label>_net_*.pth`` loaded strictly."""
    model = create_model(TrainOptions().parse(J.config_flags('fcgan', ckpt)))
    path = os.path.join(ckpt, 'fcgan')
    model.load_network(model.netG, 'G', label, path)
    model.load_bank(model.netD, 'D_%d', label, path)
    return {k: v.detach().clone() for label_, net in model.nets().items()
            for k, v in ((label_ + '.' + n, t)
                         for n, t in net.state_dict().items())}


def test_every_run_wrote_its_checkpoints(runs):
    assert runs['one']['steps'] == 2
    for k in ('dp', 'dcn', 'one', 'chunk'):
        files = set(os.listdir(os.path.join(runs['ck'][k], 'fcgan')))
        for label in ('1', 'latest'):
            assert {'%s_net_%s.pth' % (label, n) for n in NETS} <= files, k
            assert '%s_state.pt' % label in files, k


@pytest.mark.parametrize('label', ['1', 'latest'])
def test_data_mesh_checkpoints_equal_unsharded(runs, label):
    ours = _nets(runs['ck']['dp'], label)
    ref = _nets(runs['ck']['one'], label)
    assert ours.keys() == ref.keys()
    for k in ref:
        a, b = ours[k].double(), ref[k].double()
        rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert rel <= 1e-4, (k, rel)


@pytest.mark.parametrize('run', ['dcn', 'chunk'])
@pytest.mark.parametrize('label', ['1', 'latest'])
def test_run_equals_data_mesh_run_bitwise(runs, run, label):
    """Two processes of one worker each (--dcn_*), and chunks of two steps
    (--steps_per_dispatch 2), compute the --data_mesh 2 run's steps."""
    ours = _nets(runs['ck'][run], label)
    ref = _nets(runs['ck']['dp'], label)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize('label', ['1', 'best'])
def test_train_ss_data_mesh_equals_unsharded(runs, label):
    nets = []
    for k in ('ss_dp', 'ss_one'):
        sd = torch.load(os.path.join(runs['ck'][k], 'ss', '%s_net_G.pth'
                                     % label), weights_only=True)
        nets.append(sd)
    model = create_model(TrainOptions().parse(
        SEG + ['--dataroot', 'unused', '--checkpoints_dir',
               str(runs['ck']['ss_one'])]))
    model.netG.load_state_dict(nets[0], strict=True)
    for k in nets[1]:
        assert _rel(nets[0][k], nets[1][k]) <= 1e-4, k
    log = open(os.path.join(runs['ck']['ss_dp'], 'ss', 'loss_log.txt')).read()
    assert log.count('(epoch: 1') == 1


def test_train_ss_validation_equals_unsharded(runs):
    """Validation runs unsharded on every rank: rank 0's accuracies are the
    one-process run's."""
    out = runs['outs'][-1]
    line = [l for l in out.splitlines() if l.startswith('validation (epoch')]
    assert len(line) == 1
    accs = dict(kv.rsplit(' ', 1) for kv in
                line[0].split(': ', 1)[1].split(', '))
    for k, v in runs['ss_one']['val_accs'][0].items():
        assert abs(float(accs[k]) - v) <= 1e-4, (k, accs[k], v)


def test_rank_zero_alone_logs(runs):
    for k in ('dp', 'dcn'):
        log = open(os.path.join(runs['ck'][k], 'fcgan', 'loss_log.txt')).read()
        assert log.count('(epoch: 1') == 1, k
        assert log.count('Training Loss') == 1, k
    # the one-process launcher of --data_mesh 2 reports its workers' losses
    assert runs['outs'][0].count('(epoch: 1, iters: 4') == 1
