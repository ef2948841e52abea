"""The port's sampling driver, ``python -m supervised_gan_tpu_torch.test``,
on the CPU at a small DSGAN config with checkpoints written by the JAX
package's save_pth (G1, G2 and the F2 that the sampler loads but does not
run): the results layout of the JAX test.py, determinism
under one seed, and the refusals (no silent CPU fallback, unported flags,
the data-parallel flags' misuses); the sampler runs unsharded under the
data-parallel flags.
--no_pallas is held in tests/test_torch_no_pallas.py."""

import os
import subprocess
import sys

import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch.options import base_options

from test_torch_layout import jax_params
from test_torch_layout import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the subprocess's torch on one thread, as one_thread sets it in-process
ONE_THREAD_ENV = dict(os.environ, OMP_NUM_THREADS='1')

ARCH = ['--model', 'twostage_cycle', '--which_direction', 'AtoB',
        '--dataset_mode', 'single', '--fineSize', '64',
        '--transform_1to2', 'bilinear_2', '--input_nc', '2',
        '--output_nc', '1', '--which_channel', 'rg_b',
        '--which_model_netG1', 'fcgan', '--n_layers_G1', '3', '--ngf1', '8',
        '--which_model_netG2', 'crn', '--ngf2', '16',
        '--upsample_mode2', 'bilinear', '--n_layers_CRN_block2', '2',
        '--noise_nc1', '4', '--noiseSize1', '2', '--noise_nc2', '4',
        '--noiseSize2', '1', '--which_model_netF2', 'unet_128',
        '--nff2', '4', '--norm', 'instance', '--no_dropout1',
        '--manualSeed', '0', '--display_id', '0']


@pytest.fixture(scope='module')
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('ckpt')
    os.makedirs(d / 'dsgan_small')
    g1 = jnn.define_G(2, 0, 8, 'fcgan', 'instance', False, n_layers_G=3,
                      use_fcn=True, noise_nc=4)
    g2 = jnn.define_G(2, 1, 16, 'crn', 'instance', False, n_layers_G=5,
                      noise_nc=4, upsample_mode='bilinear',
                      n_layers_CRN_block=2)
    f2 = jnn.define_G(1, 2, 4, 'unet_128', 'instance', True)
    for net, label, seed in ((g1, 'G1', 0), (g2, 'G2', 1), (f2, 'F2', 2)):
        params = jax_params(net, seed)
        jpth.save_pth(str(d / 'dsgan_small' / ('latest_net_%s.pth' % label)),
                      net, params)
    return str(d)


def _args(ckpt, results, *extra):
    return (['--dataroot', './datasets/null', '--name', 'dsgan_small',
             '--checkpoints_dir', ckpt, '--results_dir', results] + ARCH
            + list(extra))


def test_cli_writes_results_layout(ckpt_dir, tmp_path):
    results = str(tmp_path / 'results')
    cmd = [sys.executable, '-m', 'supervised_gan_tpu_torch.test',
           '--gpu_ids', '-1', '--how_many', '3'] + _args(ckpt_dir, results)
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=ONE_THREAD_ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count('Random check: ') == 3
    web = os.path.join(results, 'dsgan_small', 'test_latest')
    assert os.path.exists(os.path.join(web, 'index.html'))
    assert sorted(os.listdir(os.path.join(web, 'images'))) == [
        '%04d_fake_%s.png' % (i, ab) for i in (1, 2, 3) for ab in 'AB']


def test_same_seed_same_images(ckpt_dir, tmp_path):
    outs = []
    for run in range(2):
        r = ttest.main(['--gpu_ids', '-1', '--how_many', '2']
                       + _args(ckpt_dir, str(tmp_path / str(run))))
        assert r['nonfinite'] == 0
        img = os.path.join(r['web_dir'], 'images')
        outs.append({f: open(os.path.join(img, f), 'rb').read()
                     for f in os.listdir(img)})
    assert outs[0] == outs[1] and len(outs[0]) == 4


def test_single_image_visuals(ckpt_dir, tmp_path):
    r = ttest.main(['--gpu_ids', '-1', '--how_many', '1',
                    '--save_as_single_image']
                   + _args(ckpt_dir, str(tmp_path)))
    assert os.listdir(os.path.join(r['web_dir'], 'images')) == ['0001_AB.png']


def test_gpu_asked_without_cuda_raises(ckpt_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='gpu_ids -1'):
        ttest.main(['--how_many', '1'] + _args(ckpt_dir, str(tmp_path)))


@pytest.mark.parametrize("flag,value", [('--spatial_mesh', '2')])
def test_unported_flag_raises(tmp_path, flag, value):
    """--spatial_mesh is ported for fcgan, cgan and twostage_cycle; on a
    recipe still queued (twostage) the train entry point raises, naming
    the flag, before it starts a worker."""
    from supervised_gan_tpu_torch import train as ttrain
    assert flag[2:] not in base_options.NOT_YET_PORTED
    extra = [flag, value]
    args = ['--dataroot', './datasets/null', '--name', 'dsgan_small',
            '--checkpoints_dir', str(tmp_path)] + ARCH + extra
    args[args.index('twostage_cycle')] = 'twostage'
    with pytest.raises(NotImplementedError, match=flag):
        ttrain.main(['--gpu_ids', '-1'] + args)


def _images(r):
    img = os.path.join(r['web_dir'], 'images')
    return {f: open(os.path.join(img, f), 'rb').read()
            for f in os.listdir(img)}


@pytest.mark.parametrize("flag,value", [
    ('--data_mesh', '2'), ('--dcn_coordinator', 'localhost:1234'),
    ('--dcn_num_processes', '2'), ('--dcn_process_id', '1')])
def test_parallel_flag_parses_and_sampler_runs_unsharded(ckpt_dir, tmp_path,
                                                         flag, value):
    """The data-parallel flags parse; the sampler runs one unsharded process
    under each (no process group) and writes the images it writes without
    it."""
    assert flag[2:] not in base_options.NOT_YET_PORTED
    outs = [ttest.main(['--gpu_ids', '-1', '--how_many', '1']
                       + _args(ckpt_dir, str(tmp_path / str(i)), *extra))
            for i, extra in enumerate([[], [flag, value]])]
    assert not torch.distributed.is_initialized()
    assert outs[1]['samples'] == 1
    assert _images(outs[1]) == _images(outs[0])


TRAIN_ARGS = ['--model', 'fcgan', '--name', 'misuse', '--gpu_ids', '-1']


@pytest.mark.parametrize("entry,extra,error,match", [
    ('train', ['--batchSize', '3', '--data_mesh', '2'], ValueError,
     'batchSize 3 is not divisible by --data_mesh 2'),
    ('train', ['--batchSize', '6', '--data_mesh', '3',
               '--dcn_num_processes', '2', '--dcn_coordinator',
               'localhost:1234'], ValueError,
     'data_mesh 3 must be a multiple of --dcn_num_processes 2'),
    ('cards', ['--batchSize', '2', '--data_mesh', '2'], RuntimeError,
     'has 1 cards: fewer cards than workers'),
    ('bench', ['--data_mesh', '2'], NotImplementedError, '--data_mesh')])
def test_parallel_misuse_raises(tmp_path, monkeypatch, entry, extra, error,
                                match):
    """A run it cannot make raises before any worker starts: a batch that
    does not split, a process count that does not divide the workers, more
    workers than cards (never two on one, never the CPU instead), and the
    one-card bench."""
    from supervised_gan_tpu_torch import bench as tbench
    from supervised_gan_tpu_torch import train as ttrain
    def no_spawn(*a, **k):
        raise AssertionError('a worker was started')

    monkeypatch.setattr(torch.multiprocessing, 'start_processes', no_spawn)
    args = ['--dataroot', str(tmp_path), '--checkpoints_dir', str(tmp_path)]
    if entry == 'cards':
        # a one-card machine; the two workers would ask for cuda:0 and cuda:1
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
        args += ['--model', 'fcgan', '--name', 'misuse']
    elif entry == 'train':
        args += TRAIN_ARGS
    if entry == 'bench':
        with pytest.raises(error, match=match):
            tbench.main(['--gpu_ids', '-1', '--checkpoints_dir',
                         str(tmp_path)] + extra)
        return
    with pytest.raises(error, match=match):
        ttrain.main(args + extra)
    assert not torch.distributed.is_initialized()


def test_sampler_refuses_a_mismatched_f2(ckpt_dir, tmp_path):
    """F2 is loaded with strict=True, as the JAX sampler loads it: a run
    whose F2 width does not match the checkpoint fails."""
    args = _args(ckpt_dir, str(tmp_path))
    args[args.index('--nff2') + 1] = '8'
    with pytest.raises(RuntimeError, match='F2|size mismatch'):
        ttest.main(['--gpu_ids', '-1', '--how_many', '1'] + args)
