"""`--sequential_train` of the port's DSGAN trainer on the CPU: the stage-1
label GAN's G and D bank, handed off as `seq_net_{G1,D1_0,D1_1}.pth` (the
copy of tools/recipe_r05.py `export_seq`), load into G1 and the D1 bank
strictly, from files that the port's fcgan trainer wrote and from files that
the JAX package's checkpoint writer wrote; the nets not named keep their
init; a missing file or a mismatched width raises; and --continue_train,
loaded after, wins.

The DSGAN is tests/test_torch_train_step.py's small config (G1 fcgan ngf 4 x
4 layers from 4 x 2^2 noise, D1 2-scale n_layers 2 ndf 4); stage 1 is the
matching fcgan (--which_channel rg, a 3-scale D bank, the third dropped by
the hand-off) at 64 px.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions

from test_torch_layout import jax_params
from test_torch_train_step import FLAGS as DSGAN_FLAGS
from test_torch_layout import one_thread  # noqa: F401

STAGE1 = ['--dataroot', './datasets/unused', '--name', 'stage1',
          '--model', 'fcgan', '--which_direction', 'A',
          '--dataset_mode', 'single', '--loadSize', '64', '--fineSize', '64',
          '--batchSize', '1', '--which_model_netG', 'deconv',
          '--n_layers_G', '4', '--ngf', '4', '--noise_nc', '4',
          '--noiseSize', '2', '--which_model_netD', 'n_layers',
          '--n_layers_D', '2', '2', '2', '--ndf', '4',
          '--scale_factor', '1', '2', '4', '--lambda_D', '0.5', '0.4', '0.1',
          '--norm', 'instance', '--no_dropout', '--n_update_G', '2',
          '--no_lsgan', '--which_channel', 'rg', '--manualSeed', '3',
          '--display_id', '0', '--pool_size', '2']
HANDOFF = [('latest_net_G.pth', 'seq_net_G1.pth'),
           ('latest_net_D_0.pth', 'seq_net_D1_0.pth'),
           ('latest_net_D_1.pth', 'seq_net_D1_1.pth')]


def _handoff(stage1_dir, dst):
    os.makedirs(dst, exist_ok=True)
    for a, b in HANDOFF:
        shutil.copy(os.path.join(stage1_dir, a), os.path.join(dst, b))
    return dst


def _dsgan(ckpt, *extra):
    return tcreate(TTrainOptions().parse(
        DSGAN_FLAGS + ['--checkpoints_dir', ckpt, '--gpu_ids', '-1']
        + list(extra)))


def _seq(pretrained, *which):
    return ['--sequential_train', '--which_model_to_load', *which,
            '--pretrained_model_dir', pretrained]


@pytest.fixture(scope='module')
def port_stage1(tmp_path_factory):
    """Stage-1 files from the port's fcgan trainer after one step."""
    ckpt = str(tmp_path_factory.mktemp('port_stage1'))
    m = tcreate(TTrainOptions().parse(STAGE1 + ['--checkpoints_dir', ckpt,
                                                '--gpu_ids', '-1']))
    m.set_input({'A': np.random.RandomState(0).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32), 'A_paths': ['x.png']})
    m.optimize_parameters()
    m.save('latest')
    return os.path.join(ckpt, 'stage1')


def _assert_loaded(net, path):
    sd = torch.load(path, weights_only=True)
    ours = net.state_dict()
    assert set(ours) == set(sd)
    for k, v in sd.items():
        assert torch.equal(ours[k], v), k


def _assert_same(a, b):
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na


def test_loads_port_stage1_files(port_stage1, tmp_path):
    pre = _handoff(port_stage1, str(tmp_path / 'pretrained'))
    m = _dsgan(str(tmp_path / 'ckpt'), *_seq(pre, 'G1', 'D1'))
    fresh = _dsgan(str(tmp_path / 'ckpt_fresh'))
    _assert_loaded(m.netG1, os.path.join(pre, 'seq_net_G1.pth'))
    for i in (0, 1):
        _assert_loaded(m.netD1[i], os.path.join(pre, 'seq_net_D1_%d.pth' % i))
    for label in ('G2', 'F2', 'D2'):            # not named: their init
        _assert_same(getattr(m, 'net' + label), getattr(fresh, 'net' + label))
    with pytest.raises(AssertionError):       # and G1 did move off its init
        _assert_same(m.netG1, fresh.netG1)


def test_loads_jax_stage1_files(tmp_path):
    """The JAX fcgan trainer's checkpoints: its G and D bank (built by
    jnn.define_G / define_D from the stage-1 flags, as its initialize does)
    written by utils/pth.py save_pth under the names its save() gives."""
    d = tmp_path / 'jax'
    os.makedirs(d)
    nets = {'G': jnn.define_G(2, 0, 4, 'deconv', 'instance', False,
                              n_layers_G=4, use_fcn=True, noise_nc=4)}
    for i, scale in enumerate((1, 2, 4)):
        nets['D_%d' % i] = jnn.define_D(2, 4, 'n_layers', 2, 'instance', True,
                                        scale)
    for seed, (label, net) in enumerate(nets.items()):
        jpth.save_pth(str(d / ('latest_net_%s.pth' % label)), net,
                      jax_params(net, 60 + seed))
    pre = _handoff(str(d), str(tmp_path / 'pretrained'))
    m = _dsgan(str(tmp_path / 'ckpt'), *_seq(pre, 'G1', 'D1'))
    _assert_loaded(m.netG1, os.path.join(pre, 'seq_net_G1.pth'))
    for i in (0, 1):
        _assert_loaded(m.netD1[i], os.path.join(pre, 'seq_net_D1_%d.pth' % i))


def test_missing_file_raises(port_stage1, tmp_path):
    pre = _handoff(port_stage1, str(tmp_path / 'pretrained'))
    os.remove(os.path.join(pre, 'seq_net_D1_1.pth'))
    with pytest.raises(FileNotFoundError, match='seq_net_D1_1'):
        _dsgan(str(tmp_path / 'ckpt'), *_seq(pre, 'G1', 'D1'))


def test_loading_is_strict(tmp_path):
    """A stage-1 G of another width fails to load into G1."""
    wide = list(STAGE1)
    wide[wide.index('--ngf') + 1] = '8'
    m = tcreate(TTrainOptions().parse(wide + ['--checkpoints_dir',
                                              str(tmp_path / 's1'),
                                              '--gpu_ids', '-1']))
    m.save('latest')
    pre = _handoff(str(tmp_path / 's1' / 'stage1'),
                   str(tmp_path / 'pretrained'))
    with pytest.raises(RuntimeError, match='size mismatch'):
        _dsgan(str(tmp_path / 'ckpt'), *_seq(pre, 'G1'))


def test_continue_train_overrides_sequential(port_stage1, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    saved = _dsgan(ckpt)
    saved.save('latest')
    pre = _handoff(port_stage1, str(tmp_path / 'pretrained'))
    m = _dsgan(ckpt, *_seq(pre, 'G1', 'D1'), '--continue_train')
    _assert_same(m.netG1, saved.netG1)
    _assert_same(m.netD1, saved.netD1)
