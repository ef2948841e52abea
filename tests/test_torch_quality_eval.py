"""The port's quality-gate driver (supervised_gan_tpu_torch/quality_eval.py)
against tools/quality_eval.py: the same driver arguments, parsed by the
port's options; the same synthetic sets and label-shuffled control, file
for file; the metrics read from the port's test_ss; and the whole gate end
to end on the CPU at 128 px (the unet_128's smallest input), narrow."""

import glob
import importlib.util
import json
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import supervised_gan_tpu_torch
from supervised_gan_tpu_torch import options as topts
from supervised_gan_tpu_torch import quality_eval as qe
from supervised_gan_tpu_torch.data import native_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD_ENV = dict(os.environ, OMP_NUM_THREADS='1')
JAX_KEYS = {'pipeline', 'scale', 'ours', 'torch_reference_semantics',
            'real_pairs_upper_bound', 'negative_control_label_shuffled',
            'ours_platform', 'ours_wall_sec', 'torch_wall_sec', 'note'}
RUNS = ('gan_train', 'gan_sample', 'ss_train', 'ss_test', 'ss_ub_train',
        'ss_ub_test', 'ss_neg_train', 'ss_neg_test')


@pytest.fixture(scope='module')
def jqe():
    """tools/quality_eval.py, loaded from its file (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        'tools_quality_eval', os.path.join(ROOT, 'tools', 'quality_eval.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('px,ngf', [(128, 8), (256, 16), (512, 16)])
def test_build_args_equal_jax_and_parse(jqe, tmp_path, px, ngf):
    ours = qe.build_args(px, ngf)
    assert ours == jqe.build_args(px, ngf)
    assert qe.build_args(px, ngf, 1e-4) == jqe.build_args(px, ngf, 1e-4)
    gan_net, gan_train, ss_net, ss_train = ours
    common = ['--dataroot', str(tmp_path), '--name', 'q', '--gpu_ids', '-1',
              '--checkpoints_dir', str(tmp_path / 'ck')]
    opt = topts.TrainOptions().parse(gan_train + common)
    assert (opt.model, opt.fineSize, opt.ngf2, opt.n_layers_G1) == (
        'twostage_cycle', px, ngf, int(np.log2(px)) - 4)
    assert topts.TestOptions().parse(gan_net + common).noiseSize2 == px // 64
    assert topts.TrainOptions().parse(ss_train + common).which_model_netG == \
        'unet_128'
    assert topts.TestOptions().parse(ss_net + common).ngf == ngf


def _pixels(root):
    files = sorted(glob.glob(os.path.join(root, '*', '*.png')))
    return [os.path.relpath(f, root) for f in files], [
        np.asarray(Image.open(f)) for f in files]


@pytest.mark.parametrize('maker', ['make_dataset', 'make_dataset_hard'])
def test_datasets_equal_jax(jqe, tmp_path, maker):
    counts = (3, 2, 2)
    getattr(qe, maker)(str(tmp_path / 'ours'), seed=5, px=128, counts=counts)
    getattr(jqe, maker)(str(tmp_path / 'jax'), seed=5, px=128, counts=counts)
    names, ours = _pixels(str(tmp_path / 'ours'))
    jnames, theirs = _pixels(str(tmp_path / 'jax'))
    assert names == jnames and len(names) == sum(counts)
    for a, b in zip(ours, theirs):
        assert a.shape == (128, 128, 3)
        np.testing.assert_array_equal(a, b)


def test_label_shuffled_equal_jax(jqe, tmp_path):
    qe.make_dataset(str(tmp_path / 'src'), seed=2, px=128, counts=(4, 0, 0))
    src = str(tmp_path / 'src' / 'train')
    qe.make_label_shuffled(src, str(tmp_path / 'ours'), seed=3)
    jqe.make_label_shuffled(src, str(tmp_path / 'jax'), seed=3)
    names = sorted(os.listdir(src))
    for n in names:
        a = np.asarray(Image.open(str(tmp_path / 'ours' / n)))
        b = np.asarray(Image.open(str(tmp_path / 'jax' / n)))
        np.testing.assert_array_equal(a, b)
        # the labels stay, every image is another pair's
        s = np.asarray(Image.open(os.path.join(src, n)))
        np.testing.assert_array_equal(a[..., :2], s[..., :2])
        assert not np.array_equal(a[..., 2], s[..., 2])
    with pytest.raises(ValueError, match='need >= 2'):
        qe.make_label_shuffled(str(tmp_path / 'none'), str(tmp_path / 'x'))


@pytest.fixture(scope='module')
def gate(tmp_path_factory):
    """The port's gate end to end on the CPU: 128 px, ngf 4, 2 / 1 / 2
    images, 1 + 1 GAN epochs, 2 samples, 1 + 1 segmentation epochs, with
    the negative control; each driver process on one torch thread."""
    work = str(tmp_path_factory.mktemp('gate'))
    out_json = os.path.join(work, 'out', 'q.json')
    cmd = [sys.executable, '-m', 'supervised_gan_tpu_torch.quality_eval',
           '--gpu_ids', '-1', '--px', '128', '--ngf', '4', '--train_n', '2',
           '--val_n', '1', '--test_n', '2', '--epochs_gan', '1',
           '--epochs_ss', '1', '--samples', '2', '--negative_control',
           '--work', work, '--out', out_json]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=ONE_THREAD_ENV)
    return dict(work=work, proc=proc, json=out_json)


def test_gate_every_driver_exits_zero(gate):
    proc = gate['proc']
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = re.findall(r'^\[(\w+)\] rc=(-?\d+) ', proc.stdout, re.M)
    assert got == [(tag, '0') for tag in RUNS]
    for tag in RUNS:
        assert os.path.exists(os.path.join(gate['work'], tag + '.log'))


def test_gate_json_and_metrics(gate):
    assert gate['proc'].returncode == 0, gate['proc'].stderr[-3000:]
    with open(gate['json']) as f:
        result = json.load(f)
    assert json.loads(gate['proc'].stdout.strip().splitlines()[-1]) == result
    assert set(result) == {k for k in JAX_KEYS if not k.startswith('torch_')}
    assert result['ours_platform'] == 'cpu'
    assert result['scale'] == {
        'px': 128, 'ngf': 4, 'lr': 2e-4, 'epochs_gan': 2, 'epochs_ss': 2,
        'train_images': 2, 'generated_pairs': 2, 'test_images': 2,
        'dataset': 'easy'}
    for row in ('ours', 'real_pairs_upper_bound',
                'negative_control_label_shuffled'):
        m = result[row]
        assert set(m) == {'RandScore', 'meanIU', 'CE_mean', 'CE_std'}
        assert all(np.isfinite(v) for v in m.values())
        assert 0.0 <= m['RandScore'] <= 1.0 and 0.0 <= m['meanIU'] <= 1.0
        assert m['CE_mean'] > 0.0 and m['CE_std'] >= 0.0


def test_gate_pairs_decode_natively(gate):
    """The sampler wrote its *AB* pairs; each decodes natively (within the
    decoder's scope) to the pixels PIL reads; the control's pairs keep
    their labels."""
    assert gate['proc'].returncode == 0, gate['proc'].stderr[-3000:]
    pairs = sorted(glob.glob(os.path.join(gate['work'], 'gen', 'train',
                                          '*AB*.png')))
    assert len(pairs) == 2
    for p in pairs:
        a = native_io.decode_png(p)
        assert a is not None and a.shape == (128, 128, 3)
        np.testing.assert_array_equal(
            a, np.asarray(Image.open(p).convert('RGB')))
        neg = native_io.decode_png(os.path.join(
            gate['work'], 'gen_neg', 'train', os.path.basename(p)))
        np.testing.assert_array_equal(neg[..., :2], a[..., :2])


def test_parse_ss_metrics_reads_test_ss(jqe, gate):
    """parse_ss_metrics on the port's test_ss output: every metric found,
    as the JAX tool's parser reads it."""
    assert gate['proc'].returncode == 0, gate['proc'].stderr[-3000:]
    for tag in ('ss_test', 'ss_ub_test', 'ss_neg_test'):
        with open(os.path.join(gate['work'], tag + '.log')) as f:
            out = f.read()
        m = qe.parse_ss_metrics(out)
        assert set(m) == {'RandScore', 'meanIU', 'CE_mean', 'CE_std'}
        assert m == jqe.parse_ss_metrics(out)
    assert qe.parse_ss_metrics('nothing here') == {}


def test_import_walk_covers_the_gate_path():
    """tests/test_torch_imports.py's probe walks the decoder's binding, the
    encoder and this driver (imported there without JAX)."""
    names = {m.name for m in pkgutil.walk_packages(
        supervised_gan_tpu_torch.__path__, 'supervised_gan_tpu_torch.')}
    assert {'supervised_gan_tpu_torch.' + n for n in (
        'data.native_io', 'utils.png', 'quality_eval')} <= names
