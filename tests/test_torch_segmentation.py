"""The downstream segmentation gate, `--model segmentation`, of the port on
the CPU against the JAX package's: the four variants of
tests/test_segmentation.py:53-120 (no D; a D bank with the sigmoid head and
--weights 1 2; val mode and the per-image cross entropy; the background
one-hot), each one step at 128 px (unet_128, ngf 4, --no_dropout: the two
packages draw different dropout masks) from one numpy-made parameter set
on one batch; the losses; the host accumulators; and the train_ss and
test_ss entry points.

Tolerances, as tests/test_torch_train_step.py: metrics 1e-5; every gradient
before Adam 1e-4 of the tensor's largest entry, plus 1e-7; every parameter
after Adam 1e-6, plus 2 lr where |g| is below the gradient tolerance.  The
val-mode logits 2e-3, as the unet_128 forward of
tests/test_torch_train_modules.py (InstanceNorm over 2x2 planes).  The
losses 1e-6.  The accumulators (confusion matrix, pixelAcc, meanAcc,
meanIU, the Rand F-score) exactly, on the same predictions.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import base as jbase
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.models import segmentation as jseg
from supervised_gan_tpu.nn import losses as jlosses
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch import test_ss as ttest_ss
from supervised_gan_tpu_torch import train_ss as ttrain_ss
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.models import segmentation as tseg
from supervised_gan_tpu_torch.nn import losses as tlosses
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, rand
from test_torch_layout import one_thread  # noqa: F401

LR = 2e-4
NET = ['--which_direction', 'AtoB', '--which_model_netG', 'unet_128',
       '--ngf', '4', '--noise_nc', '4', '--noiseSize', '4',
       '--norm', 'instance', '--no_dropout']
SEG = NET + ['--which_channel', 'b_rg', '--which_metric', 'RandScore',
             'meanIU']
D_FLAGS = ['--which_model_netD', 'n_layers', '--n_layers_D', '2',
           '--ndf', '4', '--scale_factor', '1', '--lambda_D', '0.5',
           '--no_lsgan']
VARIANTS = {
    'no_D': SEG + ['--which_model_netD', 'None'],
    'D_sigmoid_weights': SEG + D_FLAGS + ['--use_sigmoid_ss',
                                          '--weights', '1', '2'],
    'val_mode_ce': SEG + ['--which_model_netD', 'None',
                          '--noiseSizeVal', '2'],
    'background_onehot': NET + ['--which_channel', 'b_r',
                                '--which_metric', 'meanIU',
                                '--which_model_netD', 'None',
                                '--add_background_onehot',
                                '--add_background_onehot_acc'],
}


def _flags(ckpt, name, extra):
    return ['--dataroot', './datasets/unused', '--name', name,
            '--model', 'segmentation', '--dataset_mode', 'single',
            '--loadSize', '128', '--fineSize', '128', '--batchSize', '1',
            '--manualSeed', '0', '--checkpoints_dir', ckpt,
            '--display_id', '0', '--pool_size', '0', '--lambda_A', '1',
            '--lr', str(LR)] + extra


def _batch():
    """tests/test_segmentation.py make_batch: one-hot-ish label channels."""
    arr = np.random.RandomState(0).uniform(
        -1, 1, (1, 128, 128, 3)).astype(np.float32)
    arr[..., 0] = np.sign(arr[..., 0])
    arr[..., 1] = -arr[..., 0]
    return {'A': arr, 'A_paths': ['x.png']}


def _numpy_init(layer, key):
    """Stands in for the JAX package's jit_init where the test replaces the
    values (its own init runs eagerly, an XLA compile per op)."""
    return jax_params(layer, 0)


def _port_modules(model):
    out = [('G', None, model.netG)]
    if model.use_D:
        out += [('D', str(i), d) for i, d in enumerate(model.netD)]
    return out


def _sub(tree, kind, index):
    return tree[kind] if index is None else tree[kind][index]


def _models(tmp_path, variant):
    flags = _flags(str(tmp_path), variant, VARIANTS[variant])
    jm = jcreate(JTrainOptions().parse(flags))
    params = {'G': jax_params(jm.netG, 80)}
    if jm.use_D:
        params['D'] = {str(i): jax_params(d, 81 + i)
                       for i, d in enumerate(jm.netD)}
    jm.state = dict(jm.state, params=jax.tree_util.tree_map(jnp.asarray,
                                                            params))
    tm = tcreate(TTrainOptions().parse(flags + ['--gpu_ids', '-1']))
    for kind, index, mod in _port_modules(tm):
        mod.load_state_dict(from_jax_params(mod, _sub(params, kind, index)),
                            strict=True)
    jm.set_input(_batch())
    tm.set_input(_batch())
    return jm, tm


def _jax_step(jm, monkeypatch):
    captured = []
    orig = jbase.FlatAdam.apply_updates

    def capture(self, grads, state, p, leaves_lr):
        captured.append(grads)
        return orig(self, grads, state, p, leaves_lr)

    monkeypatch.setattr(jbase.FlatAdam, 'apply_updates', capture)

    def step_with_grads(state, inputs, k, lrs):
        captured.clear()
        new, metrics, _ = jm._raw_step_fn(state, inputs, k, lrs)
        return new, metrics, list(captured)

    new, metrics, grads = jax.jit(step_with_grads)(
        jm.state, jm._step_inputs(), jm.next_step_key(), jm._step_lrs())
    g = {'G': grads[-1]['G']}
    if jm.use_D:
        g['D'] = grads[0]
    return (jax.device_get(metrics), jax.device_get(g),
            jax.device_get(new['params']))


@pytest.fixture
def jax_env(monkeypatch):
    monkeypatch.setenv('SGAN_TPU_PACK_STATE', '0')
    monkeypatch.setattr(sin, '_FMA', False)
    monkeypatch.setattr(jnn, 'jit_init', _numpy_init)
    return monkeypatch


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_segmentation_step_matches_jax(variant, tmp_path, jax_env):
    jm, tm = _models(tmp_path, variant)
    if variant == 'val_mode_ce':
        jm.reset_accs()
        tm.reset_accs()
        for m in (jm, tm):
            m.forward(val_mode=True)
            m.accum_accs()
            m.compute_cross_entropy_loss()
        assert tuple(tm.draw_noise(val=True).shape) == (1, 4, 2, 2)
        np.testing.assert_allclose(nhwc(tm.logit), np.asarray(jm.logit),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(tm.get_current_errors()['G_CE'],
                                   jm.get_current_errors()['G_CE'],
                                   rtol=1e-5)
        for k, v in tm.get_current_accs().items():
            assert 0 <= v <= 1
            np.testing.assert_allclose(v, jm.get_current_accs()[k],
                                       atol=1e-3, err_msg=k)
        return

    metrics, grads, params = _jax_step(jm, jax_env)
    tm.reset_accs()
    tm.optimize_parameters()
    tm.accum_accs()
    ours = tm.get_current_errors()
    assert list(ours) == list(metrics) == (
        ['G_CE', 'G_GAN'] if tm.use_D else ['G_CE'])
    for k, v in ours.items():
        np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if variant == 'background_onehot':
        assert tm.num_classes == 2 and list(tm.get_current_accs()) == [
            'meanIU']
    for kind, index, mod in _port_modules(tm):
        ref = from_jax_params(mod, _sub(params, kind, index))
        g = from_jax_params(mod, _sub(grads, kind, index))
        for name, p in mod.named_parameters():
            r = g[name]
            gtol = 1e-7 + 1e-4 * float(r.abs().max())
            if p.grad is None:          # an inert bias: exactly 0 there
                assert name.endswith('bias') and not r.abs().max() > 0, name
            else:
                err = float((p.grad - r).abs().max())
                assert err <= gtol, (kind, name, err)
            allow = 1e-6 + 2 * LR * (r.abs() < gtol).float()
            assert torch.all((p.detach() - ref[name]).abs() <= allow), \
                (kind, name)
    assert set(tm.get_current_visuals()) == {'image', 'label', 'prediction'}


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5], [1.0, 3.0]])
def test_cross_entropy_2d_matches_jax(weights):
    """With weights, the sum over the targets' summed weights; a label past
    the list takes its last weight, as the JAX gather clamps it."""
    logits = rand((2, 5, 7, 3), 1, 3.0)
    labels = np.random.RandomState(2).randint(0, 3, (2, 5, 7))
    ref = jlosses.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(labels),
                                   weights)
    ours = tlosses.cross_entropy_2d(nchw(logits), torch.from_numpy(labels),
                                    weights)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0]])
def test_sigmoid_bce_matches_jax(weights):
    """The sigmoid head's BCE against the JAX model's _ce, with and without
    the per-class weight map; probabilities at 0 and 1 included (the -100
    log clamps, the 1e-12 floor), and its gradient."""
    p = 1.0 / (1.0 + np.exp(-rand((1, 6, 6, 2), 3, 4.0)))
    p[0, 0, 0, 0], p[0, 0, 1, 1] = 0.0, 1.0
    t = (np.random.RandomState(4).rand(1, 6, 6, 2) > 0.5).astype(np.float32)
    stub = SimpleNamespace(use_sigmoid_ss=True, class_weights=weights)

    def jloss(pp):
        return jseg.SegmentationModel._ce(stub, None, pp, jnp.asarray(t),
                                          None, weighted=True)

    ref, jgrad = jax.value_and_grad(jloss)(jnp.asarray(p))
    pt = nchw(p).requires_grad_(True)
    ours = tlosses.seg_bce_loss(pt, nchw(t), weights)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-6)
    finite = np.isfinite(np.asarray(jgrad))
    np.testing.assert_allclose(nhwc(pt.grad)[finite],
                               np.asarray(jgrad)[finite], rtol=1e-6,
                               atol=1e-9)


def _acc_stubs(background):
    opt = SimpleNamespace(which_metric=['RandScore', 'meanIU'],
                          add_background_onehot_acc=background,
                          add_background_onehot=background)

    class J(jseg.SegAccumulatorMixin):
        pass

    class T(tseg.SegAccumulatorMixin):
        pass

    j, t = J(), T()
    for m in (j, t):
        m.opt, m.num_classes = opt, 2
        m.reset_accs()
    return j, t


@pytest.mark.parametrize("background", [False, True])
def test_accumulators_equal_jax_exactly(background):
    """Two batches of the same predictions into both accumulators: the
    confusion matrix, pixelAcc, meanAcc, meanIU and the Rand F-score
    equal, bit for bit."""
    j, t = _acc_stubs(background)
    rs = np.random.RandomState(5)
    for _ in range(2):
        cls = rs.randint(0, 3 if background else 2, (2, 24, 24))
        onehot = np.eye(3, dtype=np.float32)[cls][..., :2]
        if not background:
            onehot = np.eye(2, dtype=np.float32)[cls]
        logit = rs.randn(2, 24, 24, 2).astype(np.float32)
        prob = np.exp(logit) / np.exp(logit).sum(-1, keepdims=True)
        j.real_B, j.fake_B = jnp.asarray(onehot), jnp.asarray(prob)
        j.logit, j.label = jnp.asarray(logit), jnp.asarray(onehot.argmax(-1))
        t.real_B, t.fake_B = nchw(onehot), nchw(prob)
        t.logit = nchw(logit)
        t.label = torch.from_numpy(onehot.argmax(-1))
        j.accum_accs()
        t.accum_accs()
    np.testing.assert_array_equal(t.confusion, j.confusion)
    for k in ('pixelAcc', 'meanAcc', 'meanIU', 'RandScore',
              'numAveragedPixels', 'numAveragedImages'):
        assert getattr(t, k) == getattr(j, k), k
    assert t.get_current_accs() == j.get_current_accs()


@pytest.mark.parametrize("background", [False, True])
def test_onehot_labels_equal_jax(background):
    """Background pixels tie on every label channel: the first maximum."""
    j, t = _acc_stubs(background)
    b = np.sign(rand((1, 9, 9, 2), 6)).astype(np.float32)
    b[0, :3] = -1.0                                 # background rows
    oj, lj = j.onehot_label_input(b)
    ot, lt = t.onehot_label_input(b)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(lt, lj)
    assert (lt[0, :3] == (2 if background else 0)).all()


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp('ss_data')
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


def test_train_ss_then_test_ss(dataroot, tmp_path, capsys):
    """One epoch of train_ss with validation and the best checkpoint, then
    test_ss on it: the summary printed, each image written."""
    common = ['--dataroot', dataroot, '--name', 'ss', '--model',
              'segmentation', '--dataset_mode', 'single', '--loadSize',
              '128', '--fineSize', '128', '--batchSize', '1', '--manualSeed',
              '0', '--display_id', '0', '--checkpoints_dir',
              str(tmp_path / 'ck'), '--gpu_ids', '-1'] + SEG
    r = ttrain_ss.main(common + [
        '--which_model_netD', 'None', '--lambda_A', '1', '--niter', '1',
        '--niter_decay', '0', '--print_freq', '1', '--save_epoch_freq', '1',
        '--best_metric', 'meanIU', '--nThreads', '1'])
    assert r['steps'] == 2 and len(r['val_accs']) == 1
    assert r['best'] == r['val_accs'][0]['meanIU']
    run = tmp_path / 'ck' / 'ss'
    files = set(os.listdir(run))
    assert {'best_net_G.pth', 'best_state.pt', 'latest_net_G.pth',
            '1_net_G.pth'} <= files
    capsys.readouterr()
    r = ttest_ss.main(common + ['--results_dir', str(tmp_path / 'res'),
                                '--which_epoch', 'best', '--phase', 'test'])
    out = capsys.readouterr().out
    assert 'Segmentation results:' in out and 'RandScore: ' in out \
        and 'meanIU: ' in out and 'cross entropy loss: mean ' in out
    assert r['images'] == 2 and np.isfinite(r['ce_mean'])
    assert all(0 <= v <= 1 for v in r['accs'].values())
    images = sorted(os.listdir(os.path.join(r['web_dir'], 'images')))
    assert images == ['%03d_%s.png' % (i, v) for i in (0, 1)
                      for v in ('image', 'label', 'prediction')]
