"""The resnet generators (resnet_6blocks, resnet_9blocks) and `--model
test` of the port on the CPU against the JAX package's.

The nets at ngf 4 on a 32 px, 3-channel input, from one numpy-made
parameter set: the forward within 1e-4, and through jax.vjp the gradient of
every parameter and of the input (1e-4 of the tensor's largest entry, plus
1e-7), with and without --use_residual (tanh(x + y) there, and the model's
own Tanh and the forward's tanh both without: the double tanh is the
reference's and the JAX package's).  The smallest InstanceNorm plane is
8x8.  The state_dict keys are the torch reference's, so the JAX package's
utils/pth.py files load strictly.

TestModel (--model test, --dataset_mode single, resnet_9blocks) on a
JAX-written latest_net_G.pth: set_input, test() and the visuals against
the JAX model's on the same batch (1e-4).  Through the sampler entry point
`--model test` takes the unconditional branch, as the JAX package's
test.py:37-57 does: it calls test() with no input set, which raises
AttributeError in both packages; the recipe is driven through the model
API.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.models import create_model as jcreate
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu.options import TestOptions as JTestOptions
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch import test as ttest
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TestOptions as TTestOptions
from supervised_gan_tpu_torch.utils.weights import from_jax_params

from test_torch_layout import jax_params, nchw, nhwc, one_thread  # noqa

PX = 32
CASES = [('resnet_6blocks', False), ('resnet_9blocks', False),
         ('resnet_6blocks', True)]


def _nets(name, residual):
    j = jnn.define_G(3, 3, 4, name, 'instance', False, use_residual=residual)
    t = tnn.define_G(3, 3, 4, name, 'instance', False, use_residual=residual)
    return j, t


@pytest.mark.parametrize('name,residual', CASES)
def test_forward_and_vjp_match_jax(name, residual, monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    j, t = _nets(name, residual)
    params = jax_params(j, 40)
    t.load_state_dict(from_jax_params(t, params), strict=True)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (1, PX, PX, 3)).astype(np.float32)
    ct = rng.standard_normal((1, PX, PX, 3)).astype(np.float32)

    def fwd(p, xx):
        return j.apply(p, xx, jnn.Ctx(jax.random.PRNGKey(0)))

    y, pull = jax.vjp(fwd, jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(x))
    gp, gx = jax.device_get(pull(jnp.asarray(ct)))

    xt = nchw(x).requires_grad_(True)
    yt = t(xt)
    (yt * nchw(ct)).sum().backward()
    np.testing.assert_allclose(nhwc(yt), np.asarray(y), rtol=1e-4,
                               atol=1e-4)
    gx_ref = nchw(gx)
    assert float((xt.grad - gx_ref).abs().max()) <= (
        1e-7 + 1e-4 * float(gx_ref.abs().max()))
    ref = from_jax_params(t, gp)
    for n, p in t.named_parameters():
        if p.grad is None:              # an inert bias: exactly 0 there
            assert n.endswith('bias') and not ref[n].abs().max() > 0, n
            continue
        err = float((p.grad - ref[n]).abs().max())
        assert err <= 1e-7 + 1e-4 * float(ref[n].abs().max()), (n, err)


def test_structure_and_keys_match_jax(tmp_path):
    """Parameter counts, the reference's state_dict keys, the blocks'
    reflect pads, and a .pth written by either package loading strictly
    into the other."""
    for blocks in (6, 9):
        j, t = _nets('resnet_%dblocks' % blocks, False)
        params = jax_params(j, 41)
        assert tnn.count_params(t) == sum(
            np.asarray(a).size for a in jax.tree_util.tree_leaves(params))
        blocks_t = [m for m in t.modules()
                    if type(m).__name__ == 'ResnetBlock']
        assert len(blocks_t) == blocks
        pads = [m.padding for m in t.modules()
                if isinstance(m, tnn.ReflectionPad2d)]
        assert pads == [3] + [1, 1] * blocks + [3]
        path = str(tmp_path / ('j%d.pth' % blocks))
        jpth.save_pth(path, j, params)
        t.load_state_dict(torch.load(path), strict=True)
        ref = from_jax_params(t, params)
        for n, p in t.named_parameters():
            assert torch.equal(p.detach(), ref[n]), n
        back = str(tmp_path / ('t%d.pth' % blocks))
        torch.save(t.state_dict(), back)
        loaded = jpth.load_pth(back, j)
        for a, b in zip(jax.tree_util.tree_leaves(loaded),
                        jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _test_flags(ckpt):
    return ['--dataroot', './datasets/unused', '--name', 'rn', '--model',
            'test', '--dataset_mode', 'single', '--which_model_netG',
            'resnet_9blocks', '--ngf', '4', '--norm', 'instance',
            '--no_dropout', '--loadSize', str(PX), '--fineSize', str(PX),
            '--checkpoints_dir', ckpt, '--display_id', '0']


def test_test_model_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    ckpt = str(tmp_path / 'ck')
    os.makedirs(os.path.join(ckpt, 'rn'))
    j, _ = _nets('resnet_9blocks', False)
    jpth.save_pth(os.path.join(ckpt, 'rn', 'latest_net_G.pth'), j,
                  jax_params(j, 42))
    batch = {'A': np.random.RandomState(2).uniform(
        -1, 1, (1, PX, PX, 3)).astype(np.float32), 'A_paths': ['x.png']}
    jm = jcreate(JTestOptions().parse(_test_flags(ckpt)))
    tm = tcreate(TTestOptions().parse(_test_flags(ckpt) + ['--gpu_ids',
                                                           '-1']))
    assert tm.name() == 'TestModel'
    for m in (jm, tm):
        m.set_input(batch)
        m.test()
    np.testing.assert_allclose(nhwc(tm.fake_B), np.asarray(jm.fake_B),
                               rtol=1e-4, atol=1e-4)
    assert tm.get_image_paths() == ['x.png']
    ours, ref = tm.get_current_visuals(), jm.get_current_visuals()
    assert list(ours) == list(ref) == ['real_A', 'fake_B']
    np.testing.assert_array_equal(ours['real_A'], ref['real_A'])
    assert np.abs(ours['fake_B'].astype(int)
                  - ref['fake_B'].astype(int)).max() <= 1

    with pytest.raises(AttributeError, match='input_A'):
        ttest.main(_test_flags(ckpt) + ['--gpu_ids', '-1', '--how_many',
                                        '1', '--results_dir',
                                        str(tmp_path / 'res')])
    with pytest.raises(ValueError, match='single'):
        tcreate(TTestOptions().parse(_test_flags(ckpt) + [
            '--gpu_ids', '-1', '--dataset_mode', 'aligned']))
