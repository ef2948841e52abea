"""Boundary helpers shared by the port's tests (the JAX package is NHWC with
HWIO / pre-flipped HWIO kernels; the port is NCHW with torch weight
layouts), a check that they map the two sides onto each other, and the
golden layouts of the stage-1 label GAN's networks (the files the
sequential hand-off loads strictly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu import nn as jnn
from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu.utils import pth as jpth
from supervised_gan_tpu.utils.pth import param_kind_tree
from supervised_gan_tpu_torch import nn as tnn
from supervised_gan_tpu_torch.ops.kernels import conv3x3, convt4s2


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """The port's CPU ops on one thread while a module that imports this
    fixture runs: the suite runs six workers on fewer cores, where torch's
    default thread pool per worker made the port's steps several times
    slower, and its neighbours too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    """NHWC array (numpy or jax) -> NCHW float torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, dtype=np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC float32 numpy array."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def conv_w(w_hwio):
    """JAX conv kernel HWIO -> torch (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1)))


def convt_w(w_flipped_hwio):
    """JAX ConvTranspose kernel (pre-flipped HWIO) -> torch (I, O, kh, kw)."""
    a = np.asarray(w_flipped_hwio, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 3, 0, 1)))


def vec(b):
    return None if b is None else torch.from_numpy(np.asarray(b, np.float32))


def assert_sum_close(ours, ref, rtol=1e-4, atol=1e-5):
    """max |ours - ref| <= atol + rtol * max |ref|: for results that sum many
    f32 products (weight gradients over every pixel), whose rounding scales
    with the sums' magnitude rather than each entry's own."""
    ours = np.asarray(ours.detach() if hasattr(ours, 'detach') else ours,
                      np.float64)
    ref = np.asarray(ref.detach() if hasattr(ref, 'detach') else ref,
                     np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= atol + rtol * np.abs(ref).max(), err


def rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def jax_params(net, seed):
    """A parameter tree of the JAX package's layer ``net`` (its structure,
    shapes and layouts) filled from numpy: conv kernels N(0, 0.02)-like,
    BatchNorm weights near 1, biases small.  Shapes come from
    jax.eval_shape, which traces init without running it."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    kinds = param_kind_tree(net)
    rs = np.random.RandomState(seed)

    def fill(shape_tree, kind_tree):
        out = {}
        for k, v in shape_tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, kind_tree[k])
                continue
            z = rs.randn(*v.shape).astype(np.float32)
            kind = kind_tree[k]
            out[k] = (1.0 + 0.02 * z if kind == 'bn'
                      else 0.1 * z if kind == 'bias' else 0.05 * z)
        return out

    return fill(shapes, kinds)


def test_layout_helpers_map_both_sides():
    """Non-square, unequal-channel inputs: a transposed axis or a wrongly
    flipped kernel would show up as a mismatch (tolerance 1e-4: f32 sums
    in another order)."""
    x = rand((1, 6, 10, 3), 0)
    w = rand((3, 3, 3, 5), 1, 0.2)
    b = rand((5,), 2, 0.1)
    y = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1, 1)
    np.testing.assert_allclose(nhwc(conv3x3(nchw(x), conv_w(w), vec(b))),
                               np.asarray(y), rtol=1e-4, atol=1e-4)
    wt = rand((4, 4, 3, 5), 3, 0.2)
    yt = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(wt), None, 2, 1)
    np.testing.assert_allclose(nhwc(convt4s2(nchw(x), convt_w(wt))),
                               np.asarray(yt), rtol=1e-4, atol=1e-4)
    assert np.array_equal(nhwc(nchw(x)), x)
    assert jax.default_backend() == 'cpu'


# The stage-1 label GAN of the README workflow (tools/recipe_r05.py:71-84):
# G deconv ngf 32 x 5 layers from 8 noise channels, rg (2 channels); its
# D bank n_layers 3 ndf 32 at scales 1, 2, 4, BCE (sigmoid heads).
STAGE1_NETS = {
    'G': (lambda m: m.define_G(2, 0, 32, 'deconv', 'instance', False,
                               n_layers_G=5, use_fcn=True, noise_nc=8),
          1772448),
    'G_dropout': (lambda m: m.define_G(2, 0, 32, 'deconv', 'instance', True,
                                       n_layers_G=5, use_fcn=True,
                                       noise_nc=8), 1772448),
    'D_0': (lambda m: m.define_D(2, 32, 'n_layers', 3, 'instance', True, 1),
            693729),
    'D_1': (lambda m: m.define_D(2, 32, 'n_layers', 3, 'instance', True, 2),
            693729),
    'D_2': (lambda m: m.define_D(2, 32, 'n_layers', 3, 'instance', True, 4),
            693729),
}


def _torch_layout_shape(path, shape, module):
    """The torch shape of a JAX parameter of ``module``'s layer at path."""
    owner = dict(module.named_modules())[path.rpartition('.')[0]]
    if path.endswith('weight') and isinstance(owner, tnn.ConvTranspose2d):
        return (shape[2], shape[3], shape[0], shape[1])
    if path.endswith('weight') and isinstance(owner, tnn.Conv2d):
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(shape)


@pytest.mark.parametrize("name", sorted(STAGE1_NETS))
def test_stage1_golden_layout(tmp_path, name):
    """Keys, shapes and parameter counts of the port's net equal the JAX
    package's parameter tree, and its state_dict keys those of the .pth
    file the JAX package writes (what strict loading checks)."""
    build, golden = STAGE1_NETS[name]
    jnet, tnet = build(jnn), build(tnn)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    flat = {'.'.join(str(k.key) for k in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ours = {k: tuple(p.shape) for k, p in tnet.named_parameters()}
    assert ours == {k: _torch_layout_shape(k, v, tnet)
                    for k, v in flat.items()}
    assert tnn.count_params(tnet) == jnn.count_params(shapes) == golden
    path = str(tmp_path / 'net.pth')
    jpth.save_pth(path, jnet, jax_params(jnet, 0))
    assert set(tnet.state_dict()) == set(torch.load(path, weights_only=True))
