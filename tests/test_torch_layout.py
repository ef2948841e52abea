"""Boundary helpers shared by the port's tests (the JAX package is NHWC with
HWIO / pre-flipped HWIO kernels; the port is NCHW with torch weight
layouts), and a check that they map the two sides onto each other."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu.utils.pth import param_kind_tree
from supervised_gan_tpu_torch.ops.kernels import conv3x3, convt4s2


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
