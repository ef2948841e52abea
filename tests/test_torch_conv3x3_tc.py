"""The arithmetic of the port's tensor-core conv3x3 (csrc/conv3x3_mma.cuh),
rehearsed on the CPU.  On the card an f32 conv3x3 runs as 3xTF32: each
operand v is split into hi = rna_tf32(v) and lo = rna_tf32(v - hi)
(cvt.rna.tf32.f32: round to nearest, ties away from zero, 10 mantissa
bits kept), and lo*hi + hi*lo + hi*hi is accumulated in f32.  Here the
rounding is emulated on the float32 bits and the three products are summed
by the plain version's einsums.

The card's check holds every f32 kernel to 1e-4 abs + 1e-4 rel of the plain
version (chip_smoke.py); 3xTF32 stays within 1e-5 of the largest |y| here,
one TF32 product a MAC (plain TF32) does not stay within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu_torch.ops.kernels import conv3x3_plain
from supervised_gan_tpu_torch.ops.kernels.conv3x3 import conv3x3_plain_f32

SHAPES = [(64, 64, 16), (64, 64, 32), (128, 64, 16), (128, 64, 32)]


def rna_tf32(t):
    """cvt.rna.tf32.f32 on float32 bits: add half a TF32 ulp to the
    magnitude (the sign bit is apart, so ties go away from zero), then clear
    the 13 low mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(t):
    hi = rna_tf32(t)
    return hi, rna_tf32(t - hi)


def conv_1xtf32(x, w, b):
    return conv3x3_plain_f32(rna_tf32(x), rna_tf32(w), b)


def conv_3xtf32(x, w, b):
    """The kernel's three products a MAC, small terms first, bias last."""
    (xh, xl), (wh, wl) = split(x), split(w)
    y = conv3x3_plain_f32(xl, wh) + conv3x3_plain_f32(xh, wl)
    return y + conv3x3_plain_f32(xh, wh, b)


def inputs(ci, co, side, seed):
    """x ~ N(0, 1), w scaled to keep y O(1) and b ~ 0.1 N(0, 1), as the
    card's checks draw them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, ci, side, side).astype(np.float32)
    w = (rng.randn(co, ci, 3, 3) * (9 * ci) ** -0.5).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


def within(a, b, tol):
    """chip_smoke.py's kernel check: |a - b| <= tol + tol * |b| everywhere."""
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def test_rna_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    v = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 3.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(rna_tf32(v), want)
    r = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32)) * 100
    hi, lo = split(r)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11
    # hi + lo keeps ~21 bits: the split loses ~2^-22 of each operand
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("ci,co,side", SHAPES)
def test_3xtf32_keeps_f32_accuracy(ci, co, side):
    x, w, b = inputs(ci, co, side, ci + side)
    ref = conv3x3_plain(x, w, b)
    y = conv_3xtf32(x, w, b)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 1e-5 * scale
    assert within(y, ref, 1e-4)


@pytest.mark.parametrize("ci,co,side", SHAPES)
def test_plain_tf32_misses_the_f32_tolerance(ci, co, side):
    """Why the kernel splits: one TF32 product a MAC keeps ~3 digits, so it
    fails the card's f32 check of 1e-4."""
    x, w, b = inputs(ci, co, side, ci + side)
    ref = conv3x3_plain(x, w, b)
    y = conv_1xtf32(x, w, b)
    assert not within(y, ref, 1e-4)
    assert float((y - ref).abs().max()) > 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("ci,co,side", [(64, 64, 16), (128, 64, 16)])
def test_3xtf32_matches_jax_conv(ci, co, side):
    """The emulated 3xTF32 conv against the JAX package's conv2d (XLA, f32
    on the CPU), in its NHWC / HWIO layout."""
    x, w, b = inputs(ci, co, side, 7 * ci + side)
    yj = jconv.conv2d(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                      jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
                      jnp.asarray(b.numpy()), 1, 1)
    y = conv_3xtf32(x, w, b).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, np.asarray(yj), rtol=1e-4, atol=1e-4)
