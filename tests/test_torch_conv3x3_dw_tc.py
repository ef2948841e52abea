"""The arithmetic of the port's tensor-core conv3x3 weight gradient
(csrc/conv3x3_dw.cu), rehearsed on the CPU.  The kernel cuts the pixel sum
into 4 x 32 pixel tiles and splits the tiles over blocks
(ops/kernels/conv3x3_dw.py ``tc_plan``): each split sums its tiles in
order, and the splits' sums are added in order.  Its products are bf16 x
bf16, exact in f32, or for f32 inputs 3xTF32: each operand v split into
hi = rna_tf32(v) and lo = rna_tf32(v - hi) and lo*hi + hi*lo + hi*hi
accumulated in f32.  Here the same tiles, splits and fold order are
emulated with TF32 rounding done on the float32 bits (``rna_tf32`` and
``split`` of tests/test_torch_conv3x3_tc.py), and the result is held
against the JAX package: ``_dw_9dot`` at the CRN's site shapes at narrow
sizes and a ragged batch of 2, and ``_conv3x3_dw_v2`` (the Pallas dW
kernel, in interpret mode) where its gate takes the shape.

Tolerance: 1e-4 of the largest |dW| (the card's check, chip_smoke.py
``within_sum``), since each entry sums N*H*W products in another order.
Emulated here (CPU, float32): 3xTF32 lands within 1.6e-6 of the largest
|dW| of ``_dw_9dot`` at every shape below, as close as the plain f32
version; one TF32 product a MAC (plain TF32) lands 2.7e-4 to 3.7e-4 of it
off, outside the card's check, which is why the kernel splits."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu_torch.ops.kernels import conv3x3_dw_plain

from test_torch_conv3x3_tc import rna_tf32, split
from test_torch_layout import conv_w, nchw, rand

dwmod = importlib.import_module(
    'supervised_gan_tpu_torch.ops.kernels.conv3x3_dw')

# (N, H, W, Ci, Co): the CRN's dW sites (label block 2->64, stem 10->64,
# the bilinear blocks' 128->64, the trunk's 64->64, the head 64->1) at
# narrow sizes, and a ragged batch of 2
SHAPES = [(1, 16, 16, 2, 64), (1, 8, 8, 10, 64), (1, 16, 32, 128, 64),
          (1, 32, 32, 64, 64), (1, 32, 64, 64, 1), (2, 9, 13, 5, 7)]
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}
TR, TW = dwmod.TILE_ROWS, dwmod.TILE_COLS


def _tiles(t, th, tw):
    """(N, C, th, tw) -> (tiles, C, TR * TW) in the kernel's tile order."""
    n, c = t.shape[:2]
    t = t.reshape(n, c, th // TR, TR, tw // TW, TW)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(-1, c, TR * TW)


def tile_products(x, g, products):
    """Each tile's contribution to dW, (tiles, Co, Ci, 9) f32: for each tap,
    products(g tile, shifted x tile) summed over the tile's pixels; pixels
    past the image are zero, as the kernel stages them."""
    n, ci, h, w = x.shape
    co = g.shape[1]
    th, tw = -(-h // TR) * TR, -(-w // TW) * TW
    xp = torch.zeros((n, ci, th + 2, tw + 2))
    xp[:, :, 1:h + 1, 1:w + 1] = x
    gp = torch.zeros((n, co, th, tw))
    gp[:, :, :h, :w] = g
    gt = _tiles(gp, th, tw)
    return torch.stack([products(gt, _tiles(xp[:, :, ky:ky + th, kx:kx + tw],
                                            th, tw))
                        for ky in range(3) for kx in range(3)], dim=-1)


def fold(parts, bounds):
    """Split s adds its tiles in order; the splits' sums are then added in
    order from 0, unless there is one split (its sum is dW)."""
    sums = []
    for beg, end in bounds:
        acc = torch.zeros(parts.shape[1:])
        for t in range(beg, end):
            acc = acc + parts[t]
        sums.append(acc)
    if len(sums) == 1:
        return sums[0]
    out = torch.zeros(parts.shape[1:])
    for s in sums:
        out = out + s
    return out


def _dot(a, b):
    return torch.einsum('tok,tik->toi', a, b)


def _3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return _dot(al, bh) + _dot(ah, bl) + _dot(ah, bh)


def _1xtf32(a, b):
    return _dot(rna_tf32(a), rna_tf32(b))


def kernel_dw(x, g, dtype, products=None):
    """dW as the kernel sums it, for NCHW f32 tensors x and g holding the
    values the kernel is given (bf16 values for bf16 inputs)."""
    n, ci, h, w = x.shape
    if products is None:
        products = _3xtf32 if dtype == torch.float32 else _dot
    _, bounds = dwmod.tc_plan(n, ci, g.shape[1], h, w, dtype)
    out = fold(tile_products(x, g, products), bounds)
    return out.reshape(g.shape[1], ci, 3, 3)


def inputs(shape, seed, dtype):
    """NHWC numpy inputs (rounded to bf16 for bf16) and their NCHW tensors."""
    n, h, w, ci, co = shape
    x, g = rand((n, h, w, ci), seed), rand((n, h, w, co), seed + 1)
    if dtype == torch.bfloat16:
        x, g = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, g))
    return x, g, nchw(x), nchw(g)


def rel_err(a, ref):
    ref = torch.as_tensor(np.asarray(ref, np.float32))
    return float((a - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize('shape', SHAPES + [(1, 128, 128, 64, 64),
                                            (1, 512, 512, 64, 64),
                                            (1, 512, 512, 64, 1)])
def test_plan_splits_every_tile_once(shape, dtype):
    """tc_plan's splits cover the tiles in order, each once, none empty,
    and fill the card's 132 SMs when there are tiles enough."""
    n, h, w, ci, co = shape
    tiles, bounds = dwmod.tc_plan(n, ci, co, h, w, dtype)
    assert len(tiles) == n * -(-h // TR) * -(-w // TW)
    assert bounds[0][0] == 0 and bounds[-1][1] == len(tiles)
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert all(end > beg for beg, end in bounds)
    blocks = (-(-co // dwmod.CO_BLOCK) * -(-ci // dwmod.CI_BLOCK)
              * len(bounds))
    assert blocks >= min(dwmod.SMS, len(tiles))


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize('shape', SHAPES)
def test_split_sum_matches_jax_dw_9dot(shape, dtype):
    x, g, xt, gt = inputs(shape, 3, dtype)
    ref = conv_w(np.asarray(p3._dw_9dot(jnp.asarray(x), jnp.asarray(g))))
    dw = kernel_dw(xt, gt, dtype)
    assert rel_err(dw, ref) <= 1e-4
    assert rel_err(dw, conv3x3_dw_plain(xt, gt)) <= 1e-4
    if dtype == torch.float32:
        assert rel_err(dw, ref) <= 1e-5


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
def test_split_sum_matches_pallas_dw_v2_interpret(dtype):
    """At 64 -> 64 on 128^2 (128 tiles, several splits), against the Pallas
    dW kernel of the JAX package run in interpret mode."""
    x, g, xt, gt = inputs((1, 128, 128, 64, 64), 5, dtype)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    assert p3.dw_v2_supported(xj, gj)
    _, bounds = dwmod.tc_plan(1, 64, 64, 128, 128, dtype)
    assert len(bounds) > 1
    p3._set_interpret(True)
    try:
        ref = conv_w(np.asarray(p3._conv3x3_dw_v2(xj, gj)))
    finally:
        p3._set_interpret(False)
    assert rel_err(kernel_dw(xt, gt, dtype), ref) <= 1e-4


@pytest.mark.parametrize('shape', [SHAPES[2], SHAPES[3], SHAPES[4]])
def test_plain_tf32_misses_the_f32_tolerance(shape):
    """Why the kernel splits: one TF32 product a MAC keeps ~3 digits of
    each product and lands outside the card's 1e-4 check, 3xTF32 inside
    1e-5 (module docstring)."""
    x, g, xt, gt = inputs(shape, 7, torch.float32)
    ref = conv_w(np.asarray(p3._dw_9dot(jnp.asarray(x), jnp.asarray(g))))
    assert rel_err(kernel_dw(xt, gt, torch.float32), ref) <= 1e-5
    assert rel_err(kernel_dw(xt, gt, torch.float32, _1xtf32), ref) > 1e-4
