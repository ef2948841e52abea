"""The arithmetic of the port's tensor-core k4 s2 conv (csrc/conv4s2.cu),
rehearsed on the CPU.  The kernel is an implicit GEMM whose K is the 16
taps of each input channel: a block stages, per chunk of 8 input channels,
the halo of an 8 x 16 output-pixel tile as it lies in NCHW (rows 2*oy0 - 1
.., values from column 2*ox0 - XV, XV = 4 f32 / 8 bf16 values a 16-byte
vector, zero outside the image), and reads tap (ky, kx) of output pixel
(r, c) at halo row 2r + ky, value 2c + kx + XV - 1.  A bf16 m16n8k16 sums
one channel's 16 taps, an f32 (3xTF32) m16n8k8 the 8 taps of two kernel
rows; chunks are split over blocks as ops/kernels/conv4s2.py ``tc_plan``
says, and the splits' sums are added in order, then the bias.

Here the same staging, tap map, tiles, splits and fold order are emulated
with TF32 rounding done on the float32 bits (``rna_tf32`` and ``split`` of
tests/test_torch_conv3x3_tc.py), and the result is held against the JAX
package: ``lax.conv_general_dilated`` (stride 2, padding 1) at the stems,
ragged shapes, a split site and a wide site at a small side, and
``conv4s2_same`` (the Pallas kernel, in interpret mode) where its gate takes
the shape.

Tolerance: 1e-5 of the largest |y| for 3xTF32 (f32 sums in another order;
the card's check is 1e-4 abs + 1e-4 rel), and for bf16 inputs, whose
products are exact in f32, against the f32 conv of the same bf16 values.
One TF32 product a MAC (plain TF32) lands outside the card's 1e-4, which is
why the kernel splits.  Emulated here (CPU, float32): 3xTF32 lands within
4.5e-7 of the largest |y| of the XLA conv at every shape below, plain TF32
2.6e-4 to 3.8e-4 of it off."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu.ops.pallas import conv4s2 as p4
from supervised_gan_tpu_torch.ops.kernels import conv4s2_plain

from test_torch_conv3x3_tc import rna_tf32, split
from test_torch_layout import conv_w, nchw, nhwc, rand

mod = importlib.import_module('supervised_gan_tpu_torch.ops.kernels.conv4s2')
TH, TW, BN, KC = mod.TILE_ROWS, mod.TILE_COLS, mod.CO_BLOCK, mod.CI_CHUNK
HALO_H = 2 * TH + 2
XV = {torch.float32: 4, torch.bfloat16: 8}
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}

# (N, H, W, Ci, Co): a D stem, a unet stem and the 2-channel dx of F2's
# last transposed conv (Ci 1-3), ragged channels and odd sides with N = 2,
# a deep site with 4^2 outputs and a split of its chunks, a wide site at a
# small side
SHAPES = [(1, 32, 32, 3, 64), (1, 16, 16, 1, 32), (1, 32, 32, 2, 32),
          (2, 13, 9, 5, 7), (2, 11, 15, 17, 70), (1, 8, 8, 64, 64),
          (1, 32, 32, 128, 128)]
# (N, H, W, Ci, Co): the 25 shapes of the train step's 27 sites (bench.py
# DSGAN, 512 px; two shapes come with and without a bias)
TRAIN_SITES = [(1, s, s, ci, co) for s, ci, co in (
    (512, 1, 32), (256, 32, 64), (128, 64, 128), (64, 128, 256),
    (32, 256, 256), (16, 256, 256), (8, 256, 256), (256, 2, 32),
    (128, 32, 64), (64, 64, 128), (128, 2, 32), (64, 32, 64), (32, 64, 128),
    (512, 3, 64), (256, 64, 128), (128, 128, 256), (64, 256, 512),
    (256, 3, 64), (32, 256, 512), (512, 2, 64), (256, 32, 128),
    (128, 64, 256), (64, 128, 512), (16, 256, 512), (32, 128, 256))]


def out_side(h):
    return (h - 2) // 2 + 1


def stage(x, xv):
    """The staged halos of every tile: (N, Ci, tiles_h, tiles_w, HALO_H,
    2*TW + 2*xv), halo row hy of tile (i, j) being input row
    2*TH*i - 1 + hy and value e input column 2*TW*j - xv + e, zero outside
    the image."""
    n, ci, h, w = x.shape
    th, tw = -(-out_side(h) // TH), -(-out_side(w) // TW)
    xp = torch.zeros((n, ci, 2 * TH * th + 2, 2 * TW * tw + 2 * xv))
    xp[:, :, 1:1 + h, xv:xv + w] = x
    return (xp.unfold(2, HALO_H, 2 * TH).unfold(3, 2 * TW + 2 * xv, 2 * TW))


def tap_index(xv):
    """The kernel's tap map: halo row 2r + ky of output row r, value
    2c + kx + xv - 1 of output column c; (TH, 4) and (TW, 4)."""
    rows = 2 * torch.arange(TH)[:, None] + torch.arange(4)[None, :]
    cols = 2 * torch.arange(TW)[:, None] + torch.arange(4)[None, :] + xv - 1
    return rows, cols


def a_operand(x, xv):
    """A of every tile: (N, Ci, tiles_h, tiles_w, TH, TW, 16 taps), tap
    ky * 4 + kx, gathered from the staged halos by the tap map."""
    raw = stage(x, xv)
    rows, cols = tap_index(xv)
    a = raw[:, :, :, :, rows[:, :, None, None], cols[None, None, :, :]]
    return a.permute(0, 1, 2, 3, 4, 6, 5, 7).flatten(-2)


def _dot(a, b):
    return torch.einsum('nhwrct,ot->nhwrco', a, b)


def _3xtf32(acc, a, b):
    """acc + lo*hi, then + hi*lo, then + hi*hi: one accumulator's order."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ((acc + _dot(al, bh)) + _dot(ah, bl)) + _dot(ah, bh)


def _1xtf32(acc, a, b):
    return acc + _dot(rna_tf32(a), rna_tf32(b))


def _exact(acc, a, b):
    return acc + _dot(a, b)


def kernel_y(x, w, b, dtype, step=None):
    """y as the kernel sums it, for NCHW f32 tensors holding the values the
    kernel is given (bf16 values for bf16 inputs); f32 result."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    if step is None:
        step = _3xtf32 if dtype == torch.float32 else _exact
    a = a_operand(x, XV[dtype])
    wt = w.reshape(co, ci, 16)
    ksteps = [range(0, 8), range(8, 16)] if dtype == torch.float32 \
        else [range(16)]
    sums = []
    for k0, k1 in mod.tc_plan(n, ci, co, h, wd):
        acc = torch.zeros(a.shape[:1] + a.shape[2:6] + (co,))
        for c in range(k0 * KC, min(ci, k1 * KC)):
            for taps in ksteps:
                acc = step(acc, a[:, c][..., list(taps)],
                           wt[:, c][:, list(taps)])
        sums.append(acc)
    if len(sums) == 1:
        y = sums[0]
    else:
        y = torch.zeros_like(sums[0])
        for s in sums:
            y = y + s
    if b is not None:
        y = y + b
    # (N, th, tw, TH, TW, Co) -> (N, Co, Ho, Wo)
    y = y.permute(0, 5, 1, 3, 2, 4).reshape(n, co, y.shape[1] * TH,
                                            y.shape[2] * TW)
    return y[:, :, :out_side(h), :out_side(wd)]


def inputs(shape, seed, dtype):
    """NHWC / HWIO numpy inputs (rounded to bf16 for bf16) and their NCHW /
    OIHW tensors."""
    n, h, w, ci, co = shape
    x = rand((n, h, w, ci), seed)
    wt = rand((4, 4, ci, co), seed + 1, (16 * ci) ** -0.5)
    b = rand((co,), seed + 2, 0.1)
    if dtype == torch.bfloat16:
        x, wt = (torch.from_numpy(a).bfloat16().float().numpy()
                 for a in (x, wt))
    return x, wt, b, nchw(x), conv_w(wt), torch.from_numpy(b)


def xla_conv(x, w, b):
    """The JAX package's reference op: lax.conv_general_dilated, stride 2,
    padding 1, NHWC / HWIO, f32 at full precision."""
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        precision=jax.lax.Precision.HIGHEST)
    return np.asarray(y + jnp.asarray(b))


def rel_err(y, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(nhwc(y) - ref).max() / np.abs(ref).max())


@pytest.fixture
def interpret():
    p3._set_interpret(True)
    yield
    p3._set_interpret(False)


@pytest.mark.parametrize('shape', TRAIN_SITES + SHAPES)
def test_plan_splits_every_chunk_once(shape):
    """tc_plan's splits cover the chunks in order, each once, none empty,
    all of one size but the last; the grid stays within RESIDENT blocks
    when it is split, and is split when a split fits."""
    n, h, w, ci, co = shape
    bounds = mod.tc_plan(n, ci, co, h, w)
    chunks = -(-ci // KC)
    assert bounds[0][0] == 0 and bounds[-1][1] == chunks
    assert all(p[1] == q[0] for p, q in zip(bounds, bounds[1:]))
    assert all(e > s for s, e in bounds)
    per = bounds[0][1] - bounds[0][0]
    assert all(e - s == per for s, e in bounds[:-1])
    blocks = (-(-out_side(h) // TH) * -(-out_side(w) // TW)
              * -(-co // BN) * n)
    assert len(bounds) == 1 or blocks * len(bounds) <= mod.RESIDENT
    if chunks > 1 and 2 * blocks <= mod.RESIDENT:
        assert len(bounds) > 1


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[3], SHAPES[4],
                                   (1, 2, 2, 3, 5)])
def test_tap_map_reads_the_padded_input(shape, dtype):
    """Every tap the kernel reads from its staged halo is x padded by 1 at
    (2 oy + ky, 2 ox + kx), inside the staged row; for bf16 each register's
    tap pair (kx, kx + 1), kx even, starts at an odd value of the row, so it
    is read as two 16-bit halves."""
    n, h, w, ci, _ = shape
    x = torch.from_numpy(rand((n, ci, h, w), 4))
    xv = XV[dtype]
    rows, cols = tap_index(xv)
    assert int(rows.max()) < HALO_H and int(cols.max()) < 2 * TW + 2 * xv
    assert int(cols.min()) >= 0
    if dtype == torch.bfloat16:
        assert bool((cols[:, 0::2] % 2 == 1).all())
    a = a_operand(x, xv)
    ho, wo = out_side(h), out_side(w)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    for ky in range(4):
        for kx in range(4):
            want = xp[:, :, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2]
            got = a[..., ky * 4 + kx].permute(0, 1, 2, 4, 3, 5).reshape(
                n, ci, a.shape[2] * TH, a.shape[3] * TW)[:, :, :ho, :wo]
            assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize('shape', SHAPES)
def test_emulated_kernel_matches_xla_conv(shape, dtype):
    x, w, b, xt, wt, bt = inputs(shape, 3, dtype)
    ref = xla_conv(x, w, b)
    y = kernel_y(xt, wt, bt, dtype)
    assert rel_err(y, ref) <= 1e-5
    plain = conv4s2_plain(xt, wt, bt)
    assert float((y - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
def test_emulated_kernel_matches_pallas_interpret(interpret, dtype):
    """At 64 -> 64 on 32^2 (a split of the chunks), against the Pallas
    kernel of the JAX package run in interpret mode."""
    x, w, b, xt, wt, bt = inputs((1, 32, 32, 64, 64), 5, dtype)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    assert p4.supported(xj, wj, 2, 1)
    assert len(mod.tc_plan(1, 64, 64, 32, 32)) > 1
    ref = np.asarray(p4.conv4s2_same(xj, wj, jnp.asarray(b)))
    assert rel_err(kernel_y(xt, wt, bt, dtype), ref) <= 1e-5


@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[5], SHAPES[6]])
def test_plain_tf32_misses_the_f32_tolerance(shape):
    """Why the kernel splits: one TF32 product a MAC keeps ~3 digits and
    lands outside the card's 1e-4 check; 3xTF32 within 1e-5 of the largest
    |y|."""
    x, w, b, xt, wt, bt = inputs(shape, 7, torch.float32)
    ref = xla_conv(x, w, b)
    assert rel_err(kernel_y(xt, wt, bt, torch.float32), ref) <= 1e-5
    y1 = kernel_y(xt, wt, bt, torch.float32, _1xtf32)
    assert rel_err(y1, ref) > 1e-4
    r = torch.from_numpy(np.array(ref))
    assert not bool(((torch.from_numpy(nhwc(y1)) - r).abs()
                     <= 1e-4 + 1e-4 * r.abs()).all())
