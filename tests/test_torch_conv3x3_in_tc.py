"""The arithmetic of the port's tensor-core conv3x3 + InstanceNorm statistics
kernel (csrc/conv3x3_in.cu), rehearsed on the CPU.

On the card the convolution is conv3x3's implicit GEMM (f32 as 3xTF32, see
tests/test_torch_conv3x3_tc.py), and the statistics come from its f32
accumulator, bias added, in an order fixed by the shape:
  * a lane sums its 4 values of a channel, rows mt = 0, 1 of its warp and
    columns lane / 4 + 8 * jr, in the order (mt, jr) = (0, 0), (0, 1),
    (1, 0), (1, 1), and their squares, each rounded before it is added;
  * xor shuffles by 4, 8 and 16 add the 8 lanes of one channel pair: lane
    groups g = lane / 4 as ((g0 + g1) + (g2 + g3)) + ((g4 + g5) + (g6 + g7));
  * the 4 warps along the tile's 8 rows are added in order: one (sum, sum
    of squares) a (n, 8 x 16 pixel tile, channel);
  * the fold: thread r of 128 adds tiles r, r + 128, ... in order, then
    the 128 sums are added as a tree (row r takes row r + h, h = 64, 32,
    ..., 1); mean = s1 / HW, var = max(s2 / HW - mean^2,
    0), rstd = 1 / sqrt(var + eps), each operation rounded apart.
Here `tile_partials` and `fold` model that order with float32 torch ops
(each rounds as the card's does; the fold's quotients go through float64,
which rounds a float32 quotient exactly as IEEE float32 division does).

Tolerances: the 3xTF32 model against the JAX `_fwd_impl` (its Pallas kernel
in interpret mode) y within 1e-4, mean and rstd within 1e-5 relative, as
tests/test_torch_conv3x3_in.py holds the plain version; the order model
against conv3x3_in_stats_plain within 1e-6 relative, plus 1e-6 of the
largest |y| for the mean (a mean near 0 keeps the summands' rounding,
whose scale is |y|, not |mean|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu.ops.pallas import conv3x3_in as p3in
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch.ops.kernels import conv3x3_in_stats_plain
from supervised_gan_tpu_torch.ops.kernels.conv3x3 import conv3x3_plain_f32
from supervised_gan_tpu_torch.ops.kernels.conv3x3_in import (
    TILE_H, TILE_W, pixel_tiles, workspace_floats)

from test_torch_conv3x3_tc import conv_3xtf32
from test_torch_layout import conv_w, nchw, nhwc, rand, vec

EPS = 1e-5
FOLD_R = 128  # the fold block's tile strides


def tile_partials(y32):
    """(N, tiles, Co, 2) float32: each block's (sum, sum of squares) of each
    output channel, in the kernel's order; y32 (N, Co, H, W) is the f32
    accumulator with the bias added.  Pixels outside the image count as 0."""
    n, co, h, w = y32.shape
    th, tw = -(-h // TILE_H), -(-w // TILE_W)
    v = F.pad(y32, (0, tw * TILE_W - w, 0, th * TILE_H - h))
    # rows 2 * warp_m + mt, columns g + 8 * jr
    v = v.reshape(n, co, th, 4, 2, tw, 2, 8)
    sums = []
    for vals in (v, v * v):
        lane = (((vals[:, :, :, :, 0, :, 0] + vals[:, :, :, :, 0, :, 1])
                 + vals[:, :, :, :, 1, :, 0]) + vals[:, :, :, :, 1, :, 1])
        # lane: (n, co, th, warp_m, tw, g); the butterfly over g
        pair = lane[..., 0::2] + lane[..., 1::2]      # xor 4: g ^ 1
        quad = pair[..., 0::2] + pair[..., 1::2]      # xor 8: g ^ 2
        warp = quad[..., 0] + quad[..., 1]            # xor 16: g ^ 4
        block = ((warp[:, :, :, 0] + warp[:, :, :, 1]) + warp[:, :, :, 2]) \
            + warp[:, :, :, 3]
        sums.append(block.reshape(n, co, th * tw))
    return torch.stack(sums, -1).permute(0, 2, 1, 3).contiguous()


def _f32(t):
    return t.to(torch.float32)


def fold(partials, hw, eps=EPS):
    """mean, rstd (N, Co) from tile_partials, in the fold kernel's order and
    with its round-apart arithmetic."""
    n, tiles, co, _ = partials.shape
    k = -(-tiles // FOLD_R)
    p = F.pad(partials, (0, 0, 0, 0, 0, k * FOLD_R - tiles))
    p = p.reshape(n, k, FOLD_R, co, 2)
    acc = p[:, 0]
    for i in range(1, k):
        acc = acc + p[:, i]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    s = acc[:, 0]
    s1, s2 = s[..., 0].double(), s[..., 1].double()
    mean = _f32(s1 / hw)
    q = _f32(s2 / hw)
    var = _f32(q.double() - _f32(mean.double() * mean.double()).double())
    var = var.clamp_min(0.0)
    e = _f32(var.double() + float(np.float32(eps)))
    rstd = _f32(1.0 / _f32(e.double().sqrt()).double())
    return mean, rstd


def model_stats(y32, eps=EPS):
    return fold(tile_partials(y32), y32.shape[2] * y32.shape[3], eps)


def rstd_of_zero_var(eps=EPS):
    return float(_f32(1.0 / _f32(torch.tensor(float(np.float32(eps)),
                                              dtype=torch.float64).sqrt())
                      .double()))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    p3._set_interpret(True)
    yield
    p3._set_interpret(False)


# (C, H, W): one per packing factor of the JAX gate in interpret mode
JAX_SHAPES = [(16, 16, 64), (32, 16, 32), (64, 16, 16), (128, 16, 8)]


@pytest.mark.parametrize("c,h,w", JAX_SHAPES)
def test_3xtf32_statistics_match_jax(interpret, c, h, w):
    """The card's arithmetic end to end: 3xTF32 products, the bias, the
    epilogue's order and the fold, against `_fwd_impl`, which folds the
    Pallas kernel's per-lane sums (conv3x3_in.py:157-162 there)."""
    x = rand((1, h, w, c), 31 + c)
    wt = rand((3, 3, c, c), 32 + c, 0.1)
    b = rand((c,), 33 + c, 0.1)
    yj, mj, rj = p3in._fwd_impl(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(b), EPS)
    y32 = conv_3xtf32(nchw(x), conv_w(wt), vec(b))
    mean, rstd = model_stats(y32)
    np.testing.assert_allclose(nhwc(y32), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(mean[0].numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd[0].numpy(), np.asarray(rj), rtol=1e-5)


# (N, Ci, Co, H, W): sides off the 8 x 16 tile, one pixel, Co off the 64
# channels of a block, and a plane of more than the fold's 128 tile strides
RAGGED = [(2, 3, 5, 7, 13), (2, 17, 33, 1, 1), (2, 8, 72, 9, 40),
          (2, 13, 70, 21, 19), (2, 4, 6, 70, 90), (1, 5, 9, 8, 16),
          (2, 3, 4, 130, 200)]


def _ragged_inputs(n, ci, co, h, w, dtype):
    rng = np.random.RandomState(n * 1000 + ci * 100 + co + h + w)
    x = torch.from_numpy(rng.randn(n, ci, h, w).astype(np.float32))
    wt = torch.from_numpy((rng.randn(co, ci, 3, 3) * (9 * ci) ** -0.5)
                          .astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    return x.to(dtype), wt.to(dtype), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_epilogue_order_matches_the_plain_version(shape, dtype):
    x, wt, b = _ragged_inputs(*shape, dtype)
    y32 = conv3x3_plain_f32(x, wt, b)
    mean, rstd = model_stats(y32)
    _, mean_p, rstd_p = conv3x3_in_stats_plain(x, wt, b)
    scale = float(y32.abs().max())
    assert mean.shape == rstd.shape == (shape[0], shape[2])
    np.testing.assert_allclose(mean.numpy(), mean_p.numpy(), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(rstd.numpy(), rstd_p.numpy(), rtol=1e-6)


def test_tile_partials_sum_every_pixel_once():
    """The partials of a plane of ones count its pixels: each tile's
    in-image pixels, 0 for those past the sides."""
    h, w = 21, 19
    part = tile_partials(torch.ones(1, 3, h, w))
    counts = torch.tensor([[min(TILE_H, h - ty * TILE_H)
                            * min(TILE_W, w - tx * TILE_W)
                            for tx in range(-(-w // TILE_W))]
                           for ty in range(-(-h // TILE_H))],
                          dtype=torch.float32).flatten()
    assert torch.equal(part[0, :, :, 0], counts[:, None].expand(-1, 3))
    assert torch.equal(part[0, :, :, 1], counts[:, None].expand(-1, 3))
    assert float(part[..., 0].sum()) == h * w * 3


def test_constant_one_pixel_planes_keep_var_zero():
    """w = 0, bias only, 1 x 1 planes: s1 = b and s2 = b * b rounded, so the
    round-apart fold gives var exactly 0 and rstd = 1 / sqrt(eps) for any
    b.  A fused multiply-add (s2 - mean * mean rounded once) would keep
    the rounding error of b * b as variance."""
    b = torch.from_numpy(np.random.RandomState(5).randn(7).astype(np.float32))
    y32 = b.view(1, -1, 1, 1).expand(2, -1, 1, 1).contiguous()
    mean, rstd = model_stats(y32)
    assert torch.equal(mean, b.expand(2, -1))
    assert bool((rstd == rstd_of_zero_var()).all())
    _, mean_p, rstd_p = conv3x3_in_stats_plain(
        torch.randn(2, 3, 1, 1), torch.zeros(7, 3, 3, 3), b)
    assert torch.equal(mean_p, mean)
    # what one rounding of s2 - mean^2 would leave: b*b's own rounding error
    fused = (b.double() * b.double()).float().double() - b.double() ** 2
    assert bool((fused != 0).any())


@pytest.mark.parametrize("h,w", [(21, 19), (9, 40), (130, 200)])
def test_constant_planes_keep_var_zero(h, w):
    """w = 0 and biases of a few bits: every sum is exact, so mean = b and
    var = 0 exactly under the round-apart fold."""
    b = torch.tensor([0.75, -1.5, 3.125, 0.0, -0.25, 12.5])
    x = torch.randn(2, 4, h, w, generator=torch.Generator().manual_seed(h))
    y32 = conv3x3_plain_f32(x, torch.zeros(6, 4, 3, 3), b)
    mean, rstd = model_stats(y32)
    assert torch.equal(mean, b.expand(2, -1))
    assert bool((rstd == rstd_of_zero_var()).all())


@pytest.mark.parametrize("shape", RAGGED + [(1, 64, 64, 512, 512)], ids=str)
def test_workspace_mirror(shape):
    """workspace_floats (the wrapper's mirror of conv3x3_in_workspace): a
    float2 for each image, tile and channel, as tile_partials lays out."""
    n, _, co, h, w = shape
    tiles = pixel_tiles(h, w)
    assert tiles == -(-h // 8) * -(-w // 16)
    assert workspace_floats(n, co, h, w) == 2 * n * co * tiles
    if h * w <= 130 * 200:
        assert tile_partials(torch.zeros(n, co, h, w)).numel() \
            == workspace_floats(n, co, h, w)


def test_workspace_at_the_region_site():
    """512^2 64 -> 64, batch 1: 2048 tiles, 1 MiB of partials."""
    assert pixel_tiles(512, 512) == 2048
    assert workspace_floats(1, 64, 512, 512) * 4 == 1 << 20
