"""The arithmetic of the port's tensor-core k4 s2 transposed conv
(csrc/convt4s2.cu), rehearsed on the CPU.  The kernel is an implicit GEMM
over the four output phases at once: a block stages, per chunk of input
channels (8 f32 / 16 bf16), the channels-last halo of an 8 x 16 tile of
input positions with a 1-px border (conv3x3's halo), and builds A at each
of the 9 shifts (dy, dx) of it.  Along one axis shift 0 feeds tap 3 of
phase 0, shift 1 taps 1 (phase 0) and 2 (phase 1), shift 2 tap 0 of phase
1: 16 (shift, tap) pairs, each a dot over the chunk's channels into its own
phase's accumulators, taken shift by shift.  An f32 (3xTF32) pair sums
lo*hi, hi*lo, hi*hi; a bf16 one an exact product.  Input channels are split
over blocks in units of 16 as ops/kernels/convt4s2.py ``tc_plan`` says, and
the splits' sums are added in order, then the bias.

Here the same staging, pairs, tiles, splits and fold order are emulated
with TF32 rounding done on the float32 bits (``rna_tf32`` and ``split`` of
tests/test_torch_conv3x3_tc.py), and the result is held against the JAX
package: ``ops.conv.conv_transpose2d`` (XLA) at the shapes the Pallas gate
leaves to it (G1's first and last sites, the 1- to 3-channel dx of the D
stems, ragged shapes with N = 2 and odd sides, a split deep site), and the
Pallas ``convt4s2`` in interpret mode where ``supported()`` takes the shape.

Tolerance: 1e-5 of the largest |y| for 3xTF32 (f32 sums in another order;
the card's check is 1e-4 abs + 1e-4 rel), and for bf16 inputs, whose
products are exact in f32, against the f32 transposed conv of the same
bf16 values.  One TF32 product a MAC (plain TF32) lands outside the card's
1e-4, which is why the kernel splits each operand."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_gan_tpu.ops import conv as jconv
from supervised_gan_tpu.ops.pallas import convt4s2 as pt
from supervised_gan_tpu_torch.ops.kernels import convt4s2_plain

from test_torch_conv3x3_tc import rna_tf32, split
from test_torch_layout import convt_w, nchw, nhwc, rand

mod = importlib.import_module('supervised_gan_tpu_torch.ops.kernels.convt4s2')
TH, TW, UNIT = mod.TILE_ROWS, mod.TILE_COLS, mod.CI_UNIT
KC = {torch.float32: 8, torch.bfloat16: 16}
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


# csrc/convt4s2.cu's n_pairs, pair_phase, pair_tap: along one axis, halo
# offset d (x index m - 1 + d) feeds n_pairs(d) (phase, kernel index) pairs
def n_pairs(d):
    return 2 if d == 1 else 1


def pair_phase(d, i):
    return 0 if d == 0 else 1 if d == 2 else i


def pair_tap(d, i):
    return 3 if d == 0 else 0 if d == 2 else 1 + i


# the kernel's 16 pairs in its order: (dy, dx, q, r, ky, kx)
PAIRS = [(dy, dx, pair_phase(dy, i), pair_phase(dx, j), pair_tap(dy, i),
          pair_tap(dx, j))
         for dy in range(3) for dx in range(3)
         for i in range(n_pairs(dy)) for j in range(n_pairs(dx))]

# (N, H, W, Ci, Co): G1's first (Ci 8, half a bf16 chunk; on the card
# this shape takes the kernel's CUDA-core loop, the emulation holds the
# tensor-core arithmetic at Ci 8 all the same) and last sites,
# the dx of a 1- and a 3-channel D stem, ragged shapes (Ci 1, 3, 17 off the
# chunk, Co 2, 5, 70 off the n8 fragments and the block) with odd sides and
# N = 2, a deep site whose chunks are split, a wide site at a small side
SHAPES = [(1, 4, 4, 8, 256), (1, 16, 16, 32, 2), (1, 32, 32, 32, 1),
          (1, 16, 16, 64, 3), (2, 7, 13, 3, 5), (2, 9, 5, 17, 70),
          (2, 13, 9, 1, 2), (1, 4, 4, 256, 256), (1, 16, 16, 128, 64)]
# (N, H, W, Ci, Co) of every convt4s2 site: the sampler's six G1 sites, the
# 19 dx shapes and F2's 7 decoder shapes of the train step (bench.py DSGAN,
# 512 px)
SITES = [(1, s, s, ci, co) for ci, co, s in (
    (8, 256, 4), (256, 256, 8), (256, 128, 16), (128, 64, 32), (64, 32, 64),
    (32, 2, 128),
    (32, 2, 64), (32, 1, 256), (64, 32, 32), (64, 3, 128), (64, 32, 128),
    (64, 3, 256), (128, 64, 16), (128, 64, 64), (128, 64, 128),
    (256, 256, 4), (256, 256, 16), (256, 128, 32), (256, 128, 64),
    (512, 256, 16), (512, 256, 32), (64, 32, 64), (128, 64, 32),
    (32, 2, 128), (256, 256, 8),
    (64, 2, 256), (128, 32, 128), (256, 64, 64), (512, 256, 8),
    (512, 128, 32))]


def stage(x):
    """The channels-last halos of every tile: (N, tiles_h, tiles_w, TH + 2,
    TW + 2, Ci), halo row hy of tile (i, j) being input row TH*i - 1 + hy
    and column hx input column TW*j - 1 + hx, zero outside the image."""
    n, ci, h, w = x.shape
    th, tw = -(-h // TH), -(-w // TW)
    xp = torch.zeros((n, ci, TH * th + 2, TW * tw + 2))
    xp[:, :, 1:1 + h, 1:1 + w] = x
    halo = xp.unfold(2, TH + 2, TH).unfold(3, TW + 2, TW)
    return halo.permute(0, 2, 3, 4, 5, 1)


def a_operand(halo, dy, dx):
    """A at shift (dy, dx): (N, tiles_h, tiles_w, TH, TW, Ci)."""
    return halo[:, :, :, dy:dy + TH, dx:dx + TW, :]


def _dot(a, b):
    return torch.einsum('nhwrsc,co->nhwrso', a, b)


def _3xtf32(acc, a, b):
    """acc + lo*hi, then + hi*lo, then + hi*hi: one accumulator's order."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ((acc + _dot(al, bh)) + _dot(ah, bl)) + _dot(ah, bh)


def _1xtf32(acc, a, b):
    return acc + _dot(rna_tf32(a), rna_tf32(b))


def _exact(acc, a, b):
    return acc + _dot(a, b)


def interleave(phases, h, w):
    """Four (N, th, tw, TH, TW, Co) phase tensors, index 2q + r -> y
    (N, Co, 2h, 2w), output pixel (2m + q, 2n + r)."""
    y = torch.stack([torch.stack([phases[2 * q + r] for r in range(2)], -1)
                     for q in range(2)], -2)
    n, th, tw = y.shape[:3]
    co = y.shape[5]
    # (N, th, tw, TH, TW, Co, q, r) -> (N, Co, th, TH, q, tw, TW, r)
    y = y.permute(0, 5, 1, 3, 6, 2, 4, 7).reshape(n, co, 2 * TH * th,
                                                  2 * TW * tw)
    return y[:, :, :2 * h, :2 * w]


def kernel_y(x, w, b, dtype, step=None):
    """y as the kernel sums it, for NCHW / (Ci, Co, 4, 4) f32 tensors
    holding the values the kernel is given (bf16 values for bf16 inputs);
    f32 result."""
    n, ci, h, wd = x.shape
    co = w.shape[1]
    if step is None:
        step = _3xtf32 if dtype == torch.float32 else _exact
    halo = stage(x)
    sums = []
    for u0, u1 in mod.tc_plan(n, ci, co, h, wd):
        acc = [torch.zeros(halo.shape[:3] + (TH, TW, co)) for _ in range(4)]
        for c0 in range(u0 * UNIT, min(ci, u1 * UNIT), KC[dtype]):
            cs = slice(c0, min(ci, c0 + KC[dtype]))
            for dy, dx, q, r, ky, kx in PAIRS:
                acc[2 * q + r] = step(acc[2 * q + r],
                                      a_operand(halo, dy, dx)[..., cs],
                                      w[cs, :, ky, kx])
        sums.append(acc)
    if len(sums) == 1:
        y = sums[0]
    else:
        y = [torch.zeros_like(a) for a in sums[0]]
        for s in sums:
            y = [a + p for a, p in zip(y, s)]
    if b is not None:
        y = [a + b for a in y]
    return interleave(y, h, wd)


def inputs(shape, seed, dtype):
    """NHWC / pre-flipped HWIO numpy inputs (rounded to bf16 for bf16) and
    their NCHW / (Ci, Co, 4, 4) tensors."""
    n, h, w, ci, co = shape
    x = rand((n, h, w, ci), seed)
    wt = rand((4, 4, ci, co), seed + 1, (4 * ci) ** -0.5)
    b = rand((co,), seed + 2, 0.1)
    if dtype == torch.bfloat16:
        x, wt = (torch.from_numpy(a).bfloat16().float().numpy()
                 for a in (x, wt))
    return x, wt, b, nchw(x), convt_w(wt), torch.from_numpy(b)


def xla_convt(x, w, b):
    """The JAX package's reference op (XLA, f32 on the CPU)."""
    return np.asarray(jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b), 2, 1))


def rel_err(y, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(nhwc(y) - ref).max() / np.abs(ref).max())


@pytest.fixture
def interpret():
    pt._set_interpret(True)
    yield
    pt._set_interpret(False)


@pytest.mark.parametrize('shape', SITES + SHAPES)
def test_plan_splits_every_chunk_once(shape):
    """tc_plan's splits cover the units in order, each once, none empty,
    all of one size but the last; the grid stays within RESIDENT blocks
    when it is split, and is split when a split fits."""
    n, h, w, ci, co = shape
    bounds = mod.tc_plan(n, ci, co, h, w)
    units = -(-ci // UNIT)
    assert bounds[0][0] == 0 and bounds[-1][1] == units
    assert all(p[1] == q[0] for p, q in zip(bounds, bounds[1:]))
    assert all(e > s for s, e in bounds)
    per = bounds[0][1] - bounds[0][0]
    assert all(e - s == per for s, e in bounds[:-1])
    blocks = -(-h // TH) * -(-w // TW) * -(-co // mod.co_block(co)) * n
    assert len(bounds) == 1 or blocks * len(bounds) <= mod.resident(co)
    if units > 1 and 2 * blocks <= mod.resident(co):
        assert len(bounds) > 1


def test_only_g1_first_site_takes_the_cuda_core_loop():
    """The kernel leaves one unit of input channels over at most 16 input
    positions to its CUDA-core loop: of the recorded sites only G1's first
    (8 -> 256 on 4^2); the ragged shapes chip_smoke.py checks and every
    other site take the tensor cores."""
    loop = {s for s in SITES if not mod.tensor_cores(s[3], s[1], s[2])}
    assert loop == {(1, 4, 4, 8, 256)}
    for ci in (1, 2, 3, 17):
        for h, w in ((7, 13), (9, 5)):
            assert mod.tensor_cores(ci, h, w)
    assert mod.tensor_cores(17, 4, 4) and mod.tensor_cores(16, 4, 5)
    assert not mod.tensor_cores(16, 2, 8)


def test_pairs_are_each_phase_taps():
    """The kernel's 16 (shift, tap) pairs give each phase its four taps,
    each once, at the input offsets of the JAX kernel's row-tap geometry
    (its _KY and _ROW_OFF, for the pre-flipped kernel: torch tap 3 - ky) and
    of the port's plain version."""
    assert len(PAIRS) == 16
    assert len({(ky, kx) for *_, ky, kx in PAIRS}) == 16
    for q in range(2):
        jax_axis = {(3 - ky, off) for ky, off in zip(pt._KY[q],
                                                     pt._ROW_OFF[q])}
        plain_axis = {(k, 1 + d) for k, d in mod._PHASE_TAPS[q]}
        ours = {(pair_tap(d, i), d) for d in range(3)
                for i in range(n_pairs(d)) if pair_phase(d, i) == q}
        assert ours == jax_axis == plain_axis
    for q in range(2):
        for r in range(2):
            taps = [(dy, dx, ky, kx) for dy, dx, pq, pr, ky, kx in PAIRS
                    if (pq, pr) == (q, r)]
            assert len(taps) == 4


@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[4], SHAPES[5],
                                   (1, 2, 2, 3, 5)])
def test_staged_halo_shifts_read_the_padded_input(shape):
    """A at shift (dy, dx) of every tile is x padded by 1 at
    (m + dy, n + dx) for input position (m, n)."""
    n, h, w, ci, _ = shape
    x = torch.from_numpy(rand((n, ci, h, w), 4))
    halo = stage(x)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    for dy in range(3):
        for dx in range(3):
            a = a_operand(halo, dy, dx)
            got = a.permute(0, 5, 1, 3, 2, 4).reshape(
                n, ci, a.shape[1] * TH, a.shape[2] * TW)[:, :, :h, :w]
            assert torch.equal(got, xp[:, :, dy:dy + h, dx:dx + w])


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize('shape', SHAPES)
def test_emulated_kernel_matches_xla_convt(shape, dtype):
    x, w, b, xt, wt, bt = inputs(shape, 3, dtype)
    ref = xla_convt(x, w, b)
    y = kernel_y(xt, wt, bt, dtype)
    assert rel_err(y, ref) <= 1e-5
    plain = convt4s2_plain(xt, wt, bt)
    assert float((y - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES.keys())
def test_emulated_kernel_matches_pallas_interpret(interpret, dtype):
    """At 64 -> 32 on 16^2 (a split of the channels), against the Pallas
    kernel of the JAX package run in interpret mode."""
    x, w, b, xt, wt, bt = inputs((1, 16, 16, 64, 32), 5, dtype)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    assert pt.supported(xj, wj)
    assert len(mod.tc_plan(1, 64, 32, 16, 16)) > 1
    ref = np.asarray(pt.convt4s2(xj, wj, jnp.asarray(b)))
    assert rel_err(kernel_y(xt, wt, bt, dtype), ref) <= 1e-5


@pytest.mark.parametrize('shape', [SHAPES[1], SHAPES[7], SHAPES[8]])
def test_plain_tf32_misses_the_f32_tolerance(shape):
    """Why the kernel splits: one TF32 product a MAC keeps ~3 digits and
    lands outside the card's 1e-4 check; 3xTF32 within 1e-5 of the largest
    |y|."""
    x, w, b, xt, wt, bt = inputs(shape, 7, torch.float32)
    ref = xla_convt(x, w, b)
    assert rel_err(kernel_y(xt, wt, bt, torch.float32), ref) <= 1e-5
    y1 = kernel_y(xt, wt, bt, torch.float32, _1xtf32)
    assert rel_err(y1, ref) > 1e-4
    r = torch.from_numpy(np.array(ref))
    assert not bool(((torch.from_numpy(nhwc(y1)) - r).abs()
                     <= 1e-4 + 1e-4 * r.abs()).all())
