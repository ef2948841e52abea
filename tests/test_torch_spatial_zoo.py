"""--spatial_mesh on the zoo's nets and the fused conv3x3 + IN region
(supervised_gan_tpu_torch/parallel/spatial.py, ops/conv.py
conv3x3_in_act) on the CPU: two gloo sp ranks, then three, each spawned
once for the module, running tests/torch_spatial_recipes.py
``region_job``; the unsharded references run here.

  * the zoo's three README paths, two steps each at --spatial_mesh 2,
    batch 1, against the unsharded port: Z1 (fcgan_star), Z2 (autoencoder
    with dropout's draws and n_layers_sep's channel split of a row shard),
    Z3 (the dcgan pair at 128 px: G's 4-1-0 ConvT from a 1 x 1 noise stays
    replicated up to 16 rows, D's (N,) score is split evenly over the sp
    ranks); and one gated twostage_cycle (SGAN_TPU_CONV3_IN=1, the region
    at its CRN's 128 x 128 sites): losses within 1e-5 relative in float32,
    every tensor within 1e-9 (relative L2) and the losses within 1e-12 in
    float64, the ranks bitwise equal;
  * the region as a unit through a gated Sequential, in float64 within
    1e-12 of the unsharded region (forward, dx, dW, db), at 2 ranks and at
    3, where 40 rows split 13 / 13 / 14: the gate reads the global height,
    so every rank takes the region exactly where one process does;
  * the region's sharded float32 forward against the JAX package's
    conv3x3_in_act in interpret mode on the whole plane, within 1e-4;
  * the row-range entry's plain version against the sums of the plain
    convolution over rows [r0, r1), and its windows' sums against the whole
    plane's statistics.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supervised_gan_tpu.ops.pallas import conv3x3 as p3
from supervised_gan_tpu.ops.pallas import conv3x3_in as p3in
from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch.ops.kernels import conv3x3_in as tcin

import torch_parallel_jobs as J
import torch_spatial_recipes as R
from test_torch_layout import one_thread  # noqa: F401
from test_torch_spatial_recipes import (check_losses_f32, check_ranks_equal,
                                        check_state_f64, launch, loader)

ZOO = ['z1_fcgan_star', 'z2_autoencoder_sep', 'z3_dcgan',
       'gated_twostage_cycle']
CASES = R.cases(ZOO)
TOL = 1e-12
# the gated CRN's region site: the conv bias that the norm removes, whose
# gradient (and so its Adam moments) is rounding noise on both sides
GATED_NOISE = ('adam.G.49.exp_avg', 'adam.G.49.exp_avg_sq')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('spatial_zoo'))
    out3 = str(tmp_path_factory.mktemp('spatial_zoo3'))
    world = launch(R.region_job, out, CASES)
    world3 = launch(R.region_job, out3, spatial_mesh=3)
    ref = R.reference(out, CASES)
    region_ref = {u[0]: R.region_unit(i)
                  for i, u in enumerate(R.REGION_UNITS)}
    return dict(world=world, world3=world3, load=loader(out),
                load3=loader(out3), ref=ref, region_ref=region_ref)


def test_grids_ran(runs):
    assert runs['world'] == 2 and runs['world3'] == 3


@pytest.mark.parametrize('label', [c[0] for c in CASES])
def test_ranks_hold_one_state(runs, label):
    check_ranks_equal(runs['load'], label, 2)


@pytest.mark.parametrize('recipe', ZOO)
def test_sharded_losses_equal_unsharded_float32(runs, recipe):
    check_losses_f32(runs['load'](0, recipe)[1], runs['ref'][recipe][1])


@pytest.mark.parametrize('recipe', ZOO)
def test_sharded_state_equals_unsharded_float64(runs, recipe):
    label = 'f64_' + recipe
    ours, losses, _ = runs['load'](0, label)
    ref, ref_losses, _ = runs['ref'][label]
    noise = GATED_NOISE if recipe.startswith('gated') else ()
    for k in noise:
        assert float(ref[k].norm()) < 1e-12, k
    check_state_f64(ours, ref, losses, ref_losses, noise)


def test_gated_step_took_the_region_over_split_rows(runs):
    """The gated step ran the region on the row-range route only (its CRN's
    128-row planes, split 64 / 64)."""
    counts = runs['load'](0, 'gated_twostage_cycle_collectives')
    assert counts.get('region_rows', 0) > 0, counts
    assert counts.get('region_whole', 0) == 0, counts


def _whole(parts, split):
    return torch.cat(parts, -2) if split else parts[0]


@pytest.mark.parametrize('n_sp', [2, 3])
@pytest.mark.parametrize('i', range(len(R.REGION_UNITS)),
                         ids=[u[0] for u in R.REGION_UNITS])
def test_region_unit_equals_unsharded(runs, n_sp, i):
    name, shape, _ = R.REGION_UNITS[i]
    load = runs['load'] if n_sp == 2 else runs['load3']
    parts = [load(r, 'region')[name] for r in range(n_sp)]
    y_ref, _, gx_ref, gp_ref, routes_ref, _ = runs['region_ref'][name]
    split = shape[2] >= 8 * n_sp
    assert all(p[1] == split for p in parts)
    y = _whole([p[0] for p in parts], split)
    torch.testing.assert_close(y, y_ref, rtol=TOL, atol=TOL)
    gx = (torch.cat([p[2] for p in parts], -2) if split
          else sum(p[2] for p in parts))
    torch.testing.assert_close(gx, gx_ref, rtol=TOL, atol=TOL)
    for k, g in enumerate(gp_ref):
        torch.testing.assert_close(sum(p[3][k] for p in parts), g,
                                   rtol=TOL, atol=TOL)
    # the gate decides by the global height: the region ran on every rank
    # where the one process ran it, over split rows when they are split
    assert routes_ref == ['whole']
    for p in parts:
        assert p[4] == (['rows'] if split else ['whole']), p[4]
        assert p[5] is True


def test_thirteen_row_shards_take_the_region(runs):
    """40 rows over 3 ranks: 13 / 13 / 14-row shards, which a local test
    (H % 8, H >= 16) would refuse."""
    rows = [(r * 40 // 3, (r + 1) * 40 // 3) for r in range(3)]
    assert [hi - lo for lo, hi in rows] == [13, 13, 14]
    for r in range(3):
        u = runs['load3'](r, 'region')['region_relu_h40']
        assert u[0].shape[2] == rows[r][1] - rows[r][0]
        assert u[4] == ['rows']


@pytest.mark.parametrize('k', range(len(R.JAX_REGION_SLOPES)))
def test_region_sharded_forward_matches_jax(runs, k, monkeypatch):
    monkeypatch.setattr(sin, '_FMA', False)
    p3._set_interpret(True)
    try:
        x, w, b = R.jax_region_inputs()
        ref = p3in.conv3x3_in_act(
            jnp.asarray(x.transpose(0, 2, 3, 1)),
            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b), 1e-5,
            R.JAX_REGION_SLOPES[k])
    finally:
        p3._set_interpret(False)
    y = torch.cat([runs['load'](r, 'region_f32')[k] for r in range(2)], 2)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)


# ------------------------------------------------- the row-range entry -- #
@pytest.mark.parametrize('shape,r0,r1', [((1, 3, 18, 9), 1, 17),
                                         ((2, 4, 15, 7), 0, 15),
                                         ((1, 2, 14, 16), 5, 6)])
def test_row_range_plain_equals_plain_conv_rows(shape, r0, r1):
    with J.float64():
        g = torch.Generator().manual_seed(sum(shape) + r0)
        x = torch.randn(shape, generator=g)
        w = torch.randn((5, shape[1], 3, 3), generator=g)
        b = torch.randn(5, generator=g)
        y, sums = tcin.conv3x3_in_partial_stats_plain(x, w, b, r0, r1)
        ref = F.conv2d(x, w, b, padding=1)[:, :, r0:r1]
        torch.testing.assert_close(y, ref, rtol=TOL, atol=TOL)
        assert sums.shape == (shape[0], 5, 2)
        torch.testing.assert_close(sums[..., 0], ref.sum((2, 3)), rtol=TOL,
                                   atol=TOL)
        torch.testing.assert_close(sums[..., 1], (ref * ref).sum((2, 3)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize('n', [2, 3])
def test_row_range_windows_compose_to_the_plane(n):
    """A 40-row plane cut into n windows [lo - 1, hi + 1) (zero rows past
    its edges), each through the row-range entry over rows [1, rows - 1):
    the sums added as the all-reduce adds them give the whole plane's mean
    and rstd (conv3x3_in_stats_plain) through stats_from_sums."""
    with J.float64():
        g = torch.Generator().manual_seed(n)
        x = torch.randn((1, 4, 40, 8), generator=g) * 2 + 1
        w = torch.randn((4, 4, 3, 3), generator=g) * 0.2
        b = torch.randn(4, generator=g)
        y_ref, mean_ref, rstd_ref = tcin.conv3x3_in_stats_plain(x, w, b)
        xp = F.pad(x, [0, 0, 1, 1])
        ys, total = [], 0
        for r in range(n):
            lo, hi = r * 40 // n, (r + 1) * 40 // n
            y, sums = tcin.conv3x3_in_partial_stats_plain(
                xp[:, :, lo:hi + 2], w, b, 1, hi - lo + 1)
            ys.append(y)
            total = total + sums
        torch.testing.assert_close(torch.cat(ys, 2), y_ref, rtol=TOL,
                                   atol=TOL)
        mean, rstd = tcin.stats_from_sums(total, 40 * 8)
        torch.testing.assert_close(mean, mean_ref, rtol=TOL, atol=TOL)
        torch.testing.assert_close(rstd, rstd_ref, rtol=TOL, atol=TOL)
