"""--spatial_mesh (supervised_gan_tpu_torch/parallel/spatial.py), op by op, on
the CPU: two gloo ranks spawned once for the module (parallel.launch, one
torch thread a worker, a finite group timeout and join timeout), each
running tests/torch_spatial_jobs.py ``units``.

  * each op at 2 sp ranks against the unsharded op, float64 within 1e-12:
    the outputs gathered, the input gradient (gathered where the input is
    row-sharded, summed where it is replicated) and the weight gradients
    (summed): conv3x3, conv4s2, the k4 s2 convT, the k4 s1 p1 head,
    blur_downsample at scales 2 and 4, bilinear_upsample, avg_pool, IN with
    slopes None / 0 / 0.2, the resnet generator's reflection pads,
    BatchNorm and the loss reductions, at odd global
    heights (31, 15, 63) and at heights that stay replicated or change
    layout across the op;
  * the row-split IN entries' plain versions against the JAX streaming
    kernels (`_fwd_stats_kernel`, `_bwd_stats_kernel`, `_bwd_apply_kernel`)
    in interpret mode, as tests/test_torch_instance_norm.py holds the
    one-launch kernels;
  * the refusals: fewer cards than workers and a model built outside its
    group.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from supervised_gan_tpu.ops.pallas import instance_norm as sin
from supervised_gan_tpu_torch import parallel
from supervised_gan_tpu_torch import train as ttrain
from supervised_gan_tpu_torch.ops.kernels import instance_norm as tin
from supervised_gan_tpu_torch.options import TrainOptions

import torch_spatial_jobs as S
import torch_parallel_jobs as J
from test_torch_layout import nchw
from test_torch_layout import one_thread  # noqa: F401

JOIN_TIMEOUT = 300      # seconds the two ranks may take, spawn included
GROUP_TIMEOUT = 120     # seconds a collective may wait for the other rank
TOL = 1e-12


def launch(fn, *args, data_mesh=0, spatial_mesh=2):
    """``fn(opt, *args)`` in the grid's spawned gloo ranks (one torch thread
    each)."""
    opt = types.SimpleNamespace(
        data_mesh=data_mesh, spatial_mesh=spatial_mesh, dcn_num_processes=0,
        dcn_process_id=0, dcn_coordinator='', gpu_ids=[], batchSize=2,
        manualSeed=0, model='fcgan')
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv('OMP_NUM_THREADS', '1')
        return parallel.launch(fn, opt, args, join_timeout=JOIN_TIMEOUT,
                               timeout_s=GROUP_TIMEOUT)
    finally:
        mp.undo()


def units_job(opt, out):
    S.units(out)
    return parallel.workers(opt)


@pytest.fixture(scope='module')
def units(tmp_path_factory):
    """Every unit on two sp ranks, and each unsharded here."""
    out = str(tmp_path_factory.mktemp('spatial_units'))
    world = launch(units_job, out)
    ranks = [torch.load(os.path.join(out, 'rank%d_units.pt' % r),
                        weights_only=True) for r in (0, 1)]
    return dict(world=world, ranks=ranks)


def split(h):
    return h >= 2 * 8


def _whole(parts, was_split, dim=-2):
    return torch.cat(parts, dim) if was_split else parts[0]


def _check_unit(units, name, ref, in_height):
    r0, r1 = units['ranks'][0][name], units['ranks'][1][name]
    y_ref, _, gx_ref, gp_ref = ref
    assert r0[1] == r1[1]
    y = _whole([r0[0], r1[0]], r0[1])
    torch.testing.assert_close(y, y_ref, rtol=TOL, atol=TOL)
    gx = (torch.cat([r0[2], r1[2]], -2) if split(in_height)
          else r0[2] + r1[2])
    torch.testing.assert_close(gx, gx_ref, rtol=TOL, atol=TOL)
    for a, b, g in zip(r0[3], r1[3], gp_ref):
        torch.testing.assert_close(a + b, g, rtol=TOL, atol=TOL)


def test_two_ranks_ran(units):
    assert units['world'] == 2


@pytest.mark.parametrize('i', range(len(S.CONV_UNITS)),
                         ids=[u[0] for u in S.CONV_UNITS])
def test_conv_unit_equals_unsharded(units, i):
    name, shape = S.CONV_UNITS[i][:2]
    _check_unit(units, name, S.conv_unit(i), shape[2])


@pytest.mark.parametrize('i', range(len(S.RESAMPLE_UNITS)),
                         ids=[u[0] for u in S.RESAMPLE_UNITS])
def test_resample_and_in_unit_equals_unsharded(units, i):
    name, shape = S.RESAMPLE_UNITS[i][:2]
    _check_unit(units, name, S.resample_unit(i), shape[2])


@pytest.mark.parametrize('i', range(len(S.PAD_UNITS)),
                         ids=[u[0] for u in S.PAD_UNITS])
def test_reflection_pad_unit_equals_unsharded(units, i):
    name, shape = S.PAD_UNITS[i][:2]
    _check_unit(units, name, S.pad_unit(i), shape[2])


@pytest.mark.parametrize('i', range(len(S.BN_SHAPES)),
                         ids=[u[0] for u in S.BN_SHAPES])
def test_batch_norm_unit_equals_unsharded(units, i):
    name, shape = S.BN_SHAPES[i]
    _check_unit(units, name, S.bn_unit(i), shape[2])


@pytest.mark.parametrize('name', S.LOSS_UNITS)
@pytest.mark.parametrize('h', [31, 6])
def test_loss_share_sums_to_unsharded_loss(units, name, h):
    key = 'loss_' + name + ('' if h == 31 else '_replicated')
    r0, r1 = units['ranks'][0][key], units['ranks'][1][key]
    loss, grad = S.loss_unit(name, h)
    assert abs(r0[0] + r1[0] - loss) <= TOL * abs(loss)
    g = torch.cat([r0[1], r1[1]], -2) if split(h) else r0[1] + r1[1]
    torch.testing.assert_close(g, grad, rtol=TOL, atol=TOL)


# -------------------------------------- the row-split IN entries vs JAX -- #
IN_SHAPES = [(2, 4, 16, 32), (1, 128, 16, 8), (1, 8, 32, 32)]


def _jax_sums(kernel, args, specs, n, rows, rb, lane):
    return pl.pallas_call(
        kernel, grid=(n, rows // rb), in_specs=specs,
        out_specs=pl.BlockSpec((1, 2, lane), lambda i, j: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, 2, lane), jnp.float32),
        interpret=True)(*args)


def _jax_geom(xj):
    n, rows, rb, lane, p = sin._geom(xj)
    assert rb is not None
    return n, rows, rb, lane, p


@pytest.mark.parametrize('shape', IN_SHAPES)
def test_partial_stats_plain_matches_jax_stats_kernel(shape, monkeypatch):
    monkeypatch.setattr(sin, '_INTERPRET', True)
    rng = np.random.RandomState(1)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    n, rows, rb, lane, p = _jax_geom(xj)
    st = sin._stream_stats(xj.reshape(n, rows, lane), n, rows, rb, lane)
    s1, s2 = sin._fold_stats(st, p, shape[1])
    ours = tin.instance_norm_partial_stats(torch.from_numpy(x))
    np.testing.assert_allclose(ours[..., 0].numpy(), np.asarray(s1),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ours[..., 1].numpy(), np.asarray(s2),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize('shape', IN_SHAPES)
@pytest.mark.parametrize('slope', [None, 0.0, 0.2])
def test_bwd_entries_plain_match_jax_kernels(shape, slope, monkeypatch):
    monkeypatch.setattr(sin, '_INTERPRET', True)
    rng = np.random.RandomState(2)
    x = rng.normal(0.5, 1.5, shape).astype(np.float32)
    g = rng.normal(0.0, 1.0, shape).astype(np.float32)
    n_, c = shape[:2]
    mean = rng.normal(0.5, 0.1, (n_, c)).astype(np.float32)
    rstd = rng.uniform(0.5, 1.0, (n_, c)).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    gj = jnp.asarray(g.transpose(0, 2, 3, 1))
    n, rows, rb, lane, p = _jax_geom(xj)
    mrow, rrow = sin._lane_rows(jnp.asarray(mean), p), sin._lane_rows(
        jnp.asarray(rstd), p)
    x2, g2 = xj.reshape(n, rows, lane), gj.reshape(n, rows, lane)
    st = _jax_sums(
        functools.partial(sin._bwd_stats_kernel, slope=slope),
        (x2, g2, mrow, rrow),
        [sin._row_spec(rb, lane), sin._row_spec(rb, lane),
         sin._lane_spec(lane), sin._lane_spec(lane)], n, rows, rb, lane)
    s1, s2 = sin._fold_stats(st, p, c)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tm, tr = torch.from_numpy(mean), torch.from_numpy(rstd)
    sums = tin.instance_norm_bwd_partial_stats(tx, tg, tm, tr, slope)
    np.testing.assert_allclose(sums[..., 0].numpy(), np.asarray(s1),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(sums[..., 1].numpy(), np.asarray(s2),
                               rtol=1e-5, atol=1e-3)
    # dx from the sums, over a count that is not the rank's plane (a row
    # split's global plane): the JAX apply kernel on the same means
    count = 3.0 * shape[2] * shape[3]
    dx2 = pl.pallas_call(
        functools.partial(sin._bwd_apply_kernel, slope=slope),
        grid=(n, rows // rb),
        in_specs=[sin._row_spec(rb, lane), sin._row_spec(rb, lane)]
        + [sin._lane_spec(lane)] * 4,
        out_specs=sin._row_spec(rb, lane),
        out_shape=jax.ShapeDtypeStruct((n, rows, lane), jnp.float32),
        interpret=True)(x2, g2, mrow, rrow, sin._lane_rows(s1 / count, p),
                        sin._lane_rows(s2 / count, p))
    dx = tin.instance_norm_bwd_apply(tx, tg, tm, tr, sums, count, slope)
    np.testing.assert_allclose(dx.numpy(), nchw(np.asarray(dx2).reshape(
        xj.shape)).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('slope', [None, 0.0, 0.2])
def test_row_split_in_entries_compose_to_one_plane(slope):
    """Two row blocks of one plane through the entries, their sums added
    as the all-reduce adds them: the whole plane's forward and backward
    (the plain one-launch versions), in float64."""
    with J.float64():
        _compose(slope)


def _compose(slope):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 15, 9, generator=g, dtype=torch.float64) * 2 + 1
    cot = torch.randn(x.shape, generator=g, dtype=torch.float64)
    y_ref, mean_ref, rstd_ref = tin.instance_norm_act_plain(
        x, 1e-5, slope, return_stats=True)
    dx_ref = tin.instance_norm_bwd_plain(x, cot, mean_ref, rstd_ref, slope)
    parts = [x[:, :, :7], x[:, :, 7:]]
    cots = [cot[:, :, :7], cot[:, :, 7:]]
    count = 15 * 9
    sums = sum(tin.instance_norm_partial_stats(p) for p in parts)
    mean = sums[..., 0] / count
    rstd = torch.rsqrt((sums[..., 1] / count - mean * mean).clamp_min(0)
                       + 1e-5)
    y = torch.cat([tin.instance_norm_apply(p, mean, rstd, slope)
                   for p in parts], 2)
    torch.testing.assert_close(y, y_ref, rtol=1e-12, atol=1e-12)
    bs = sum(tin.instance_norm_bwd_partial_stats(p, c, mean, rstd, slope)
             for p, c in zip(parts, cots))
    dx = torch.cat([tin.instance_norm_bwd_apply(p, c, mean, rstd, bs, count,
                                                slope)
                    for p, c in zip(parts, cots)], 2)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ refusals -- #
def test_fewer_cards_than_workers_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='fewer cards than workers'):
        ttrain.main(['--dataroot', './datasets/unused', '--name', 'sp_cards',
                     '--model', 'fcgan', '--gpu_ids', '0',
                     '--spatial_mesh', '2', '--checkpoints_dir',
                     str(tmp_path)])


def test_model_outside_its_group_raises(tmp_path):
    from supervised_gan_tpu_torch.models import create_model
    opt = TrainOptions().parse(
        ['--dataroot', './datasets/unused', '--name', 'sp_alone', '--model',
         'fcgan', '--gpu_ids', '-1', '--spatial_mesh', '2',
         '--checkpoints_dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='--spatial_mesh 2'):
        create_model(opt)


# ------------------------------------------------------ the entry point -- #
SP_TRAIN = ['--model', 'fcgan', '--which_direction', 'A',
            '--dataset_mode', 'single', '--loadSize', '32', '--fineSize',
            '32', '--which_model_netG', 'deconv', '--n_layers_G', '3',
            '--ngf', '8', '--which_model_netD', 'n_layers', '--n_layers_D',
            '2', '2', '--ndf', '8', '--scale_factor', '1', '2', '--lambda_D',
            '0.5', '0.4', '--noise_nc', '4', '--noiseSize', '2', '--norm',
            'instance', '--no_dropout', '--no_lsgan', '--which_channel',
            'rg_b', '--manualSeed', '0', '--display_id', '0', '--pool_size',
            '4', '--batchSize', '1', '--spatial_mesh', '2', '--gpu_ids', '-1',
            '--niter', '1', '--niter_decay', '0', '--display_freq', '2',
            '--print_freq', '2', '--save_epoch_freq', '1']


def test_train_entry_point_gathers_visuals_and_pools(tmp_path, monkeypatch):
    """train --spatial_mesh 2 on the CPU (the JAX package's SP_ARGS, batch
    1): the displayed images and the checkpointed pool are whole, and
    --continue_train cuts the pool again and trains on."""
    from PIL import Image
    rng = np.random.RandomState(0)
    data = tmp_path / 'data' / 'train'
    data.mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(str(data / ('%d.png' % i)))
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    args = SP_TRAIN + ['--dataroot', str(tmp_path / 'data'), '--name', 'sp',
                       '--checkpoints_dir', str(tmp_path / 'ckpt')]
    r = ttrain.main(args)
    assert r['steps'] == 4
    run = tmp_path / 'ckpt' / 'sp'
    state = torch.load(str(run / 'latest_state.pt'), weights_only=True)
    assert state['pools']['pool']['images'].shape == (4, 3, 32, 32)
    assert state['pools']['pool']['num'] == 4
    img = Image.open(str(run / 'web' / 'images' / 'epoch001_fake_image.png'))
    assert img.size == (32, 32)
    again = ttrain.main(args + ['--continue_train', '--which_epoch',
                                'latest'])
    assert again['steps'] == 4


def test_bench_refuses_spatial_mesh():
    from supervised_gan_tpu_torch import bench
    with pytest.raises(NotImplementedError, match='--spatial_mesh 2'):
        bench.main(['--spatial_mesh', '2', '--gpu_ids', '-1'])
