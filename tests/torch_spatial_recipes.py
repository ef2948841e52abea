"""What the --spatial_mesh recipe, zoo and region tests run in each rank
(tests/test_torch_spatial_recipes.py, tests/test_torch_spatial_seg.py,
tests/test_torch_spatial_zoo.py), kept apart from the test files so a
spawned worker imports torch and the port only, not JAX.

Each recipe case takes the flags and widths of the recipe's own CPU test
(tests/test_torch_twostage_flags.py, test_torch_twostage.py,
test_torch_cgan_cycle.py, test_torch_cgan2.py, test_torch_segmentation.py,
test_torch_segmentation_cycle.py, test_torch_zoo_fcgan_star.py,
test_torch_zoo_steps.py), copied here since those import JAX.  A job writes
what its rank saw to ``<out>/rank<r>_<name>.pt`` (r the global rank).
"""

import os

import numpy as np
import torch
from torch.func import functional_call

from supervised_gan_tpu_torch import parallel
from supervised_gan_tpu_torch.models import create_model
from supervised_gan_tpu_torch.nn import core as nn_core
from supervised_gan_tpu_torch.ops import conv as tconv
from supervised_gan_tpu_torch.ops.kernels import conv3x3_in as tcin
from supervised_gan_tpu_torch.options import TrainOptions
from supervised_gan_tpu_torch.parallel import spatial

import torch_parallel_jobs as J
import torch_spatial_jobs as S

PX = 128
COMMON = ['--dataroot', './datasets/unused', '--manualSeed', '0',
          '--display_id', '0', '--gpu_ids', '-1', '--norm', 'instance']
LR = ['--lr', '0.0002', '--lr1', '0.0002', '--lr2', '0.0002']
SIDE = ['--loadSize', str(PX), '--fineSize', str(PX)]

# tests/test_torch_train_step.py FLAGS without --model: the two-stage family
TWOSTAGE = SIDE + LR + [
    '--which_direction', 'AtoB', '--dataset_mode', 'single',
    '--transform_1to2', 'bilinear_2', '--which_channel', 'rg_b',
    '--which_model_netG1', 'fcgan', '--n_layers_G1', '4', '--ngf1', '4',
    '--which_model_netD1', 'n_layers', '--n_layers_D1', '2', '2',
    '--ndf1', '4', '--scale_factor1', '1', '2', '--lambda_D1', '0.5', '0.4',
    '--which_model_netG2', 'crn', '--ngf2', '4', '--upsample_mode2',
    'bilinear', '--n_layers_CRN_block2', '2',
    '--which_model_netF2', 'unet_128', '--nff2', '4',
    '--which_model_netD2', 'n_layers', '--n_layers_D2', '2', '3',
    '--ndf2', '4', '--scale_factor2', '1', '2', '--lambda_D2', '0.3', '0.2',
    '--lambda_A', '10', '--lambda_B', '10', '--lambda_A_cycle', '5',
    '--noise_nc1', '4', '--noiseSize1', '2', '--noise_nc2', '4',
    '--noiseSize2', '2', '--no_dropout1', '--no_lsgan1', '--no_lsgan2']
PAIRS = ['--GAN_losses_D2', 'real_fake', 'fake_fake',
         '--GAN_losses_G2', 'real_fake', 'fake_fake']
BANKS = ['--n_layers_D1', '2', '2', '--n_layers_D2', '2', '2']
# tests/test_torch_cgan_cycle.py, test_torch_cgan2.py
FAMILY = SIDE + LR + ['--which_direction', 'AtoB', '--which_channel', 'rg_b',
                      '--pool_size', '1', '--no_dropout']
G_NETS = ['--which_model_netG1', 'unet_128', '--ngf1', '4',
          '--which_model_netG2', 'unet_128', '--ngf2', '4',
          '--no_dropout1', '--no_dropout2']
D1 = ['--which_model_netD1', 'n_layers', '--n_layers_D1', '1', '2',
      '--ndf1', '4', '--scale_factor1', '1', '2', '--lambda_D1', '0.5', '0.4']
G_D = ['--which_model_netG', 'unet_128', '--ngf', '4',
       '--which_model_netD', 'n_layers', '--n_layers_D', '1', '2',
       '--ndf', '4', '--scale_factor', '1', '2', '--lambda_D', '0.5', '0.4']
# tests/test_torch_segmentation.py, test_torch_segmentation_cycle.py
SEG = SIDE + ['--model', 'segmentation', '--dataset_mode', 'single',
              '--which_direction', 'AtoB', '--which_model_netG', 'unet_128',
              '--ngf', '4', '--noise_nc', '4', '--noiseSize', '4',
              '--no_dropout', '--which_channel', 'b_rg', '--which_metric',
              'RandScore', 'meanIU', '--pool_size', '0', '--lambda_A', '1',
              '--lr', '0.0002']
SEG_D = ['--which_model_netD', 'n_layers', '--n_layers_D', '2',
         '--ndf', '4', '--scale_factor', '1', '--lambda_D', '0.5',
         '--no_lsgan']
SEGC = SIDE + LR + [
    '--model', 'segmentation_cycle', '--dataset_mode', 'single',
    '--which_model_netG1', 'unet_128', '--ngf1', '4',
    '--which_model_netG2', 'unet_128', '--ngf2', '4', '--no_dropout1',
    '--no_dropout2', '--which_channel', 'b_rg', '--which_metric',
    'RandScore', 'meanIU', '--which_model_netD2', 'n_layers',
    '--n_layers_D2', '1', '--ndf2', '4', '--scale_factor2', '1',
    '--lambda_D2', '0.7', '--pool_size', '1', '--lambda_A', '1']
# tests/test_torch_zoo_fcgan_star.py FLAGS, test_torch_zoo_steps.py Z2, Z3
Z1 = SIDE + ['--model', 'fcgan', '--which_direction', 'A',
             '--dataset_mode', 'single', '--input_nc', '2',
             '--which_model_netG', 'fcgan_star', '--n_layers_G', '5',
             '--ngf', '4', '--which_model_netD', 'n_layers',
             '--n_layers_D', '3', '3', '3', '--ndf', '4',
             '--scale_factor', '1', '2', '4', '--lambda_D', '0.5', '0.4',
             '0.1', '--noise_nc', '8', '--noiseSize', '2', '--no_dropout',
             '--n_update_G', '2', '--no_lsgan', '--which_channel', 'rg',
             '--lr', '0.0002', '--pool_size', '0']
Z2 = ['--model', 'cgan', '--which_direction', 'AtoB',
      '--dataset_mode', 'single', '--loadSize', '64', '--fineSize', '64',
      '--input_nc', '2', '--output_nc', '1',
      '--which_model_netG', 'autoencoder', '--n_layers_G', '5',
      '--ngf', '4', '--which_model_netD', 'n_layers_sep',
      '--n_layers_D', '3', '4', '--ndf', '4', '--scale_factor', '1', '1',
      '--lambda_D', '0.5', '0.5', '--lambda_A', '10', '--noise_nc', '8',
      '--noiseSize', '4', '--n_update_G', '2', '--weight_L1', '2', '4',
      '--no_lsgan', '--add_gaussian_noise', '--which_channel', 'rg_b',
      '--lr', '0.0002', '--pool_size', '0', '--no_dropout']
Z3 = SIDE + ['--model', 'fcgan', '--which_direction', 'A',
             '--dataset_mode', 'single', '--which_model_netG', 'dcgan',
             '--ngf', '8', '--noise_nc', '100', '--noiseSize', '1',
             '--no_dropout', '--which_channel', 'rg_b',
             '--which_model_netD', 'dcgan', '--n_layers_D', '3', '--ndf', '8',
             '--scale_factor', '1', '--lambda_D', '1', '--n_update_G', '2',
             '--no_lsgan', '--lr', '0.0002']

# recipe -> (flags, batch kind): 'labels' a single image with binary r, g
# label channels, 'seg' the segmentation tests' b_rg one-hot pair,
# 'unaligned' an A and a B image of that kind, 'image' a plain image
RECIPES = {
    'twostage_multiclass': (TWOSTAGE + PAIRS + [
        '--model', 'twostage', '--pool_size', '2',
        '--use_multi_class_GAN'], 'labels'),
    'twostage_no_cgan': (TWOSTAGE + PAIRS + [
        '--model', 'twostage', '--pool_size', '2', '--no_cgan'], 'labels'),
    'twostage_factd': (TWOSTAGE + PAIRS + BANKS + [
        '--model', 'twostage_factd', '--pool_size', '2'], 'labels'),
    'cgan_cycle': (FAMILY + G_NETS + D1 + [
        '--model', 'cgan_cycle', '--dataset_mode', 'single',
        '--n_update_G', '2', '--weight_L1', '2', '4', '--no_lsgan1'],
        'labels'),
    'cgan2_cycle': (FAMILY + G_NETS + D1 + [
        '--model', 'cgan2_cycle', '--dataset_mode', 'unaligned',
        '--train_D_on_fake_fake_pair', '--lambda_fake_cycle', '0.5'],
        'unaligned'),
    'cgan2': (FAMILY + G_D + [
        '--model', 'cgan2', '--dataset_mode', 'unaligned',
        '--train_G_on_fake_fake_pair', '--pool_reject_prob', '0.3'],
        'unaligned'),
    'cgan_causal': (FAMILY + G_NETS + D1 + [
        '--model', 'cgan_causal', '--dataset_mode', 'unaligned',
        '--really_CausalGAN'], 'unaligned'),
    'segmentation_weighted_ce': (SEG + SEG_D + ['--weights', '1', '2'],
                                 'seg'),
    'segmentation_sigmoid': (SEG + SEG_D + ['--use_sigmoid_ss',
                                            '--weights', '1', '2'], 'seg'),
    'segmentation_cycle': (SEGC, 'seg'),
    'z1_fcgan_star': (Z1, 'image'),
    'z2_autoencoder_sep': (Z2, 'labels'),
    'z3_dcgan': (Z3, 'image'),
    # the gated step: twostage_cycle with SGAN_TPU_CONV3_IN=1, its CRN at
    # --ngf2 8 (the gate's P = 16 pixels a lane: W a multiple of 128), its
    # 128 x 128 conv3x3 + IN runs taking the region (CONV3_MIN_PIXELS
    # lowered)
    'gated_twostage_cycle': (J.CONFIGS['twostage_cycle'] + LR + [
        '--which_channel', 'rg_b', '--dataset_mode', 'single',
        '--ngf2', '8'],
        'labels_twostage_cycle'),
}


def side_of(flags):
    return int(flags[len(flags) - 1 - flags[::-1].index('--fineSize') + 1])


def batch(recipe, step, rows):
    """The global batch of ``rows`` rows of step ``step`` of ``recipe``."""
    flags, kind = RECIPES[recipe]
    if kind == 'labels_twostage_cycle':
        return S.batch('twostage_cycle', step, rows)
    side = side_of(flags)
    rng = np.random.RandomState(200 + step)
    out = {'A_paths': ['%d_%d.png' % (step, i) for i in range(rows)]}
    for key in ('AB' if kind == 'unaligned' else 'A'):
        a = rng.uniform(-1, 1, (rows, side, side, 3)).astype(np.float32)
        if kind in ('labels', 'unaligned'):
            a[..., :2] = np.sign(a[..., :2])
        elif kind == 'seg':
            a[..., 0] = np.sign(a[..., 0])
            a[..., 1] = -a[..., 0]
        out[key] = a
    if kind == 'unaligned':
        out['B_paths'] = ['b%d_%d.png' % (step, i) for i in range(rows)]
    return out


# (label, recipe, float64, batch rows, the grid's flags)
SP2 = S.SP2
GRID = S.GRID


def cases(recipes, f32=True, f64=True):
    out = []
    for r in recipes:
        if f32:
            out.append((r, r, False, 1, SP2))
        if f64:
            out.append(('f64_' + r, r, True, 1, SP2))
    return out


def _gated(recipe):
    return recipe.startswith('gated_')


def run_recipe(out, case, sharded=True, steps=J.STEPS, init=None):
    """``steps`` steps of a case: on its grid (``sharded``) or unsharded,
    from ``init`` ({net label: state_dict}) if given; returns (the state,
    pools whole, the losses, the accuracies of a segmentation recipe
    (gathered, averaged over the grid) or None)."""
    label, recipe, f64, rows, grid = case
    rank = parallel.mesh._group['rank'] if parallel.mesh._group else 'ref'
    flags = (COMMON + RECIPES[recipe][0]
             + ['--name', recipe, '--batchSize', str(rows),
                '--checkpoints_dir',
                os.path.join(out, 'ckpt_%s_%s' % (label, rank))]
             + (grid if sharded else []))
    saved = (nn_core._CONV3_IN_FUSED, tconv.CONV3_MIN_PIXELS,
             tconv.Conv3x3InAct, tconv.Conv3x3InActRows)
    if _gated(recipe):
        # the region's routes counted in spatial.COUNTS ('region_whole',
        # 'region_rows')
        routes = _Routes(spatial.COUNTS)
        nn_core._CONV3_IN_FUSED = True
        tconv.CONV3_MIN_PIXELS = 64 * 64
        tconv.Conv3x3InAct = routes.wrap(saved[2], 'region_whole')
        tconv.Conv3x3InActRows = routes.wrap(saved[3], 'region_rows')
    try:
        if f64:
            with J.float64():
                return _run(flags, recipe, rows, steps, init)
        return _run(flags, recipe, rows, steps, init)
    finally:
        (nn_core._CONV3_IN_FUSED, tconv.CONV3_MIN_PIXELS, tconv.Conv3x3InAct,
         tconv.Conv3x3InActRows) = saved


def _run(flags, recipe, rows, steps, init):
    model = create_model(TrainOptions().parse(flags))
    if torch.get_default_dtype() == torch.float64:
        model.compute_dtype = torch.float64
        for pool in model.pools.values():
            if pool is not None:
                pool['images'] = pool['images'].double()
    for label, sd in (init or {}).items():
        model.nets()[label].load_state_dict(sd, strict=True)
    accs = None
    if hasattr(model, 'reset_accs'):
        model.reset_accs()
    for s in range(steps):
        model.set_input(batch(recipe, s, rows))
        model.optimize_parameters()
        if hasattr(model, 'accum_accs'):
            model.accum_accs()
    if hasattr(model, 'get_current_accs'):
        accs = dict(parallel.mean_values(model.get_current_accs(),
                                         shares=False))
    with spatial.whole_pools(model.pools):
        state, losses = J.model_state(model)
    return state, losses, accs


def _save(out, name, obj):
    rank = parallel.mesh._group['rank'] if parallel.mesh._group else 0
    torch.save(obj, os.path.join(out, 'rank%d_%s.pt' % (rank, name)))


def recipes_job(opt, out, cases_, jax_case=None):
    """Each case of ``cases_`` sharded, with its collective counts, then
    the JAX-fed case (``jax_case``: a file with 'case' and 'init') for one
    step."""
    torch.manual_seed(0)
    for case in cases_:
        spatial.COUNTS.clear()
        _save(out, case[0], run_recipe(out, case))
        _save(out, case[0] + '_collectives', dict(spatial.COUNTS))
    if jax_case is not None:
        c = torch.load(jax_case, weights_only=True)
        _save(out, 'jax', run_recipe(out, tuple(c['case']), steps=1,
                                     init=c['init']))
    return parallel.workers(opt)


def reference(out, cases_):
    """Each case unsharded, in this process: {label: (state, losses,
    accs)}."""
    return {case[0]: run_recipe(out, case, sharded=False) for case in cases_}


# ------------------------------------------------------------ the region -- #
# (name, global x shape (1, C, H, W), slope): the fused conv3x3 + IN (+ act)
# region through a Sequential with its gate on, C = 32 (the gate's P = 4
# pixels a lane: W a multiple of 32), H a multiple of 8; 40 rows split 20 /
# 20 over 2 ranks and 13 / 13 / 14 over 3, 16 rows stay whole on 3 ranks
REGION_UNITS = [('region_leaky_h32', (1, 32, 32, 32), 0.2),
                ('region_relu_h40', (1, 32, 40, 32), 0.0),
                ('region_none_h40', (1, 32, 40, 32), None),
                ('region_leaky_h16', (1, 32, 16, 32), 0.2)]
REGION_MIN_PIXELS = 16 * 32


class _Routes:
    """Records the region's Functions as ops/conv.py applies them: in
    ``calls`` (a list, or a Counter that counts them)."""

    def __init__(self, calls=None):
        self.calls = [] if calls is None else calls

    def wrap(self, fn, name):
        calls = self.calls

        class Counted:
            @staticmethod
            def apply(*args):
                if isinstance(calls, list):
                    calls.append(name)
                else:
                    calls[name] += 1
                return fn.apply(*args)
        return Counted


def region_unit(i):
    """The gated Sequential on this rank's rows, in float64: (its rows of
    y, sharded, of dL/dx, [dL/dW, dL/db] shares, the routes taken)."""
    name, shape, slope = REGION_UNITS[i]
    c = shape[1]
    g = torch.Generator().manual_seed(70 + i)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 1
    w = torch.randn((c, c, 3, 3), generator=g, dtype=torch.float64) * 0.1
    b = torch.randn(c, generator=g, dtype=torch.float64)
    layers = [nn_core.Conv2d(c, c, 3, 1, 1), nn_core.InstanceNorm2d(c)]
    if slope is not None:
        layers.append(nn_core.LeakyReLU(slope) if slope
                      else nn_core.ReLU())
    seq = nn_core.Sequential(*layers).double()
    routes = _Routes()
    saved = (nn_core._CONV3_IN_FUSED, tconv.CONV3_MIN_PIXELS,
             tconv.Conv3x3InAct, tconv.Conv3x3InActRows)
    nn_core._CONV3_IN_FUSED = True
    tconv.CONV3_MIN_PIXELS = REGION_MIN_PIXELS
    tconv.Conv3x3InAct = routes.wrap(saved[2], 'whole')
    tconv.Conv3x3InActRows = routes.wrap(saved[3], 'rows')
    S._COT_SEED[0] = 400 + i
    try:
        res = S._run_unit(lambda x_, w_, b_: functional_call(
            seq, {'0.weight': w_, '0.bias': b_}, (x_,)), x, [w, b])
        gate = tconv.conv3x3_in_supported(spatial.cut(x), w)
    finally:
        (nn_core._CONV3_IN_FUSED, tconv.CONV3_MIN_PIXELS, tconv.Conv3x3InAct,
         tconv.Conv3x3InActRows) = saved
    return res + (routes.calls, gate)


def region_job(opt, out, with_recipes=()):
    """Every region unit on this rank's rows and the float32 forwards held
    against JAX, then ``with_recipes``."""
    _save(out, 'region', {u[0]: region_unit(i)
                          for i, u in enumerate(REGION_UNITS)})
    _save(out, 'region_f32', region_f32_forwards())
    if with_recipes:
        recipes_job(opt, out, with_recipes)
    return parallel.workers(opt)


JAX_REGION_SHAPE = (1, 32, 32, 32)
JAX_REGION_SLOPES = (None, 0.0, 0.2)


def jax_region_inputs():
    """x (N, C, H, W), w (Co, Ci, 3, 3), b (Co,) float32 numpy: the inputs
    the region's sharded forward and the JAX conv3x3_in_act share."""
    rng = np.random.RandomState(90)
    c = JAX_REGION_SHAPE[1]
    return (rng.randn(*JAX_REGION_SHAPE).astype(np.float32),
            (rng.randn(c, c, 3, 3) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


def region_f32_forwards():
    """The region's float32 forward on this rank's rows of
    jax_region_inputs, one a slope of JAX_REGION_SLOPES."""
    x, w, b = (torch.from_numpy(a) for a in jax_region_inputs())
    with torch.no_grad():
        return [tconv.conv3x3_in_act(spatial.cut(x), w, b, 1e-5, s)
                for s in JAX_REGION_SLOPES]


def row_range_plain(x, w, b, r0, r1):
    """conv3x3_in_partial_stats_plain (the row-range entry's plain
    version) on the window x."""
    return tcin.conv3x3_in_partial_stats_plain(x, w, b, r0, r1)
