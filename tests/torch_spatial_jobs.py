"""What the --spatial_mesh tests run in each rank (tests/test_torch_spatial.py,
tests/test_torch_spatial_steps.py), kept apart from the test files so a
spawned worker imports torch and the port only, not JAX.

Every job takes the launch's ``opt`` and writes what its rank saw to
``<out>/rank<r>_<name>.pt`` (r the global rank).  The per-op units run each
op on this rank's rows (parallel/spatial.py) and write its rows of the
output and of the input gradient, and its share of the weight gradient;
the steps write the model's state, its pools whole.
"""

import os

import torch

from supervised_gan_tpu_torch import parallel
from supervised_gan_tpu_torch.models import create_model
from supervised_gan_tpu_torch.nn.losses import (bce_loss, gan_loss,
                                                gan_loss_multiclass,
                                                weighted_l1_loss)
from supervised_gan_tpu_torch.ops import (avg_pool, batch_norm,
                                          bilinear_upsample, blur_downsample,
                                          conv2d, conv_transpose2d,
                                          instance_norm_act, reflection_pad)
from supervised_gan_tpu_torch.options import TrainOptions
from supervised_gan_tpu_torch.parallel import spatial

import torch_parallel_jobs as J

# (name, global input shape (N, C, H, W), weight shape or None, op): each
# per-op unit, at odd heights (31, 15), even ones and one that stays
# replicated (6 rows at 2 ranks)
CONV_UNITS = [
    ('conv3x3', (2, 3, 31, 9), (4, 3, 3, 3),
     lambda x, w, b: conv2d(x, w, b, 1, 1)),
    ('conv3x3_small', (1, 3, 6, 5), (2, 3, 3, 3),
     lambda x, w, b: conv2d(x, w, b, 1, 1)),
    ('conv4s2', (2, 3, 32, 8), (4, 3, 4, 4),
     lambda x, w, b: conv2d(x, w, b, 2, 1)),
    ('conv4s2_h62', (1, 2, 62, 6), (3, 2, 4, 4),
     lambda x, w, b: conv2d(x, w, b, 2, 1)),
    ('conv4s2_to_replicated', (1, 2, 16, 6), (3, 2, 4, 4),
     lambda x, w, b: conv2d(x, w, b, 2, 1)),
    ('conv4s2_odd', (1, 2, 31, 7), (3, 2, 4, 4),
     lambda x, w, b: conv2d(x, w, b, 2, 1)),
    ('convt4s2', (2, 4, 15, 5), (4, 3, 4, 4),
     lambda x, w, b: conv_transpose2d(x, w, b, 2, 1)),
    ('convt4s2_from_replicated', (1, 4, 8, 5), (4, 3, 4, 4),
     lambda x, w, b: conv_transpose2d(x, w, b, 2, 1)),
    ('head_k4s1p1', (2, 3, 31, 7), (2, 3, 4, 4),
     lambda x, w, b: conv2d(x, w, b, 1, 1)),
    ('head_k4s1p1_h32', (1, 3, 32, 6), (1, 3, 4, 4),
     lambda x, w, b: conv2d(x, w, b, 1, 1)),
]
RESAMPLE_UNITS = [
    ('blur2', (2, 3, 31, 9), lambda x: blur_downsample(x, 2)),
    ('blur4', (1, 2, 64, 12), lambda x: blur_downsample(x, 4)),
    ('blur4_odd', (1, 2, 63, 12), lambda x: blur_downsample(x, 4)),
    ('bilinear2', (2, 2, 15, 6), lambda x: bilinear_upsample(x, 2)),
    ('bilinear2_from_replicated', (1, 2, 8, 6),
     lambda x: bilinear_upsample(x, 2)),
    ('avg_pool2', (2, 3, 32, 8), lambda x: avg_pool(x, 2)),
    ('avg_pool4_to_replicated', (1, 2, 32, 8), lambda x: avg_pool(x, 4)),
    ('in_none', (2, 3, 31, 9), lambda x: instance_norm_act(x, 1e-5, None)),
    ('in_relu', (1, 4, 15, 7), lambda x: instance_norm_act(x, 1e-5, 0.0)),
    ('in_leaky', (2, 3, 32, 5), lambda x: instance_norm_act(x, 1e-5, 0.2)),
    ('in_replicated', (1, 3, 6, 5), lambda x: instance_norm_act(x, 1e-5,
                                                                0.2)),
]
# the resnet generator's pads: odd heights, a pad that reaches past a
# rank's rows, a replicated input padded to a sharded height
PAD_UNITS = [
    ('reflect3', (2, 3, 31, 9), lambda x: reflection_pad(x, 3, 3, 3, 3)),
    ('reflect1', (1, 2, 17, 6), lambda x: reflection_pad(x, 1, 1, 1, 1)),
    ('reflect3_from_replicated', (1, 2, 13, 6),
     lambda x: reflection_pad(x, 3, 3, 3, 3)),
]
LOSS_UNITS = ['gan_lsgan', 'gan_bce', 'multiclass', 'l1', 'l1_weighted',
              'bce']
BN_SHAPES = [('bn', (2, 3, 31, 9)), ('bn_replicated', (2, 3, 6, 5))]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _run_unit(fn, x_whole, params):
    """fn on this rank's rows of x (all of x unsharded): (this rank's rows
    of the output, of dL/dx, dL/dparams), L = sum(y * cot) of the whole
    output's cotangent; in float64 throughout (J.float64: the kernels'
    plain versions accumulate in x's .float())."""
    with J.float64():
        return _run_unit64(fn, x_whole, params)


def _run_unit64(fn, x_whole, params):
    x = spatial.cut(x_whole.clone()).detach().requires_grad_(True)
    ps = [p.clone().requires_grad_(True) for p in params]
    y = fn(x, *ps)
    h = spatial.height(y)
    cot = spatial.cut(_cot_for(y, h))
    if not spatial.sharded(y) and spatial.active():
        # a replicated output: the rank's share of the loss is its rows
        lo, hi = spatial.bounds(h)
        keep = torch.zeros_like(cot)
        keep.narrow(-2, lo, hi - lo).fill_(1)
        cot = cot * keep
    (y * cot).sum().backward()
    return (y.detach().clone(), spatial.sharded(y), x.grad.clone(),
            [p.grad.clone() for p in ps])


_COT_SEED = [0]


def _cot_for(y, h):
    shape = tuple(y.shape[:-2]) + (h,) + tuple(y.shape[-1:])
    return torch.randn(shape, generator=_gen(_COT_SEED[0]),
                       dtype=torch.float64)


def conv_unit(i):
    name, shape, wshape, op = CONV_UNITS[i]
    g = _gen(10 + i)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    w = torch.randn(wshape, generator=g, dtype=torch.float64) * 0.3
    co = wshape[1] if name.startswith('convt') else wshape[0]
    b = torch.randn(co, generator=g, dtype=torch.float64)
    _COT_SEED[0] = 100 + i
    return _run_unit(lambda x_, w_, b_: op(x_, w_, b_), x, [w, b])


def resample_unit(i):
    name, shape, op = RESAMPLE_UNITS[i]
    x = torch.randn(shape, generator=_gen(30 + i), dtype=torch.float64)
    if name.startswith('in_'):
        x = x * 2 + 1
    _COT_SEED[0] = 200 + i
    return _run_unit(op, x, [])


def pad_unit(i):
    name, shape, op = PAD_UNITS[i]
    x = torch.randn(shape, generator=_gen(40 + i), dtype=torch.float64)
    _COT_SEED[0] = 250 + i
    return _run_unit(op, x, [])


def bn_unit(i):
    name, shape = BN_SHAPES[i]
    g = _gen(50 + i)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 1
    w = torch.randn(shape[1], generator=g, dtype=torch.float64)
    b = torch.randn(shape[1], generator=g, dtype=torch.float64)
    _COT_SEED[0] = 300 + i
    return _run_unit(lambda x_, w_, b_: batch_norm(x_, w_, b_), x, [w, b])


def loss_unit(name, h=31):
    """A loss of a (2, 3, h, 7) map against fixed targets: (its value, this
    rank's rows of dL/dmap)."""
    g = _gen(60)
    p = torch.rand((2, 3, h, 7), generator=g, dtype=torch.float64) * 0.9 \
        + 0.05
    t = torch.rand((2, 3, h, 7), generator=g, dtype=torch.float64)
    wmap = torch.rand((2, 1, h, 7), generator=g, dtype=torch.float64) + 0.5
    x = spatial.cut(p.clone()).detach().requires_grad_(True)
    tt, ww = spatial.cut(t), spatial.cut(wmap)
    fn = {'gan_lsgan': lambda: gan_loss(x, True, True),
          'gan_bce': lambda: gan_loss(x, False, False),
          'multiclass': lambda: gan_loss_multiclass(x, 1),
          'l1': lambda: weighted_l1_loss(x, tt),
          'l1_weighted': lambda: weighted_l1_loss(x, tt, ww),
          'bce': lambda: bce_loss(x, tt)}[name]
    with J.float64():
        loss = fn()
        loss.backward()
    return float(loss.detach()), x.grad.clone()


def units(out):
    """Every per-op unit in float64 at this rank's rows."""
    res = {}
    for i, u in enumerate(CONV_UNITS):
        res[u[0]] = conv_unit(i)
    for i, u in enumerate(RESAMPLE_UNITS):
        res[u[0]] = resample_unit(i)
    for i, u in enumerate(PAD_UNITS):
        res[u[0]] = pad_unit(i)
    for i, u in enumerate(BN_SHAPES):
        res[u[0]] = bn_unit(i)
    for name in LOSS_UNITS:
        res['loss_' + name] = loss_unit(name)
        res['loss_' + name + '_replicated'] = loss_unit(name, h=6)
    _save(out, 'units', res)


# ------------------------------------------------------------------ steps -- #
def batch(name, step, rows):
    """The first ``rows`` rows of J.batch's global batch of step ``step``."""
    b = J.batch(name, step)
    return {'A': b['A'][:rows], 'A_paths': b['A_paths'][:rows]}


def run_steps(name, ckpt, extra=(), rows=1, steps=J.STEPS, init=None,
              noises=None):
    """``steps`` steps of config ``name`` at batch ``rows`` (sharded as
    ``extra`` and the group say): the state, pools whole, and the losses
    (summed over the sp group, averaged over the data group); under
    J.float64() in float64.  ``init`` / ``noises`` as J.run_config."""
    flags = J.config_flags(name, ckpt, ['--batchSize', str(rows)]
                           + list(extra))
    model = create_model(TrainOptions().parse(flags))
    if torch.get_default_dtype() == torch.float64:
        model.compute_dtype = torch.float64
        for pool in model.pools.values():
            if pool is not None:
                pool['images'] = pool['images'].double()
    if init is not None:
        for label, sd in init.items():
            model.nets()[label].load_state_dict(sd, strict=True)
    if noises is not None:
        it = iter(noises)
        model.noise_draw = lambda shape: next(it)
    for s in range(steps):
        model.set_input(batch(name, s, rows))
        model.optimize_parameters()
    if noises is not None:
        assert next(it, None) is None, 'not every fed noise was drawn'
    with spatial.whole_pools(model.pools):
        return J.model_state(model)


def _save(out, name, obj):
    rank = parallel.mesh._group['rank'] if parallel.mesh._group else 0
    torch.save(obj, os.path.join(out, 'rank%d_%s.pt' % (rank, name)))


# the steps of the sp tests: (saved name, config, float64, batch rows, the
# grid's flags, the config's extra flags); fcgan as the JAX package's
# tests/test_sharding.py SP_ARGS (no dropout), cgan with its dropout and
# pools (and with the resnet_9blocks G, --which_model_netG's default:
# its reflection pads), twostage_cycle at tests/test_torch_train_step.py's
# 128 px
SP2 = ['--spatial_mesh', '2']
GRID = ['--data_mesh', '2'] + SP2
NO_DROP = ['--no_dropout']
STEP_CASES = [('fcgan', 'fcgan', False, 1, SP2, NO_DROP),
              ('f64_fcgan', 'fcgan', True, 1, SP2, NO_DROP),
              ('cgan', 'cgan', False, 1, SP2, []),
              ('f64_cgan', 'cgan', True, 1, SP2, []),
              ('twostage_cycle', 'twostage_cycle', False, 1, SP2, []),
              ('f64_twostage_cycle', 'twostage_cycle', True, 1, SP2, []),
              ('f64_cgan_resnet', 'cgan', True, 1, SP2,
               ['--which_model_netG', 'resnet_9blocks'])]
GRID_CASES = [('grid_fcgan', 'fcgan', False, 2, GRID, NO_DROP),
              ('f64_grid_fcgan', 'fcgan', True, 2, GRID, NO_DROP)]


def run_case(out, case, sharded=True):
    """One case's steps: on its grid (``sharded``) or unsharded."""
    label, name, f64, rows, grid, extra = case
    rank = parallel.mesh._group['rank'] if parallel.mesh._group else 'ref'
    ckpt = os.path.join(out, 'ckpt_%s_%s' % (label, rank))
    flags = (grid if sharded else []) + extra
    if f64:
        with J.float64():
            return run_steps(name, ckpt, flags, rows)
    return run_steps(name, ckpt, flags, rows)


def steps_job(opt, out, cases, jax_case=None, with_units=False):
    """The units (``with_units``), each case of ``cases`` sharded, and the
    JAX-fed fcgan step (``jax_case``: a file with 'init', 'noises' and
    'extra')."""
    torch.manual_seed(0)
    if with_units:
        units(out)
    for case in cases:
        spatial.COUNTS.clear()
        state = run_case(out, case)
        _save(out, case[0], state)
        _save(out, case[0] + '_collectives', dict(spatial.COUNTS))
    if jax_case is not None:
        c = torch.load(jax_case, weights_only=True)
        _save(out, 'jax_fcgan', run_steps(
            'fcgan', os.path.join(out, 'ckpt_jax_%d' % parallel.rank()),
            SP2 + c['extra'], rows=1, steps=1, init=c['init'],
            noises=c['noises']))
    return parallel.workers(opt)


def reference(out, cases):
    """Each case unsharded, in this process: {label: (state, losses)}."""
    return {case[0]: run_case(out, case, sharded=False) for case in cases}

