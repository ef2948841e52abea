"""What the data-parallel tests run in each rank (tests/test_torch_parallel.py,
tests/test_torch_parallel_driver.py), kept apart from the test files so a
spawned worker imports torch and the port only, not JAX.

Every job takes the launch's ``opt`` (parallel.launch calls it in each
worker, in its process group) and writes what it saw to
``<out>/rank<r>_<name>.pt``.
"""

import contextlib
import os

import numpy as np
import torch

from supervised_gan_tpu_torch import parallel
from supervised_gan_tpu_torch.models import create_model
from supervised_gan_tpu_torch.models.base import BaseModel, adam
from supervised_gan_tpu_torch.models.pools import (decide, draw_decisions,
                                                   init_pool)
from supervised_gan_tpu_torch.nn.core import Dropout, GaussianNoise
from supervised_gan_tpu_torch.ops.norm import batch_norm
from supervised_gan_tpu_torch.options import TrainOptions

# the JAX package's tests/test_sharding.py flag sets, at 2 ranks: the fcgan
# (dropout and a pool on here), the cgan with dropout and pools, twostage
# with the multi-class D2; and the main path's recipe, twostage_cycle (BN in
# G1, three pools), at tests/test_torch_train_step.py's widths
COMMON = ['--dataroot', './datasets/unused', '--dataset_mode', 'single',
          '--which_channel', 'rg_b', '--manualSeed', '0', '--display_id', '0',
          '--gpu_ids', '-1', '--batchSize', '2']
CONFIGS = {
    'fcgan': ['--model', 'fcgan', '--which_direction', 'A',
              '--loadSize', '32', '--fineSize', '32',
              '--which_model_netG', 'deconv', '--n_layers_G', '3',
              '--ngf', '8', '--which_model_netD', 'n_layers',
              '--n_layers_D', '2', '2', '--ndf', '8',
              '--scale_factor', '1', '2', '--lambda_D', '0.5', '0.4',
              '--noise_nc', '4', '--noiseSize', '2', '--norm', 'instance',
              '--no_lsgan', '--pool_size', '4'],
    'cgan': ['--model', 'cgan', '--which_direction', 'AtoB',
             '--loadSize', '128', '--fineSize', '128',
             '--which_model_netG', 'unet_128', '--ngf', '4',
             '--which_model_netD', 'n_layers', '--n_layers_D', '2', '2',
             '--ndf', '4', '--scale_factor', '1', '2',
             '--lambda_D', '0.5', '0.5', '--lambda_A', '10',
             '--noise_nc', '4', '--noiseSize', '4', '--weight_L1', '2', '4',
             '--norm', 'instance', '--no_lsgan', '--pool_size', '4'],
    'twostage': ['--model', 'twostage', '--loadSize', '128',
                 '--fineSize', '128', '--norm', 'instance',
                 '--pool_size', '4', '--which_direction', 'AtoB',
                 '--transform_1to2', 'bilinear_2',
                 '--which_model_netG1', 'fcgan', '--n_layers_G1', '4',
                 '--ngf1', '8', '--noiseSize1', '2', '--noise_nc1', '4',
                 '--which_model_netD1', 'n_layers', '--n_layers_D1', '2',
                 '--ndf1', '8', '--scale_factor1', '1', '--lambda_D1', '0.5',
                 '--which_model_netG2', 'crn', '--n_layers_G2', '5',
                 '--ngf2', '8', '--upsample_mode2', 'bilinear',
                 '--which_model_netF2', 'unet_128', '--nff2', '8',
                 '--noiseSize2', '2', '--noise_nc2', '4',
                 '--which_model_netD2', 'n_layers', '--n_layers_D2', '2',
                 '--ndf2', '8', '--scale_factor2', '1', '--lambda_D2', '0.5',
                 '--no_lsgan1', '--no_lsgan2', '--no_dropout1',
                 '--use_multi_class_GAN'],
    'twostage_cycle': [
        '--model', 'twostage_cycle', '--which_direction', 'AtoB',
        '--loadSize', '128', '--fineSize', '128',
        '--transform_1to2', 'bilinear_2',
        '--which_model_netG1', 'fcgan', '--n_layers_G1', '4', '--ngf1', '4',
        '--which_model_netD1', 'n_layers', '--n_layers_D1', '2', '2',
        '--ndf1', '4', '--scale_factor1', '1', '2',
        '--lambda_D1', '0.5', '0.4',
        '--which_model_netG2', 'crn', '--ngf2', '4',
        '--upsample_mode2', 'bilinear', '--n_layers_CRN_block2', '2',
        '--which_model_netF2', 'unet_128', '--nff2', '4',
        '--which_model_netD2', 'n_layers', '--n_layers_D2', '2', '3',
        '--ndf2', '4', '--scale_factor2', '1', '2',
        '--lambda_D2', '0.3', '0.2', '--lambda_A', '10', '--lambda_B', '10',
        '--lambda_A_cycle', '5', '--noise_nc1', '4', '--noiseSize1', '2',
        '--noise_nc2', '4', '--noiseSize2', '2', '--norm', 'instance',
        '--no_dropout1', '--no_lsgan1', '--no_lsgan2', '--pool_size', '2'],
}
STEPS = 2


def config_flags(name, ckpt, extra=()):
    return (COMMON + CONFIGS[name] + ['--name', name,
                                      '--checkpoints_dir', ckpt]
            + list(extra))


def batch(name, step):
    """The global batch of step ``step`` of config ``name``."""
    side = int(CONFIGS[name][CONFIGS[name].index('--fineSize') + 1])
    rng = np.random.RandomState(100 + step)
    return {'A': rng.uniform(-1, 1, (2, side, side, 3)).astype(np.float32),
            'A_paths': ['%d_%d.png' % (step, i) for i in range(2)]}


def model_state(model):
    """{name: tensor} of parameters, Adam moments and pools, copied, and the
    last step's losses (the ranks' mean in a group)."""
    out = {}
    for label, net in model.nets().items():
        for k, v in net.state_dict().items():
            out['%s.%s' % (label, k)] = v.detach().clone()
    for label, o in model.optimizers().items():
        for i, p in enumerate(p for g in o.param_groups for p in g['params']):
            for k in ('exp_avg', 'exp_avg_sq'):
                if k in o.state.get(p, {}):
                    out['adam.%s.%d.%s' % (label, i, k)] = (
                        o.state[p][k].detach().clone())
    for label, p in model.pools.items():
        if p is not None:
            out['pool.%s' % label] = p['images'].detach().clone()
    return out, dict(parallel.mean_values(model.get_current_errors()))


@contextlib.contextmanager
def float64():
    """The port's step in float64 on the CPU: float64 parameters, draws and
    activations, the losses' and the resampling's float32 casts made
    float64 (a test's means to tell rounding from a different function)."""
    saved = (torch.get_default_dtype(), torch.Tensor.float, torch.einsum,
             torch.matmul)
    einsum, matmul = torch.einsum, torch.matmul
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = torch.Tensor.double
    torch.einsum = lambda eq, *ops: einsum(eq, *[o.double() for o in ops])
    torch.matmul = lambda a, b: matmul(a.double(), b.double())
    try:
        yield
    finally:
        torch.set_default_dtype(saved[0])
        torch.Tensor.float, torch.einsum, torch.matmul = saved[1:]


def run_config(name, ckpt, extra=(), init=None, noises=None, steps=STEPS):
    """``steps`` steps of config ``name`` (sharded when ``extra`` holds
    --data_mesh and a group is up); ``init``: {net label: state_dict} to
    start from; ``noises``: global draws fed in place of the model's noise
    draws, in order.  Under ``float64()`` the model computes in float64."""
    model = create_model(TrainOptions().parse(config_flags(name, ckpt,
                                                           extra)))
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
        model.set_input(batch(name, s))
        model.optimize_parameters()
    if noises is not None:
        assert next(it, None) is None, 'not every fed noise was drawn'
    return model_state(model)


def _save(out, name, obj):
    torch.save(obj, os.path.join(out, 'rank%d_%s.pt' % (parallel.rank(),
                                                        name)))


def steps_job(opt, out, names, jax_case=None):
    """Each config of ``names`` at --data_mesh 2, and the JAX-fed case
    (``jax_case``: a file with 'init' and 'noises')."""
    torch.manual_seed(0)
    for name in names:
        _save(out, name, run_config(name, os.path.join(out, 'ckpt_%d' %
                                                       parallel.rank()),
                                    ['--data_mesh', '2']))
    if jax_case is not None:
        case = torch.load(jax_case, weights_only=True)
        _save(out, 'jax_fcgan', run_config(
            'fcgan', os.path.join(out, 'ckpt_jax_%d' % parallel.rank()),
            ['--data_mesh', '2'] + case['extra'], init=case['init'],
            noises=case['noises'], steps=1))
    return parallel.world()


def all_job(opt, out, names, jax_case):
    """The units, ``steps_job``, twostage_cycle for one step, then
    twostage_cycle in float64 sharded and (rank 0, in parallel.unsharded)
    unsharded."""
    units_job(opt, out)
    steps_job(opt, out, names, jax_case)
    _save(out, 'twostage_cycle_1', run_config(
        'twostage_cycle', os.path.join(out, 'ckpt1_%d' % parallel.rank()),
        ['--data_mesh', '2'], steps=1))
    with float64():
        _save(out, 'f64_twostage_cycle', run_config(
            'twostage_cycle', os.path.join(out, 'ckpt64_%d' % parallel.rank()),
            ['--data_mesh', '2']))
        if parallel.rank() == 0:
            with parallel.unsharded():
                _save(out, 'f64_ref_twostage_cycle', run_config(
                    'twostage_cycle', os.path.join(out, 'ckpt64_ref')))
    return parallel.world()


# ------------------------------------------------------------------ units -- #
def bn_inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(4, 3, 5, 5, generator=g) * 2 + 1,
            torch.randn(3, generator=g), torch.randn(3, generator=g),
            torch.randn(4, 3, 5, 5, generator=g))


def bn_grads(x, w, b, cot):
    """batch_norm's output and its gradients in x, w and b under the
    cotangent ``cot`` (the sum of y * cot as the loss)."""
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = batch_norm(x, w, b)
    (y * cot).sum().backward()
    return y.detach(), x.grad, w.grad, b.grad


def draws(batch_rows):
    """A Dropout mask, a GaussianNoise draw and BaseModel.noise for a batch
    of ``batch_rows`` rows (the rank's), each from its own seeded generator."""
    drop = Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(5)
    gauss = GaussianNoise(0.1)
    gauss.generator = torch.Generator().manual_seed(6)
    m = BaseModel()
    m.device = torch.device('cpu')
    m.noise_generator = torch.Generator().manual_seed(7)
    x = torch.ones(batch_rows, 3, 4, 4)
    return {'dropout': drop(x), 'gauss': gauss(torch.zeros_like(x)),
            'noise': m.noise((4, 2, 3, 3))}


def pool_query(batch, rows):
    """A 3-slot pool queried twice with the global rows ``rows`` (two
    (4, 3) tensors) on ``batch`` (each rank's rows of it in a group): the
    pooled batches and the pool's images."""
    m = BaseModel()
    m.pools = {'p': init_pool(3, (2, 4, 4), torch.device('cpu'))}
    outs = []
    for i in range(2):
        m._rows = rows[i]
        outs.append(m.query_pool('p', parallel.rows(batch[i])))
    return outs, m.pools['p']['images'].clone()


def pool_rows(seed=9):
    """The rows of two queries of 4 images into a 3-slot pool."""
    pool = init_pool(3, (2, 4, 4), torch.device('cpu'))
    g = torch.Generator().manual_seed(seed)
    return [torch.tensor(decide(pool, draw_decisions(pool, 4, g)),
                         dtype=torch.int64) for _ in range(2)]


def units_job(opt, out):
    x, w, b, cot = bn_inputs()
    res = {'bn': bn_grads(parallel.rows(x), w, b, parallel.rows(cot)),
           'draws': draws(2)}
    g = torch.Generator().manual_seed(8)
    res['pool'] = pool_query(torch.randn(2, 4, 2, 4, 4, generator=g),
                             pool_rows())
    # the gradient hook: each rank's gradient is rank + 1
    p = torch.nn.Parameter(torch.zeros(3))
    q = torch.nn.Parameter(torch.zeros(2, 2))
    o = adam([([p, q], 1e-3)], 0.5, torch.device('cpu'))
    p.grad = torch.full((3,), parallel.rank() + 1.0)
    q.grad = torch.full((2, 2), 2.0 * (parallel.rank() + 1.0))
    o.step()
    res['hook'] = {'p_grad': p.grad.clone(), 'q_grad': q.grad.clone(),
                   'p': p.detach().clone(), 'q': q.detach().clone()}
    res['mean_values'] = parallel.mean_values({'a': float(parallel.rank()),
                                               'b': 4.0})
    with parallel.unsharded():
        res['unsharded'] = (parallel.world(), parallel.rows(x).shape[0])
    _save(out, 'units', res)
    return parallel.world()
