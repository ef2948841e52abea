"""The port's chunked dispatch (--steps_per_dispatch) on the CPU, and what
makes its train step capturable as a CUDA graph on the card.

  * the pools' branchless query (models/pools.py decide + pool_apply)
    against the branching one it replaced, and so JAX's semantics, over
    draws that fill, swap and pass, two images of a batch on one slot
    among them;
  * bilinear_upsample / blur_downsample with their device constants made
    once (ops/resample.py) against the per-call form they replaced,
    bitwise, in f32 and bf16;
  * ``train_chunk`` of 3 batches against 3 set_input + optimize_parameters
    calls, bitwise, for twostage_cycle (the narrow 128 px DSGAN config of
    test_torch_train_step.py) and fcgan (test_torch_fcgan.py's), pools and
    dropout on; a chunk then a step likewise; a --continue_train from the
    full state saved after a chunk; the pools' draws in the order the D
    updates query them, per step and in a chunk;
  * the train driver against the JAX package's root train.py, each with a
    stub model that records its dispatches, on one synthetic set: the same
    chunks at the same steps.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from supervised_gan_tpu_torch import train as ttrain
from supervised_gan_tpu_torch.models import base
from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.models import pools as tpools
from supervised_gan_tpu_torch.ops import resample
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions

import test_torch_fcgan
import test_torch_train_step
from test_torch_layout import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- pools -- #

def _branching_query(pool, batch, draws, reject=0.5):
    """The port's pool_query before the branchless form (a branch in Python
    per image on the fill count and the draws)."""
    images = pool['images']
    size = images.shape[0]
    outs = []
    for x, (u, slot) in zip(batch.detach().to(images.dtype), draws):
        if pool['num'] < size:
            images[pool['num']] = x
            pool['num'] += 1
            outs.append(x)
        elif u > reject:
            outs.append(images[slot].clone())
            images[slot] = x
        else:
            outs.append(x)
    return torch.stack(outs)


# (pool size, batch, queries, draws' seed): filling across a batch, then
# swaps and passes; a pool of 1 and of 2 puts two images of a batch on one
# slot
POOL_CASES = [(3, 1, 8, 0), (4, 2, 6, 1), (2, 3, 5, 2), (1, 2, 6, 3),
              (5, 4, 4, 4), (2, 1, 12, 5)]


@pytest.mark.parametrize('size,batch,queries,seed', POOL_CASES)
def test_branchless_pool_equals_branching(size, batch, queries, seed):
    gen = torch.Generator().manual_seed(seed)
    ours = tpools.init_pool(size, (2, 3, 3), 'cpu')
    ref = tpools.init_pool(size, (2, 3, 3), 'cpu')
    kinds = set()
    for q in range(queries):
        x = torch.randn((batch, 2, 3, 3), generator=gen, dtype=torch.float64)
        draws = tpools.draw_decisions(ours, batch, gen)
        kinds |= {('fill' if ref['num'] + i < size else
                   'swap' if u > 0.5 else 'pass')
                  for i, (u, _) in enumerate(draws)}
        want = _branching_query(ref, x, draws)
        got = tpools.pool_query(ours, x, draws=draws)
        assert got.dtype == want.dtype and torch.equal(got, want), q
        assert torch.equal(ours['images'], ref['images']) and \
            ours['num'] == ref['num'], q
    assert kinds == {'fill', 'swap', 'pass'}


def test_rows_say_slot_store_evicted():
    pool = tpools.init_pool(2, (1, 1, 1), 'cpu')
    draws = [(0.9, 1), (0.1, 0), (0.9, 0), (0.1, 1)]
    assert tpools.decide(pool, draws) == [(0, 1, 0), (1, 1, 0), (0, 1, 1),
                                          (1, 0, 0)]
    assert pool['num'] == 2


# ------------------------------------------------------------- resample -- #

def _lerp_axis_per_call(x, dim, out_size, align_corners):
    """ops/resample.py _lerp_axis before its constants were kept."""
    i0, i1, w0, w1 = resample._interp_taps(x.shape[dim], out_size,
                                           align_corners)
    shape = [1] * x.dim()
    shape[dim] = out_size

    def weight(w):
        return torch.from_numpy(w).to(x.device, x.dtype).float().view(shape)

    def take(i):
        return x.index_select(dim, torch.from_numpy(i).to(x.device)).float()

    return (take(i0) * weight(w0) + take(i1) * weight(w1)).to(x.dtype)


def _upsample_per_call(x, scale):
    h, w = x.shape[2], x.shape[3]
    y = _lerp_axis_per_call(x, 2, h * scale, True)
    return _lerp_axis_per_call(y, 3, w * scale, True)


def _blur_per_call(x, scale):
    h, w = x.shape[2], x.shape[3]
    ah = torch.from_numpy(resample._blur_matrix(h, scale)).to(x.device)
    aw = torch.from_numpy(resample._blur_matrix(w, scale)).to(x.device)
    y = torch.einsum('oh,nchw->ncow', ah, x.float())
    y = torch.einsum('pw,ncow->ncop', aw, y)
    return y.to(x.dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('op', ['upsample', 'blur'])
def test_resample_constants_kept_bitwise(op, dtype):
    gen = torch.Generator().manual_seed(3)
    ours, ref = ((resample.bilinear_upsample, _upsample_per_call)
                 if op == 'upsample' else
                 (resample.blur_downsample, _blur_per_call))
    for n, c, h, w, s in ((1, 3, 17, 12, 2), (2, 4, 32, 32, 4),
                          (1, 1, 1, 5, 2)):
        x = torch.randn((n, c, h, w), generator=gen).to(dtype)
        first = ours(x, s)
        kept = len(resample._DEVICE_CONSTANTS)
        again = ours(x, s)
        assert len(resample._DEVICE_CONSTANTS) == kept
        want = ref(x, s)
        assert first.dtype == want.dtype == dtype
        assert torch.equal(first, want) and torch.equal(again, want)


# -------------------------------------------------------------- chunks -- #

RECIPES = {
    'twostage_cycle': (test_torch_train_step.FLAGS,
                       test_torch_train_step._batch),
    'fcgan': (test_torch_fcgan.FLAGS, test_torch_fcgan._batch)}


def _model(recipe, ckpt, *extra):
    flags, _ = RECIPES[recipe]
    return tcreate(TTrainOptions().parse(
        flags + ['--checkpoints_dir', str(ckpt), '--pool_size', '2',
                 '--gpu_ids', '-1'] + list(extra)))


def _batches(recipe, n):
    return [RECIPES[recipe][1](s) for s in range(n)]


def _state(model):
    """Everything a step moves: parameters and buffers, Adam's state, the
    pools, the noise generator, and the last step's metrics."""
    out = {'errors': model.get_current_errors(),
           'noise': model.noise_generator.get_state(),
           'pool_gen': model.pool_generator.get_state()}
    for label, net in model.nets().items():
        for k, v in net.state_dict().items():
            out['%s.%s' % (label, k)] = v
    for label, opt in model.optimizers().items():
        for i, st in enumerate(opt.state.values()):
            for k, v in st.items():
                out['adam.%s.%d.%s' % (label, i, k)] = v
    for label, p in model.pools.items():
        out['pool.%s' % label] = (p['images'], p['num'])
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, tuple):
            assert torch.equal(x[0], y[0]) and x[1] == y[1], k
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            assert x == y, k


def _steps(model, batches):
    for b in batches:
        model.set_input(b)
        model.optimize_parameters()


@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_chunk_equals_steps(recipe, tmp_path):
    batches = _batches(recipe, 3)
    per_step = _model(recipe, tmp_path / 'a')
    _steps(per_step, batches)
    chunked = _model(recipe, tmp_path / 'b')
    chunked.train_chunk(batches)
    assert chunked.steps_run == per_step.steps_run == 3
    _assert_same(_state(chunked), _state(per_step))


@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_chunk_then_step_equals_steps(recipe, tmp_path):
    """The draws continue after a chunk where per-step training's do (JAX
    tests/test_train_chunk.py:66)."""
    batches = _batches(recipe, 3)
    per_step = _model(recipe, tmp_path / 'a')
    _steps(per_step, batches)
    mixed = _model(recipe, tmp_path / 'b')
    mixed.train_chunk(batches[:2])
    _steps(mixed, batches[2:])
    _assert_same(_state(mixed), _state(per_step))


def test_continue_train_after_a_chunk(tmp_path):
    """The full state saved after a chunk resumes exactly."""
    recipe = 'fcgan'
    batches = _batches(recipe, 3)
    straight = _model(recipe, tmp_path / 'a')
    _steps(straight, batches)
    first = _model(recipe, tmp_path / 'b')
    first.train_chunk(batches[:2])
    first.save('latest')
    resumed = _model(recipe, tmp_path / 'b', '--continue_train')
    _steps(resumed, batches[2:])
    _assert_same(_state(resumed), _state(straight))


# -------------------------------------------------------------- driver -- #

class _Recorder:
    """Stands in for a model in either package's train driver: records
    each dispatch as (kind, steps, total steps so far)."""

    def __init__(self):
        self.calls = []
        self.steps = 0
        self.device = torch.device('cpu')

    def train_chunk(self, batches):
        self.steps += len(batches)
        self.calls.append(('chunk', len(batches), self.steps))

    def set_input(self, data):
        pass

    def optimize_parameters(self):
        self.steps += 1
        self.calls.append(('step', 1, self.steps))

    def get_current_errors(self):
        return {'loss': 0.0}

    def get_current_visuals(self):
        return {'real': np.zeros((4, 4, 3), np.uint8)}

    def save(self, label):
        self.calls.append(('save', label, self.steps))

    def update_learning_rate(self):
        pass

    def graph_kernels(self):
        return None

    def flush_checkpoints(self):
        pass


@pytest.fixture(scope='module')
def four_images(tmp_path_factory):
    d = tmp_path_factory.mktemp('chunk_data')
    os.makedirs(d / 'train')
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (36, 36, 3)).astype(
            np.uint8)).save(str(d / 'train' / ('%03d.png' % i)))
    return str(d)


@pytest.mark.parametrize('spd,batch,print_freq', [(2, 1, 3), (3, 1, 3),
                                                   (2, 3, 7)])
def test_driver_flushes_where_jax_does(spd, batch, print_freq, four_images,
                                       tmp_path, monkeypatch):
    """Batches of 3 leave a partial last batch, which the last full one
    flushes before."""
    import train as jtrain
    args = list(test_torch_fcgan.FLAGS)
    args[args.index('--dataroot') + 1] = four_images
    args[args.index('--batchSize') + 1] = str(batch)
    args += ['--steps_per_dispatch', str(spd), '--niter', '2',
             '--niter_decay', '0', '--print_freq', str(print_freq),
             '--display_freq', '100', '--save_latest_freq', '5',
             '--save_epoch_freq', '1',
             '--serial_batches', '--no_flip']
    calls = {}
    for name, module, argv in (('port', ttrain, ['--gpu_ids', '-1']),
                               ('jax', jtrain, [])):
        model = _Recorder()
        monkeypatch.setattr(module, 'create_model', lambda opt: model)
        full = args + argv + ['--checkpoints_dir', str(tmp_path / name)]
        if name == 'jax':
            monkeypatch.setattr(jtrain, 'enable_compilation_cache',
                                lambda: None)
            monkeypatch.setattr(sys, 'argv', ['train.py'] + full)
            jtrain.main()
        else:
            r = ttrain.main(full)
            assert r['chunks'] == [n for kind, n, _ in model.calls
                                   if kind == 'chunk']
        calls[name] = model.calls
    assert calls['port'] == calls['jax']
    assert all(kind != 'step' for kind, _, _ in calls['port'])
    assert sum(n for kind, n, _ in calls['port'] if kind == 'chunk') == \
        2 * -(-4 // batch)


@pytest.mark.parametrize('recipe,order', [
    ('twostage_cycle', ['pool1', 'pool2']), ('fcgan', ['pool'])])
def test_pool_draws_in_update_order(recipe, order, tmp_path, monkeypatch):
    """A step draws its pools' decisions in the order its D updates query
    them, a batch of draws each, as the per-query draws did."""
    model = _model(recipe, tmp_path)
    names = {id(p): n for n, p in model.pools.items()}
    seen = []
    real = base.draw_decisions

    def record(pool, n, generator):
        seen.append((names[id(pool)], n))
        return real(pool, n, generator)

    monkeypatch.setattr(base, 'draw_decisions', record)
    model.set_input(RECIPES[recipe][1](0))
    model.optimize_parameters()
    assert seen == [(n, 1) for n in order]
    seen.clear()
    model.train_chunk(_batches(recipe, 2))
    assert seen == [(n, 1) for n in order] * 2
