"""The port's own spans and timed sections (utils/profile.py ``span``,
``timed``, ``TIMES``) on the CPU, at the narrow widths of
test_torch_chunk.py's models:

  * with no profiler recording, ``span`` is one shared no-op context and
    writes nothing; with one, a CPU event of its trace holding what ran
    inside it;
  * under a CPU torch.profiler, a 3-batch ``train_chunk`` of a narrow
    twostage_cycle and of a narrow cgan model records the dispatch path's
    spans nested by time: dispatch.train_chunk holding a
    dispatch.stage_inputs a batch (each holding its dispatch.host_inputs,
    then its dispatch.to_device), batch 0's first, then dispatch.stage_rows,
    then an eager step a batch, batch i + 1 staged inside a
    dispatch.stage_ahead after step i begins and before step i + 1; and
    set_input + optimize_parameters records one batch's staging, the rows
    and its step, nothing ahead;
  * ``create_model`` adds one ``models.init`` call to TIMES;
  * the state after a chunk is bitwise the same with the profiler on and
    off.
"""

import pytest
import torch

from supervised_gan_tpu_torch.models import create_model as tcreate
from supervised_gan_tpu_torch.options import TrainOptions as TTrainOptions
from supervised_gan_tpu_torch.utils import profile

import test_torch_cgan
import test_torch_train_step
from test_torch_chunk import _assert_same, _state
from test_torch_layout import one_thread  # noqa: F401

RECIPES = {
    'twostage_cycle': (test_torch_train_step.FLAGS,
                       test_torch_train_step._batch),
    'cgan': (test_torch_cgan.FLAGS, test_torch_cgan._batch)}
PREFIXES = ('dispatch.', 'graph.', 'models.')


def _model(recipe, ckpt):
    flags, _ = RECIPES[recipe]
    return tcreate(TTrainOptions().parse(
        flags + ['--checkpoints_dir', str(ckpt), '--pool_size', '2',
                 '--gpu_ids', '-1']))


def _batches(recipe, n):
    return [RECIPES[recipe][1](s) for s in range(n)]


def _run(model, path, batches):
    if path == 'chunk':
        model.train_chunk(batches)
    else:
        for b in batches:
            model.set_input(b)
            model.optimize_parameters()


def _profiled(fn):
    """The port's spans recorded while ``fn`` runs under a CPU profiler:
    {name: [(start, end), ...]} in time order, from the profiler's raw
    records (``prof.events()`` would build a tree of every plain op, tens of
    seconds for a chunk)."""
    with profiler() as prof:
        fn()
    out = {}
    for e in sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns()):
        if e.name().startswith(PREFIXES):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def profiler():
    from torch.profiler import ProfilerActivity, profile as tprofile
    return tprofile(activities=[ProfilerActivity.CPU])


def _inside(a, b):
    return b[0] <= a[0] and a[1] <= b[1]


def test_span_off_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    before = {k: list(v) for k, v in profile.TIMES.items()}
    first = profile.span('dispatch.train_chunk')
    assert first is profile.span('graph.replay')
    with first:
        with profile.span('dispatch.stage_rows'):
            pass
    assert profile.TIMES == before
    # on while a profiler records: a CPU event of the trace, as the
    # benchmark's readers see them
    with profiler() as prof:
        with profile.span('dispatch.stage_rows'):
            torch.ones(2).add_(1)
    (e,) = [e for e in prof.events() if e.name == 'dispatch.stage_rows']
    assert e.device_type == torch.autograd.DeviceType.CPU
    assert any(c.name == 'aten::add_' for c in e.cpu_children)
    assert profile.TIMES == before


@pytest.mark.parametrize('path', ['chunk', 'step'])
@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_dispatch_spans_nest_by_time(recipe, path, tmp_path):
    model = _model(recipe, tmp_path)
    batches = _batches(recipe, 3 if path == 'chunk' else 1)
    eager = list(profile.TIMES.get('dispatch.eager_step', [0, 0.0]))
    spans = _profiled(lambda: _run(model, path, batches))
    n = len(batches)
    want = {'dispatch.stage_inputs': n, 'dispatch.host_inputs': n,
            'dispatch.to_device': n, 'dispatch.stage_rows': 1,
            'dispatch.eager_step': n}
    if path == 'chunk':
        want['dispatch.train_chunk'] = 1
        want['dispatch.stage_ahead'] = n - 1
    assert {k: len(v) for k, v in spans.items()} == want
    stages, hosts, copies = (spans['dispatch.stage_inputs'],
                             spans['dispatch.host_inputs'],
                             spans['dispatch.to_device'])
    for stage, host, copy in zip(stages, hosts, copies):
        assert _inside(host, stage) and _inside(copy, stage)
        assert host[1] <= copy[0]
    rows, steps = spans['dispatch.stage_rows'], spans['dispatch.eager_step']
    assert stages[0][1] <= rows[0][0] and rows[0][1] <= steps[0][0]
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    # batch i + 1 is staged behind step i: after it begins, before the next
    for i, ahead in enumerate(spans.get('dispatch.stage_ahead', [])):
        assert _inside(stages[i + 1], ahead)
        assert steps[i][0] <= hosts[i + 1][0]
        assert ahead[1] <= steps[i + 1][0]
    if path == 'chunk':
        (chunk,) = spans['dispatch.train_chunk']
        assert all(_inside(s, chunk) for s in stages + rows + steps
                   + spans['dispatch.stage_ahead'])
    # an eager step is timed whether or not a profiler records
    done = profile.TIMES['dispatch.eager_step']
    assert done[0] == eager[0] + n and done[1] > eager[1]


@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_create_model_times_one_init(recipe, tmp_path):
    before = list(profile.TIMES.get('models.init', [0, 0.0]))
    _model(recipe, tmp_path)
    after = profile.TIMES['models.init']
    assert after[0] == before[0] + 1 and after[1] > before[1]


@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_chunk_state_same_with_profiler_on_and_off(recipe, tmp_path):
    batches = _batches(recipe, 3)
    off = _model(recipe, tmp_path / 'off')
    off.train_chunk(batches)
    on = _model(recipe, tmp_path / 'on')
    spans = _profiled(lambda: on.train_chunk(batches))
    assert spans['dispatch.train_chunk']
    _assert_same(_state(on), _state(off))
