"""A chunk's inputs staged batch by batch behind its steps (models/base.py
``train_chunk``), on the CPU at the narrow widths of test_torch_chunk.py's
models, twostage_cycle and cgan:

  * ``TIMES['dispatch.stage_ahead']`` gains k - 1 calls a ``train_chunk`` of
    k batches (each batch after the first, staged behind the step before
    it), and none from set_input + optimize_parameters;
  * the benchmark's ``batch0`` fault (portbench/harness.py ``plant``: every
    step of a chunk fed the chunk's first batch through a wrapped
    ``train_chunk_stacked``) still reaches every step: a planted 3-batch
    chunk leaves a state unlike the plain chunk's, and bitwise the state of
    three steps on batch 0.
"""

import types

import pytest

from portbench.harness import plant
from supervised_gan_tpu_torch.utils import profile

from test_torch_chunk import _assert_same, _state
from test_torch_layout import one_thread  # noqa: F401
from test_torch_spans import RECIPES, _batches, _model


def _calls():
    return profile.TIMES.get('dispatch.stage_ahead', [0, 0.0])[0]


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_stage_ahead_counts_k_minus_1_a_chunk(recipe, k, tmp_path):
    model = _model(recipe, tmp_path)
    batches = _batches(recipe, 2 * k)
    before = _calls()
    model.train_chunk(batches[:k])
    assert _calls() == before + k - 1
    model.train_chunk(batches[k:])
    assert _calls() == before + 2 * (k - 1)


@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_step_path_stages_nothing_ahead(recipe, tmp_path):
    model = _model(recipe, tmp_path)
    before = _calls()
    for b in _batches(recipe, 3):
        model.set_input(b)
        model.optimize_parameters()
    assert _calls() == before


@pytest.mark.parametrize('recipe', sorted(RECIPES))
def test_batch0_fault_reaches_every_step(recipe, tmp_path):
    batches = _batches(recipe, 3)
    plain = _model(recipe, tmp_path / 'plain')
    plain.train_chunk(batches)
    planted = _model(recipe, tmp_path / 'planted')
    plant(types.SimpleNamespace(model=planted), 'batch0')
    planted.train_chunk(batches)
    first = _model(recipe, tmp_path / 'first')
    for _ in batches:
        first.set_input(batches[0])
        first.optimize_parameters()
    _assert_same(_state(planted), _state(first))
    with pytest.raises(AssertionError):
        _assert_same(_state(planted), _state(plain))
