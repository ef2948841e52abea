"""The check against faults in the timed path: a run of each cell's traffic
(every cell of BENCHMARK.json) on the CPU at its configuration's narrow
widths (``cpu_test_flags``; the chip's look skipped), with the program
broken underneath the harness, must come out not correct under the cell's
own limits; the same run unbroken comes out correct.  The one fault of
the benchmark's list that the cells can have: a step that leaves the state
unchanged (their batch is 1, so no half of it to leave out; one card, so no
exchange between chips; a training step produces no token or answer).
And one of the chunk's staging: every step of a chunk fed its first
batch.

The seam: a configuration that brings its reference class (a generator of
its own, the ResNet-9-block) and a kernel family in files of its own
(fixture_recipe.py), which no file of the harness names, runs to
``correct`` and has its family's calls costed by
the code that costs the families the harness finds itself."""

import importlib
import json
import re
import types

import pytest
import torch

from portbench import check, harness, roofline

BENCH = harness.benchmark()
CASES = [(w['name'], fault) for w in BENCH['workloads']
         for fault in (None, 'frozen', 'batch0')]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def drive(cell, fault, seed=21, bench=BENCH):
    """The run's steps after the look for a card, in float32 at the
    configuration's narrow widths: set-up, a short window, the program
    freed, the reference, the verdict."""
    flags = dict(harness.lookup(bench, cell)[2]['cpu_test_flags'],
                 compute_dtype='float32')
    run = harness.Run(cell, seed, 'cpu', flags=flags, fault=fault,
                      bench=bench)
    prog = run.setup()
    window = run.window(0.01)
    assert harness.end_to_end(window, run.mix['batch'], 1.0)['train_img_s']
    run.free()
    return check.verdict(check.gaps(prog, run.reference(), run.subsets),
                         run.limits)


@pytest.mark.parametrize('cell,fault', CASES)
def test_a_broken_step_is_not_correct(cell, fault):
    ok, checks = drive(cell, fault)
    assert ok == (fault is None), checks


# ------------------------------------------------------------- the seam -- #
FIXTURE = 'portbench/tests/fixture_recipe.py'
SEAM_CELL = 'sgan.b1.chunk10'


def fixture_bench(tmp_path, reference):
    """BENCHMARK.json with SEAM_CELL's configuration swapped for a copy of
    it written under tmp_path, with the ResNet-9-block generator and
    ``reference`` as its reference (none where None); the cell keeps its
    traffic and its limits."""
    _, listed, conf = harness.lookup(BENCH, SEAM_CELL)[:3]
    conf = dict(conf, name='fixture-cgan', flags=dict(
        conf['flags'], which_model_netG='resnet_9blocks'))
    conf.pop('reference')
    if reference is not None:
        conf['reference'] = reference
    path = tmp_path / 'fixture-cgan.json'
    path.write_text(json.dumps(conf))
    configs = BENCH['configs'] + [dict(listed, name='fixture-cgan',
                                       file=str(path))]
    workloads = [dict(x, config='fixture-cgan') if x['name'] == SEAM_CELL
                 else x for x in BENCH['workloads']]
    return dict(BENCH, configs=configs, workloads=workloads), path


def test_a_configuration_brought_in_new_files_runs_correct(tmp_path):
    bench, _ = fixture_bench(tmp_path, FIXTURE + ' FixtureCGAN')
    run = harness.Run(SEAM_CELL, 21, 'cpu', bench=bench)
    assert run.recipe.__name__ == 'FixtureCGAN'
    fixture = importlib.import_module('portbench.tests.fixture_recipe')
    ref = run.recipe(dict(run.flags, ngf=2, ndf=2), 'cpu')
    assert isinstance(ref.nets['G'], fixture.Resnet)
    assert ref.optG.params() == list(ref.nets['G'].parameters())
    ok, checks = drive(SEAM_CELL, None, bench=bench)
    assert ok, checks

    fams = dict(roofline.families(), fixture=fixture)
    fns = types.SimpleNamespace(fixture_scale=lambda x: 2 * x,
                                conv3x3=lambda x, w, b=None: x)
    x = torch.ones(1, 4, 8, 8)
    with roofline.recording(fns, fams) as calls:
        assert torch.equal(fns.fixture_scale(x), 2 * x)
        fns.conv3x3(x, torch.empty(2, 4, 3, 3))
    assert [(c.entry, c.family) for c in calls] == [
        ('fixture_scale', 'fixture'), ('conv3x3', 'conv3x3')]
    assert (calls[0].flops, calls[0].bytes) == (256.0, 2048.0)
    assert calls[0].bound_s == roofline.bound_s(256.0, 2048.0,
                                                roofline.PEAK_F32_FLOPS)
    assert calls[1].flops == 2.0 * 2 * 64 * 4 * 9


@pytest.mark.parametrize('reference', [
    FIXTURE + ' NoSuchRecipe', 'portbench/tests/no_such_module.py CGAN',
    FIXTURE, None])
def test_a_configuration_without_its_reference_class_stops(tmp_path,
                                                           reference):
    bench, path = fixture_bench(tmp_path, reference)
    with pytest.raises(SystemExit, match=re.escape(str(path))):
        harness.Run(SEAM_CELL, 1, 'cpu', bench=bench)
