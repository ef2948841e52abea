"""The check against faults in the timed path: a run of each cell's traffic
on the CPU at narrow widths (the chip's look skipped), with the program
broken underneath the harness, must come out not correct under the cell's
own limits; the same run unbroken comes out correct.  The one fault of
the benchmark's list that the cells can have: a step that leaves the state
unchanged (their batch is 1, so no half of it to leave out; one card, so no
exchange between chips; a training step produces no token or answer).
And one of the chunk's staging: every step of a chunk fed its first
batch."""

import pytest
import torch

from portbench import check, harness

NARROW = {'dsgan': dict(fineSize=256, noiseSize1=2, noiseSize2=4, ngf1=4,
                        ngf2=4, nff2=4, ndf1=4, ndf2=4,
                        compute_dtype='float32'),
          'sgan': dict(fineSize=256, ngf=4, ndf=4, compute_dtype='float32')}
CASES = [(cell, fault) for cell in ('dsgan.b1.chunk10', 'sgan.b1.chunk10')
         for fault in (None, 'frozen', 'batch0')]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def drive(cell, fault, seed=21):
    """The run's steps after the look for a card: set-up, a short window,
    the program freed, the reference, the verdict."""
    run = harness.Run(cell, seed, 'cpu', flags=NARROW[cell.split('.')[0]],
                      fault=fault)
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
