"""The plain reference against supervised_gan_tpu_torch on the CPU: each
cell of BENCHMARK.json at its configuration's narrow widths
(``cpu_test_flags``: every net and loss of the configuration, 256 px),
the checked train steps (two eager, then a chunk of 10) from the same
seeded weights, pools, images and draws, in float32.  Both sides then
compute one function: the first step's numbers are at rounding size, the
later ones carry what Adam makes of it; and the control (the reference in
fp8) reads far above the program in bf16."""

import pytest
import torch

from portbench import check, harness

BENCH = harness.benchmark()
CELLS = sorted(w['name'] for w in BENCH['workloads'])


def narrow(cell):
    """The CPU tests' narrow widths of the cell's configuration."""
    return harness.lookup(BENCH, cell)[2]['cpu_test_flags']


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def readings(cell, seed, dtype, precision='f32'):
    run = harness.Run(cell, seed, 'cpu',
                      flags=dict(narrow(cell), compute_dtype=dtype))
    prog = run.setup(warmup=False)
    run.free()
    return prog, run.reference(), run


@pytest.mark.parametrize('cell', CELLS)
def test_reference_equals_port_f32(cell):
    prog, ref, run = readings(cell, 7, 'float32')
    found = check.gaps(prog, ref, run.subsets)
    # the first step's losses are one forward apart, the second's one
    # Adam step; the first moments are the first gradients
    assert found['loss1'][0] < 1e-5, found['loss1']
    assert found['loss2'][0] < 2e-4, found['loss2']
    assert found['grad'][0] < 1e-2, found['grad']
    # the chunk's last step, in the losses the cell compares there (a
    # discriminator's terms swing by then: PERF.md)
    last = [k for k in found if k.startswith('loss12')][-1]
    assert found[last][0] < 1e-3, (last, found[last])
    # twelve Adam steps move each weight by about lr * sign(g) a step: a
    # rounding-sized gradient entry flips sign on one side, and a leaf
    # with many of them changes by another norm
    assert found['change'][0] < 0.15, found['change']


@pytest.mark.parametrize('cell', CELLS)
def test_control_reads_above_the_program(cell):
    """bf16 program against the fp8 control, both against the f32
    reference: on one of the loss numbers the cell compares, the numbers
    that fail the control on the chip, the control lies well above the
    program at this size too."""
    prog, ref, run = readings(cell, 8, 'bfloat16')
    ctl = run.reference('fp8')
    p = check.gaps(prog, ref, run.subsets)
    c = check.gaps(ctl, ref, run.subsets)
    ratio = max(c[k][0] / max(p[k][0], 1e-30) for k in run.limits
                if k.startswith('loss'))
    assert ratio > 3, (p, c)


@pytest.mark.parametrize('cell', CELLS)
def test_weights_keys_match_the_port(cell):
    """One set of weights loads strictly into both sides: the reference's
    state_dict layout is the port's."""
    run = harness.Run(cell, 3, 'cpu', flags=narrow(cell))
    program = harness.Program(run.flags, run.mix, 3, 4, torch.device('cpu'),
                              'pb_keys')
    from portbench import weights
    state = weights.make(run.recipe(run.flags, 'cpu'), 5, 'cpu')
    program.load(state)
    for label, net in program.model.nets().items():
        for k, v in net.state_dict().items():
            assert torch.equal(v, state[label][k]), (label, k)
