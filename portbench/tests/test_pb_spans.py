"""The readers of the program's spans and timed sections on made-up
numbers: the staging spans' host ms and the device-idle ms inside them on a
synthetic trace, and the set-up's sections from a planted TIMES table; a
program without them gives nothing."""

import sys
import types

import pytest

from portbench import harness, spans, trace
from test_pb_arithmetic import Event, summary

SETUP = {'models.init_s': 3.5, 'dispatch.eager_steps_s': 7.25,
         'graph.capture_s': 0.5}


def staged_trace(with_spans=True):
    """Window 1000-2000 us, 2 steps; the device busy 1000-1200, 1500-1600
    (a copy) and 1900-2000, so idle 1200-1500 and 1600-1900."""
    ev = [Event(trace.DISPATCH_SPAN, 1000, 2000, False),
          Event('k_a', 1000, 1200, True),
          Event('Memcpy HtoD', 1500, 1600, True),
          Event('k_c', 1900, 2100, True),
          Event('graph.replay', 1800, 1900, False)]
    if with_spans:
        ev += [
            # part of k_a, the first gap whole, half the copy
            Event('dispatch.stage_inputs', 1100, 1550, False),
            Event('dispatch.host_inputs', 1150, 1400, False),
            # inside the second gap
            Event('dispatch.stage_rows', 1700, 1800, False),
            # busy, and cut at the window's end
            Event('dispatch.stage_rows', 1950, 2050, False)]
    return summary(ev, steps=2)


def test_staging_readers_on_a_known_trace():
    r = types.SimpleNamespace(trace=staged_trace())
    # (450 + 100 + 50) us of staging over 2 steps
    assert harness.reader('dispatch.stage_ms_per_step')(r) == \
        pytest.approx(0.3)
    # (300 + 100) us of it with the device idle
    assert harness.reader('dispatch.stage_exposed_ms_per_step')(r) == \
        pytest.approx(0.2)


@pytest.mark.parametrize('metric', ['dispatch.stage_ms_per_step',
                                    'dispatch.stage_exposed_ms_per_step'])
def test_staging_readers_give_nothing_without_spans(metric):
    r = types.SimpleNamespace(trace=staged_trace(with_spans=False))
    assert harness.reader(metric)(r) is None


def plant(monkeypatch, times):
    module = spans.names()['module']
    if times is None:
        monkeypatch.delitem(sys.modules, module, raising=False)
    else:
        monkeypatch.setitem(sys.modules, module,
                            types.SimpleNamespace(TIMES=times))


@pytest.mark.parametrize('metric', sorted(SETUP))
def test_setup_readers_read_the_planted_table(metric, monkeypatch):
    names = spans.names()['timed']
    plant(monkeypatch, {names[m]: [2, v] for m, v in SETUP.items()})
    assert harness.reader(metric)(None) == SETUP[metric]
    plant(monkeypatch, {names[m]: [1, v] for m, v in SETUP.items()
                        if m != metric})
    assert harness.reader(metric)(None) is None
    plant(monkeypatch, None)
    assert harness.reader(metric)(None) is None
