"""graph.capture_s: seconds of the capture of the program's step graph
(models/graph.py StepGraph: the capture and its instantiation) in the run's
process, from the program's TIMES table; nothing where the program has no
such entry."""

from portbench import spans


def read(r):
    return spans.timed_s('graph.capture_s')
