"""torch.profiler traces in which every kernel launch has its device record.

The profiler (CUPTI) can lose the device records of the first kernels of a
trace, a count that grows as the process goes on: on the H100 with torch
2.11, 0-20 early in chip_smoke.py and 27-34 in its later phases' traces
without host operators (then a train step's own first kernels, with 32
spins), as many with the spins back to back as 2 ms apart.  So a trace on
a CUDA device opens with PRIMER_SPINS spin kernels and a pause, which take
those losses and which every count here leaves out.  When it stops, the
kernel launches of the traced stretch (the runtime calls in LAUNCH_CALLS,
and for each replay of a captured step's CUDA graph its kernel nodes) are
counted against its device records.

  ``traced(run, n, device)``: a trace of n calls of ``run``, taken again up
      to TRACES times while a launch lost its record, then a failure;
  ``device_rows(prof, n)``: its device events, per call of ``run``;
  ``Trace(device)``: ``start()`` and ``stop()`` around a stretch that cannot
      be run again (the train driver's steps 10-20): ``stop()`` fails when
      a launch lost its record, and the trace is not written.

A profiler that records no device kernel at all (no CUPTI) gives a trace
with no device rows; the caller decides what that means.  On the CPU a
trace records host activity only.  The counterpart of the JAX package's
``jax.profiler`` calls in train.py:47-49, 72-76 and bench.py:179-187.

The port's own spans (PERF.md's layers):

  ``span(name)``: a ``torch.profiler.record_function`` while a profiler
      records, so the span lands in that trace on its clock, nested in the
      span that encloses it; otherwise one shared no-op context, which
      allocates and records nothing;
  ``timed(name)``: the same, and its host time (``time.perf_counter_ns``)
      added to ``TIMES[name] = [calls, seconds]``, totals since the process
      started, one entry a name: for work done a few times a run (set-up).

Nothing else switches them: they are on exactly while a profiler records.
With none, a ``with span(...)`` costs 0.4-0.6 us where a bare
``record_function`` costs 7-12 us (the H100 machine's host, torch 2.11).
"""

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()
TIMES = {}


def span(name):
    """A profiler span ``name`` while a profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def timed(name):
    """``span(name)``, its host time added to ``TIMES[name]``."""
    t = time.perf_counter_ns()
    try:
        with span(name):
            yield
    finally:
        entry = TIMES.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (time.perf_counter_ns() - t) * 1e-9


PRIMER_SPINS = 128
TRACES = 3
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel')
GRAPH_LAUNCH = 'cudaGraphLaunch'


class LostRecords(RuntimeError):
    """The profiler lost the device record of a traced kernel launch."""


def _is_device_row(e):
    """A device event of the traced work: not a user annotation on the
    device timeline (Optimizer.step#Adam.step spans kernels counted already)
    and not one of the primer's spin kernels."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, 'is_user_annotation', False)
            and 'spin_kernel' not in e.key)


def device_rows(prof, n):
    """(key, device ms per run, records per run) of every device event of
    the traced work, for a trace of n runs."""
    return [(e.key, e.self_device_time_total / (n * 1e3), e.count / n)
            for e in prof.key_averages() if _is_device_row(e)]


def kernel_launches(prof):
    """(kernels launched one by one, CUDA graph launches) in a primed trace
    on a CUDA device, the primer's spins left out."""
    events = prof.key_averages()
    return (sum(e.count for e in events if e.key in LAUNCH_CALLS)
            - PRIMER_SPINS,
            sum(e.count for e in events if e.key.startswith(GRAPH_LAUNCH)))


def is_copy(key):
    return key.startswith(('Memcpy', 'Memset'))


class Trace:
    """One torch.profiler trace on ``device`` (a torch.device or its
    name), primed on a CUDA device.  ``host``: record the host's operators
    too (on a CUDA device the runtime's launch calls are recorded either
    way); without them a train step's trace holds less than half the events
    to read back."""

    def __init__(self, device, host=True):
        self.cuda = torch.device(device).type == 'cuda'
        self.host = host or not self.cuda
        self.prof = None
        self.primer_lost = self.launches = self.kernels = None
        self.graph_launches = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] if self.host else []
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        if self.cuda:
            for _ in range(PRIMER_SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
        return self

    def stop(self, graph_kernels=None):
        """Wait for the device, end the trace and count it.  Raises
        LostRecords when a launch of the traced stretch has no device
        record (and the profiler recorded some); ``graph_kernels``: the
        kernel nodes of the CUDA graph the stretch replays, each replay a
        launch of each (models/graph.py).  On the CPU it only ends the
        trace: there is no device record to count."""
        if not self.cuda:
            self.prof.stop()
            return self
        torch.cuda.synchronize()
        self.prof.stop()
        events = self.prof.key_averages()
        launches, self.graph_launches = kernel_launches(self.prof)
        if self.graph_launches:
            if graph_kernels is None:
                raise ValueError('the trace replays a CUDA graph: give its '
                                 'kernel nodes (graph_kernels)')
            launches += self.graph_launches * graph_kernels
        spins = sum(e.count for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and 'spin_kernel' in e.key)
        self.launches = launches
        self.primer_lost = PRIMER_SPINS - spins
        self.kernels = sum(e.count for e in events
                           if _is_device_row(e) and not is_copy(e.key))
        if self.kernels and self.kernels != self.launches:
            raise LostRecords('%d kernel launches, %d device records'
                              % (self.launches, self.kernels))
        return self

    def export(self, directory):
        """Write the trace as a Chrome trace (``*.pt.trace.json``, as
        torch.profiler.tensorboard_trace_handler names it); returns its
        path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, '%s_%d.%d.pt.trace.json' % (
            os.uname().nodename, os.getpid(), time.time_ns()))
        self.prof.export_chrome_trace(path)
        return path


def traced(run, n, device='cuda', host=True, graph_kernels=None):
    """A torch.profiler trace of n calls of ``run`` in which every kernel
    launch has its device record, traced again up to TRACES times
    (``graph_kernels`` as Trace.stop takes it).  Returns (the profile, how
    many of the primer's records it lost; None on the CPU)."""
    for attempt in range(1, TRACES + 1):
        trace = Trace(device, host).start()
        for _ in range(n):
            run()
        try:
            trace.stop(graph_kernels)
            return trace.prof, trace.primer_lost
        except LostRecords as e:
            print('  trace %d: %s' % (attempt, e))
    raise LostRecords('profiler lost device records in %d traces' % TRACES)
