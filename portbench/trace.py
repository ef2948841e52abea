"""torch.profiler traces of the program's dispatches, and what they say.

Copied from supervised_gan_tpu_torch/utils/profile.py (the primer, the
launch count with CUDA graph replays, the lost-record check), so that the
yardstick stays fixed whatever the program does to its own copy:

  * the profiler (CUPTI) can lose the device records of a trace's first
    kernels, so a trace opens with PRIMER_SPINS spin kernels and a pause,
    which every count leaves out;
  * when it stops, the kernel launches of the traced stretch (the runtime
    calls in LAUNCH_CALLS, and for each replay of a captured CUDA graph its
    kernel nodes) are counted against its device records; a trace that
    lost one, or lost every spin's, is taken again, at most TRACES times.

``Summary`` reads a trace: every device interval
(kernels, copies, sets) and every host operator in the profiler's clock,
the window between the first traced dispatch's start and the last one's
end (the harness's record_function spans), and the launches made outside
graph replays.
"""

import collections
import ctypes
import sys
import time

import torch

PRIMER_SPINS = 128
TRACES = 3
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel')
GRAPH_LAUNCH = 'cudaGraphLaunch'
DISPATCH_SPAN = 'portbench.dispatch'
CALL_SPAN = 'portbench.call'


class LostRecords(RuntimeError):
    """The profiler lost the device record of a traced kernel launch."""


def is_copy(key):
    return key.startswith(('Memcpy', 'Memset'))


def _is_device(e):
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and 'spin_kernel' not in e.name)


def kernel_launches(events):
    """(kernels launched one by one, CUDA graph launches) of a primed trace,
    the primer's spins left out."""
    one = sum(1 for e in events if e.name in LAUNCH_CALLS) - PRIMER_SPINS
    return one, sum(1 for e in events if e.name.startswith(GRAPH_LAUNCH))


# CUgraphNodeType: a kernel node leaves one device record a replay; a
# child graph's kernel nodes are counted in it.  (Memset nodes leave a
# record too, as a kernel or as a Memset, so records may exceed the count.)
NODE_KERNEL, NODE_GRAPH = 0, 4


def graph_kernels(graph):
    """The kernel nodes of a captured torch.cuda.CUDAGraph (built with
    keep_graph=True), child graphs included, read through libcuda."""
    cuda = ctypes.CDLL('libcuda.so.1')

    def count(handle):
        n = ctypes.c_size_t(0)
        if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
            raise RuntimeError('cuGraphGetNodes failed')
        nodes = (ctypes.c_void_p * n.value)()
        if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
            raise RuntimeError('cuGraphGetNodes failed')
        kind, total = ctypes.c_int(0), 0
        for node in nodes:
            node = ctypes.c_void_p(node)
            if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)):
                raise RuntimeError('cuGraphNodeGetType failed')
            if kind.value == NODE_KERNEL:
                total += 1
            elif kind.value == NODE_GRAPH:
                child = ctypes.c_void_p(0)
                if cuda.cuGraphChildGraphNodeGetGraph(node,
                                                      ctypes.byref(child)):
                    raise RuntimeError('cuGraphChildGraphNodeGetGraph failed')
                total += count(child)
        return total

    return count(ctypes.c_void_p(graph.raw_cuda_graph()))


def trace(run, n, graph_kernels=None):
    """A primed trace of n calls of ``run`` in which no kernel launch lost its
    device record; returns the profile.  ``graph_kernels``: the kernel nodes
    of the CUDA graph that ``run`` replays.  The profiler loses a prefix of
    a trace's records: a trace is kept when some of the primer's spins kept
    theirs, and the traced stretch has at least one kernel record a
    launch."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, TRACES + 1):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        for _ in range(PRIMER_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        prof.stop()
        events = prof.events()
        one, graphs = kernel_launches(events)
        if graphs and graph_kernels is None:
            raise ValueError('the trace replays a CUDA graph: give its '
                             'kernel nodes')
        launches = one + graphs * (graph_kernels or 0)
        records = sum(1 for e in events if _is_device(e)
                      and not is_copy(e.name))
        spins = sum(1 for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and 'spin_kernel' in e.name)
        if spins and records >= launches:
            return prof
        print('trace %d: %d kernel launches, %d device records, %d of %d '
              'spins' % (attempt, launches, records, spins, PRIMER_SPINS),
              file=sys.stderr)
    raise LostRecords('profiler lost device records in %d traces' % TRACES)


Interval = collections.namedtuple('Interval', 'name start end')


class Summary:
    """A trace's device intervals and host operators (seconds, profiler
    clock), its window and its launch counts."""

    def __init__(self, prof, steps):
        events = prof.events()
        self.steps = steps
        self.device = sorted(
            (Interval(e.name, e.time_range.start * 1e-6,
                      e.time_range.end * 1e-6)
             for e in events if _is_device(e)), key=lambda i: i.start)
        self.host = [Interval(e.name, e.time_range.start * 1e-6,
                              e.time_range.end * 1e-6)
                     for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU]
        spans = [i for i in self.host if i.name.startswith(DISPATCH_SPAN)]
        if not spans:
            raise RuntimeError('trace: no %s span' % DISPATCH_SPAN)
        self.lo = min(i.start for i in spans)
        self.hi = max(i.end for i in spans)
        self.launches_outside, self.graph_launches = kernel_launches(events)

    @property
    def window_s(self):
        return self.hi - self.lo

    def busy(self):
        """The union of the device intervals inside the window, as merged
        (start, end) pairs."""
        merged = []
        for i in self.device:
            s, e = max(i.start, self.lo), min(i.end, self.hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy())

    def gaps(self):
        """(start, end) of every stretch of the window with no device
        interval."""
        out, t = [], self.lo
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.hi:
            out.append((t, self.hi))
        return out

    def host_at(self, t):
        """The innermost host operator running at time t (the shortest one
        that spans it), or 'none'."""
        best = None
        for i in self.host:
            if i.start <= t <= i.end and (best is None or
                                          i.end - i.start
                                          < best.end - best.start):
                best = i
        return best.name if best is not None else 'none'

    def device_s_by_name(self):
        out = collections.Counter()
        for i in self.device:
            out[i.name] += i.end - i.start
        return out

    def breakdown(self, top=10):
        ops = self.device_s_by_name().most_common(top)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {'device_ops': [[k, v] for k, v in ops],
                'idle_gaps': [[self.host_at((s + e) / 2), e - s]
                              for s, e in gaps]}
