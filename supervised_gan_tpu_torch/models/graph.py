"""One train step captured as a CUDA graph and replayed: the port's
counterpart of the JAX package's chunked dispatch (``train_chunk``,
models/base.py:298-391 there), which scans k steps in one device call.  A
step enqueues a few thousand kernels; a replay enqueues them in one call.

The graph holds one step, so a chunk of any length replays it.  What a
step reads, it reads from tensors the graph owns: the step inputs
(``STEP_INPUTS``) and the pool rows are copied in on the device before each
replay.  What it writes in place (parameters, Adam's moments, steps and
rates, BatchNorm statistics, the pools' images) is the model's own state,
so eager steps and replays can follow each other in any order; what it
returns (``STEP_OUTPUTS``: metrics, taps) lives in the graph and is bound
to the model again after each replay.  Random numbers come from the
model's noise generator, registered with the graph, so each replay draws
what an eager step would draw next.

A captured step must not synchronize the host with the device (a pageable
host copy, ``.item()``, a branch on a device value): the capture raises.
"""

import ctypes

import torch
import torch.distributed

CU_GRAPH_NODE_TYPE_KERNEL = 0


def kernel_nodes(graph):
    """The kernel nodes of a captured torch.cuda.CUDAGraph (built with
    keep_graph=True), through the driver API."""
    cuda = ctypes.CDLL('libcuda.so.1')
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError('cuGraphGetNodes failed')
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError('cuGraphGetNodes failed')
    kind = ctypes.c_int(0)
    count = 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError('cuGraphNodeGetType failed')
        count += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    return count


class StepGraph:
    """``model.train_step()`` captured once, on inputs shaped as ``inputs``
    ({STEP_INPUTS name: tensor}) and pool rows shaped as ``rows``."""

    def __init__(self, model, inputs, rows):
        if torch.distributed.is_initialized():
            # its collectives would be captured too: not supported yet
            raise RuntimeError('a train step is not captured inside a process '
                               'group: data-parallel chunks run eagerly')
        self.inputs = {name: torch.empty_like(t) for name, t in inputs.items()}
        self.rows = None if rows is None else torch.empty_like(rows)
        self._bind(model)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.register_generator_state(model.noise_generator)
        with torch.cuda.graph(self.graph):
            model.train_step()
        self.graph.instantiate()
        self.outputs = {name: getattr(model, name)
                        for name in model.STEP_OUTPUTS}
        self.kernels = kernel_nodes(self.graph)

    def _bind(self, model):
        for name, t in self.inputs.items():
            setattr(model, name, t)
        model._rows = self.rows

    def replay(self, model, inputs, rows):
        """One step on ``inputs`` and ``rows`` (device tensors): copied in,
        replayed, the outputs bound to ``model``."""
        for name, t in inputs.items():
            self.inputs[name].copy_(t)
        if rows is not None:
            self.rows.copy_(rows)
        self._bind(model)
        self.graph.replay()
        for name, v in self.outputs.items():
            setattr(model, name, v)
