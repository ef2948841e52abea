"""graph.kernels_outside_per_step: kernels launched one by one beside the
CUDA graph replays of the traced stretch, per step (the copies of the
inputs and pool rows into the graph's tensors); nothing where no graph
was replayed."""


def read(r):
    if not r.trace.graph_launches:
        return None
    return r.trace.launches_outside / r.trace.steps
