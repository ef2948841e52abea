"""dispatch.stage_ms_per_step: host ms a step inside the program's staging
spans (dispatch.stage_inputs: the host inputs, the stack and the copy of a
chunk's batches; dispatch.stage_rows: the pools' decisions and their copy)
in the traced stretch; nothing where the program records no such span."""

from portbench import spans


def read(r):
    staged = spans.staging(r.trace)
    if staged is None:
        return None
    return sum(e - s for s, e in staged) / r.trace.steps * 1e3
