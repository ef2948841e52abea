"""dispatch.stage_exposed_ms_per_step: device-idle ms a step that fall
inside the program's staging spans (dispatch.stage_inputs,
dispatch.stage_rows) in the traced stretch: the trace's gaps intersected
with those spans, clipped to its window; nothing where the program records
no such span."""

from portbench import spans


def read(r):
    staged = spans.staging(r.trace)
    if staged is None:
        return None
    return spans.overlap_s(staged, r.trace.gaps()) / r.trace.steps * 1e3
