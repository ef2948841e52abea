"""What the per-layer readers read of the program's own spans and timed
sections (supervised_gan_tpu_torch/utils/profile.py ``span``, ``timed``,
``TIMES``), by the names in data/program_spans.json.

A program without them (one that records no such span, or has no such
table) gives nothing: the readers then return None.
"""

import json
import sys
from pathlib import Path

NAMES = Path(__file__).resolve().parent / 'data' / 'program_spans.json'


def names():
    with open(NAMES) as f:
        return json.load(f)


def union(intervals, lo, hi):
    """The merged (start, end) pairs of ``intervals`` clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(i.start, lo), min(i.end, hi))
                       for i in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap_s(a, b):
    """Seconds shared by two lists of disjoint (start, end) pairs."""
    return sum(max(0.0, min(e1, e2) - max(s1, s2))
               for s1, e1 in a for s2, e2 in b)


def staging(summary):
    """The merged staging spans of a trace.Summary inside its window, or
    None where the trace has none."""
    wanted = set(names()['staging'])
    found = [i for i in summary.host if i.name in wanted]
    if not found:
        return None
    return union(found, summary.lo, summary.hi)


def timed_s(metric):
    """Seconds the program's timed section read by ``metric`` took in this
    process, or None where the program has no such section."""
    n = names()
    times = getattr(sys.modules.get(n['module']), 'TIMES', None)
    entry = (times or {}).get(n['timed'][metric])
    return None if entry is None else entry[1]
