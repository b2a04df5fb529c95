"""The program's own spans in a ``Trace``: the union of the intervals of
the spans a reader names, on any thread, the device's idle time inside
that union (and outside another), and the activities launched inside it.

The program names its spans ``more4d.<phase>`` (the port's
``utils/profiling.py SPANS``). A program without them, as the port was
before it had them, leaves every reader here with nothing to read: each
returns None then, never 0.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

from h100_bench.yardstick.trace import Activity, Trace, idle_gaps

Match = Union[str, Tuple[str, ...]]
Intervals = List[Tuple[int, int]]

# the program's phases as the readers take them
ATTN = "more4d.attn"
REQUEST = "more4d.denoise"
DIT = ("more4d.dit.embed", "more4d.dit.backbone", "more4d.dit.finalize")
FWD_BWD = ("more4d.train.forward", "more4d.train.backward")
UPDATE = ("more4d.train.clamp", "more4d.train.optimizer",
          "more4d.train.ema")


def matcher(names: Match) -> Callable[[str], bool]:
    """A span name's test: is it ``names``, or one of them."""
    return ({names} if isinstance(names, str) else set(names)).__contains__


def union(trace: Trace, names: Match) -> Intervals:
    """The named spans' intervals, on any thread, merged and clipped to the
    window, in order."""
    match = matcher(names)
    lo, hi = trace.window()
    out: Intervals = []
    for s, e in sorted((max(s.start, lo), min(s.end, hi))
                       for s in trace.spans if match(s.name)):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """The intersection of two ordered lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(a: Intervals) -> int:
    return sum(e - s for s, e in a)


def idle_ns(trace: Trace, inside: Match,
            outside: Optional[Match] = None) -> Optional[int]:
    """Nanoseconds of the window in which nothing ran on the device and
    the host was inside a span ``inside`` names, and not inside one
    ``outside`` names; None where the window holds no such span or no
    device activity at all (a trace of the host alone)."""
    within = union(trace, inside)
    if not within or not trace.in_window():
        return None
    idle = intersect(idle_gaps(trace), within)
    if outside is None:
        return length(idle)
    return length(idle) - length(intersect(idle, union(trace, outside)))


def launched(trace: Trace, names: Match) -> Optional[List[Activity]]:
    """The activities in the window (kernels, copies, sets) whose launch
    call ran inside a span ``names`` names; None where the window holds
    no such span or no device activity at all."""
    if not union(trace, names) or not trace.in_window():
        return None
    return trace.attributed(matcher(names))
