"""A ``torch.profiler`` trace reduced to what the metrics read.

``Trace.from_profiler`` keeps three things of the profiler's events: the
device's activities (kernels, copies, sets) with their intervals, the
host's launch calls by correlation id, and the host's spans (operators
and ``record_function`` ranges) with their thread. A device activity is
attributed to a host span when the call that launched it ran inside that
span (``Trace.attributed``): attribution follows the launch, not the
kernel's name, so a kernel that replaces another under the same span is
read against the same work. Every interval is in the profiler's
nanoseconds.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import (Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

WINDOW = "h100_bench.window"
LABELLED_GAPS = 2000
SCAN = 50000


@dataclasses.dataclass
class Activity:
    name: str
    start: int
    end: int
    corr: int             # the launch call's correlation id
    kernel: bool          # False for a copy or set
    linked: int = 0       # the profiler's linked id, where it gives one


@dataclasses.dataclass
class Span:
    name: str
    start: int
    end: int
    tid: int


@dataclasses.dataclass
class Trace:
    activities: List[Activity]
    launches: Dict[int, Tuple[int, int]]     # correlation -> (start, tid)
    spans: List[Span]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """The trace of a finished ``torch.profiler.profile``."""
        from torch.autograd import DeviceType

        acts, launches, spans = [], {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                low = name.lower()
                acts.append(Activity(name, start, end, e.correlation_id(),
                                     not low.startswith(("memcpy",
                                                         "memset")),
                                     e.linked_correlation_id()))
            elif name.startswith("cu") and not name.startswith("cuda::"):
                launches[e.correlation_id()] = (start, e.start_thread_id())
            else:
                spans.append(Span(name, start, end, e.start_thread_id()))
        return cls(acts, launches, spans)

    def window(self) -> Tuple[int, int]:
        """The measured window's interval: its span's, else the
        activities' extent."""
        for s in self.spans:
            if s.name == WINDOW:
                return s.start, s.end
        if not self.activities:
            return 0, 0
        return (min(a.start for a in self.activities),
                max(a.end for a in self.activities))

    def in_window(self, kernels_only: bool = False) -> List[Activity]:
        lo, hi = self.window()
        return [a for a in self.activities if a.end > lo and a.start < hi
                and (a.kernel or not kernels_only)]

    def attributed(self, span: Union[str, Callable[[str], bool]]
                   ) -> List[Activity]:
        """The activities in the window whose launch call ran inside a span
        called ``span`` (or whose name ``span`` accepts). The span may be
        on any thread: the profiler numbers a ``record_function`` range's
        thread and a launch call's thread apart off the main thread (the
        autograd engine's backward), and in these cells one thread
        launches at a time."""
        match = span if callable(span) else span.__eq__
        spans = sorted((s.start, s.end) for s in self.spans
                       if match(s.name))
        merged: List[Tuple[int, int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        starts = [s for s, _ in merged]
        out = []
        for a in self.in_window():
            launch = self.launch(a)
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and merged[i][1] >= launch[0]:
                out.append(a)
        return out

    def launch(self, a: Activity) -> Optional[Tuple[int, int]]:
        """(start, thread) of the call that launched ``a``: CUPTI gives a
        kernel its launch call's correlation id; the profiler's linked id
        is tried after it."""
        found = self.launches.get(a.corr)
        return found if found is not None else self.launches.get(a.linked)

    def launch_report(self, names) -> Dict[str, Tuple[int, int]]:
        """For each name (a substring of kernel names): (activities in the
        window, those whose launch call the trace holds)."""
        out = {}
        for n in names:
            acts = [a for a in self.in_window() if n in a.name]
            out[n] = (len(acts), sum(self.launch(a) is not None
                                     for a in acts))
        return out


def union_ns(intervals: Iterable[Tuple[int, int]],
             clip: Optional[Tuple[int, int]] = None) -> int:
    """The length of the union of ``intervals``, clipped to ``clip``."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if clip is not None:
            s, e = max(s, clip[0]), min(e, clip[1])
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_ns(trace: Trace) -> int:
    """Nanoseconds of the window in which some activity ran on the
    device (kernels, copies and sets; overlapping ones counted once)."""
    return union_ns(((a.start, a.end) for a in trace.in_window()),
                    clip=trace.window())


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The window's intervals in which nothing ran on the device."""
    lo, hi = trace.window()
    gaps, cur = [], lo
    for s, e in sorted((a.start, a.end) for a in trace.in_window()):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time by what the host was doing (the innermost host span on the
    launching thread that covers the middle of each gap), in seconds."""
    lo, hi = trace.window()
    ops: Dict[str, float] = {}
    for a in trace.in_window():
        ops[a.name] = ops.get(a.name, 0.0) + (min(a.end, hi)
                                              - max(a.start, lo)) / 1e9
    counts: Dict[int, int] = {}
    for ts, tid in trace.launches.values():
        counts[tid] = counts.get(tid, 0) + 1
    main = max(counts, key=counts.get) if counts else None
    host = sorted((s for s in trace.spans if s.tid == main),
                  key=lambda s: s.start)
    starts = [s.start for s in host]
    gaps: Dict[str, float] = {}
    # the longest gaps by name; the many short ones between launches
    # together under one name
    ranked = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])
    for s, e in ranked[:LABELLED_GAPS]:
        mid = (s + e) // 2
        name = "host outside any operator"
        i = bisect.bisect_right(starts, mid)
        # the first span back from the middle that still covers it is the
        # innermost: a nested span starts later than its parent
        for span in reversed(host[max(0, i - SCAN):i]):
            if span.end >= mid:
                name = span.name
                break
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e9
    rest = sum(e - s for s, e in ranked[LABELLED_GAPS:]) / 1e9
    if rest:
        gaps[f"shorter gaps than the {LABELLED_GAPS} longest"] = rest

    def first(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"device_ops": first(ops), "idle_gaps": first(gaps)}
