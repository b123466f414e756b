"""The profiler's trace of a traced slice, reduced to what readers need.

Reads the raw events of one ``torch.profiler`` session (CPU and CUDA
activities): the device's operations (kernels, copies, sets), the
device-side ranges of the benchmark's ``pb.*`` spans (from the first to
the last operation launched inside the span) and the host's events on
the thread that ran the spans.  A span's device time is the time of the
operations inside its range (one stream: nothing else runs there).
``busy_s`` is the union of the operations' intervals; an idle gap is
named by what the host was doing when it began: the innermost ``pb``
span and the innermost host event around that instant (``python``
where none of the 64 host events that began last still runs).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import numpy as np

TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    spans: dict[str, list[tuple[float, float]]]   # name -> (range s, device s)
    device_ops: list[list]
    idle_gaps: list[list]

    def durations(self, name: str) -> list[float]:
        return [r for r, _ in self.spans.get(name, [])]

    def device_s(self, name: str) -> float:
        return sum(dev for _, dev in self.spans.get(name, []))


def _events(prof):
    from torch.autograd import DeviceType

    ops, ranges, host, tagged = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("pb."):
                ranges.append((t0, t1, name))
            elif not e.is_user_annotation():
                ops.append((t0, t1, name))
        elif e.device_type() == DeviceType.CPU:
            if name.startswith("pb."):
                tagged.append((t0, t1, name, e.start_thread_id()))
            elif not e.is_user_annotation():
                host.append((t0, t1, name, e.start_thread_id()))
    return ops, ranges, host, tagged


def _innermost(items, starts, t, look: int):
    """The latest-starting of ``items`` (sorted by start) that holds t,
    among the ``look`` that start last before it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if items[j][1] > t:
            return items[j][2]
    return None


def read(prof, window_s: float) -> Trace:
    ops, ranges, host, tagged = _events(prof)
    ops.sort()
    starts = np.array([o[0] for o in ops], dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum([o[1] - o[0] for o in ops])])

    spans: dict[str, list] = collections.defaultdict(list)
    for t0, t1, name in ranges:
        a = np.searchsorted(starts, t0, "left")
        b = np.searchsorted(starts, t1, "left")
        spans[name].append(((t1 - t0) * 1e-9, float(cum[b] - cum[a]) * 1e-9))

    busy = 0
    gaps = []
    end = None
    for t0, t1, _ in ops:
        if end is None or t0 > end:
            if end is not None:
                gaps.append((t0 - end, end))
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1

    thread = collections.Counter(t[3] for t in tagged).most_common(1)
    thread = thread[0][0] if thread else None
    tags = sorted(t[:3] for t in tagged if t[3] == thread)
    hosts = sorted(h[:3] for h in host if h[3] == thread)
    tag_starts = [t[0] for t in tags]
    host_starts = [h[0] for h in hosts]
    idle: dict[str, float] = collections.Counter()
    for length, at in gaps:
        label = (f"{_innermost(tags, tag_starts, at, 256) or 'no span'} > "
                 f"{_innermost(hosts, host_starts, at, 64) or 'python'}")
        idle[label] += length * 1e-9

    by_op: dict[str, float] = collections.Counter()
    for t0, t1, name in ops:
        by_op[name[:NAME_CHARS]] += (t1 - t0) * 1e-9
    return Trace(window_s=window_s, busy_s=busy * 1e-9, spans=dict(spans),
                 device_ops=[[n, s] for n, s in by_op.most_common(TOP)],
                 idle_gaps=[[n, s] for n, s in idle.most_common(TOP)])
