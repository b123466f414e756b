"""Spans inside the port: named host (and device) intervals, recorded
only while a ``torch.profiler`` session records.

``span(name, device=False)`` is the port's one way to open a span::

    with tracing.span("attn/decode", device=True):
        ...

While no profiler session records, it returns one shared no-op context:
nothing is allocated, entered, recorded or stored, so a span costs one
flag read.  While a session records, the span

* enters a profiler range of its name, so it sits on the profiler's
  timeline beside the device's work.  The range has an operator's
  scope, not ``record_function``'s user scope: the profiler gives each
  kernel the device-side range of the innermost user-scope range open
  at its launch, so a user-scope span would take the kernels, and the
  device time, of the user ranges around it;
* stamps ``time.perf_counter_ns()`` at entry and exit;
* with ``device=True`` (and CUDA initialised), records two timing
  events on the current stream, never a synchronise;
* appends ``(name, parent, t0, t1, events)`` to a bounded store, the
  parent being the innermost span open on the thread when it began.

``records(name)`` reads the store back: each span's host and device
milliseconds, the events resolved by one synchronise at read time.
Names are ``layer/phase`` (``model/decode``, ``train/forward``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 16                  # spans kept; the oldest go first

_OFF = contextlib.nullcontext()
_store: collections.deque = collections.deque(maxlen=CAPACITY)


class _Open(threading.local):
    def __init__(self):
        self.names: list[str] = []  # the thread's open spans, innermost last


_open = _Open()


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    t0_ns: int                      # time.perf_counter_ns() at entry
    t1_ns: int                      # ... and at exit
    host_ms: float
    device_ms: Optional[float]      # None: no events were recorded


class _Span:
    __slots__ = ("name", "parent", "device", "range", "events", "t0")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        names = _open.names
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.t0 = time.perf_counter_ns()
        self.range = _Range(self.name)
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _open.names.pop()
        _store.append((self.name, self.parent, self.t0, t1, self.events))
        return False


def span(name: str, device: bool = False):
    """A context around one layer's call; a no-op unless a profiler
    session records (see the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def records(name: str) -> list[Record]:
    """The stored spans called ``name``, oldest first."""
    found = [r for r in list(_store) if r[0] == name]
    if any(ev is not None for *_, ev in found):
        torch.cuda.synchronize()
    return [Record(n, parent, t0, t1, (t1 - t0) * 1e-6,
                   None if ev is None else ev[0].elapsed_time(ev[1]))
            for n, parent, t0, t1, ev in found]


def clear() -> None:
    _store.clear()
