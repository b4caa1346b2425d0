"""Spans: named stretches of the port's work, recorded while a torch
profiler session is recording, and nothing otherwise.

    with span("predict_volume", request=n, slices=D, padded=pad):
        with span("predict_volume.pad"):
            ...
    records()   # [{"name", "id", "parent", "request", "start_ns",
                #   "end_ns", "counts"}, ...]

Off (no profiler recording): :func:`span` reads
``torch.autograd.profiler._is_profiler_enabled`` once and returns a shared
no-op context manager. No ``record_function`` is opened; there is no flag
or environment variable of its own.

On (a ``torch.profiler`` session recording): each span opens
``torch.profiler.record_function(name)``, so the profiler's timeline
carries it on its own clock, and appends a record:

- ``name``; ``id`` (unique in the process); ``parent``, the id of the
  enclosing span (None for an outermost span);
- ``request``: the id of the outermost span's request (a volume, a step),
  given by that span's ``request`` argument (its own id without one) and
  inherited by every span inside it;
- ``start_ns`` / ``end_ns``: ``time.time_ns()`` at enter and exit, the host
  clock the profiler's events are taken on;
- ``counts``: the keyword counts the span was opened with.

The device time of the work a span launches is the profiler's to give:
its kernels run on the device's clock, after the host has left the span.

**Records cover the newest profiled window.** The recorder starts afresh
on the first span it sees on after having seen one off. Profile a stretch
of serving or training with ``torch.profiler`` (the work before it runs
unprofiled), then read :func:`records` beside the profiler's timeline: they
are that window's spans and no others.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


class _Recorder:
    """The spans of the newest profiled window, and the open ones."""

    def __init__(self):
        self.records: List[Dict] = []
        self.open: List[Dict] = []
        self.ids = itertools.count()
        self.seen_off = True

    def restart(self) -> None:
        self.records = []
        self.seen_off = False


_recorder = _Recorder()


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name: str, request: Optional[int], counts: Dict):
        r = _recorder
        if r.seen_off:
            r.restart()
        parent = r.open[-1] if r.open else None
        sid = next(r.ids)
        if request is None:
            request = parent["request"] if parent else sid
        self.rec = {"name": name, "id": sid,
                    "parent": parent["id"] if parent else None,
                    "request": request, "start_ns": None, "end_ns": None,
                    "counts": counts}
        self.range = _profiler.record_function(name)

    def __enter__(self):
        r, rec = _recorder, self.rec
        rec["start_ns"] = time.time_ns()
        self.range.__enter__()
        r.open.append(rec)
        r.records.append(rec)
        return rec

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.rec["end_ns"] = time.time_ns()
        _recorder.open.pop()
        return False


def span(name: str, request: Optional[int] = None, **counts):
    """A context manager around one stretch of work named ``name``:
    recorded with ``request`` and ``counts`` while a profiler records, a
    shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        _recorder.seen_off = True
        return _OFF
    return _Span(name, request, counts)


def records() -> List[Dict]:
    """The newest profiled window's spans in the order they opened (see
    the module's docstring)."""
    return list(_recorder.records)
