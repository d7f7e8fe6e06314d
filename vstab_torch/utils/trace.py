"""Spans of the program's stages: where a clip's, a blocked call's and a
training step's time goes.

    with trace.span("vstab.flow", device=frames.is_cuda):
        ...

Recording is on while `torch.profiler` records and inside `recording()`.
Off, `span` costs one check and returns one shared object that does nothing;
given `into`, a dict, it still reads the host clock twice and adds its self
seconds (its time less that of the spans nested in it that fill the same
dict) to `into[<the name's last part>]`, so the dict's values never count
time twice. On, a span also records its name, host start and end, its id,
its parent's and its root's (the outermost span open on its thread: one
clip, blocked call or training step) and its attributes; under the profiler
it is a `record_function` range too, and with `device=True` it records CUDA
timing events on the current stream, resolved when the records are read.
`records()` and the profiler's trace are the only exports. Every name starts
with `vstab.`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 100_000


class _Buffer:
    """The process's finished spans, and the state every thread shares."""

    def __init__(self):
        self.records: List[dict] = []
        self.dropped = 0
        self.recording = 0  # depth of open `recording()` blocks
        self.ids = itertools.count(1)


class _Thread(threading.local):
    def __init__(self):
        self.stack: List["_Span"] = []  # the thread's open spans


_BUF, _THREAD = _Buffer(), _Thread()


class _Off:
    """What `span` returns while nothing records and no `into` is given."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "into", "attrs", "device", "record", "rf", "events", "t0", "nested",
                 "id", "parent", "root")

    def __init__(self, name: str, device: bool, into: Optional[Dict[str, float]],
                 attrs: Optional[dict], record: bool):
        self.name, self.into, self.attrs = name, into, attrs
        self.device, self.record = device, record
        self.rf = self.events = None
        self.nested = 0

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (kept when it records)."""
        if self.record:
            self.attrs.update(attrs)

    def __enter__(self):
        stack = _THREAD.stack
        if self.record:
            self.id = next(_BUF.ids)
            up = next((s for s in reversed(stack) if s.record), None)
            self.parent = None if up is None else up.id
            self.root = self.id if up is None else up.root
            if _profiler._is_profiler_enabled:
                self.rf = _profiler.record_function(self.name)
                self.rf.__enter__()
            if self.device:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = _THREAD.stack
        stack.pop()
        dur = t1 - self.t0
        if self.into is not None:
            key = self.name.rpartition(".")[2]
            self.into[key] = self.into.get(key, 0.0) + (dur - self.nested) / 1e9
            up = next((s for s in reversed(stack) if s.into is self.into), None)
            if up is not None:
                up.nested += dur
        if self.record:
            if self.events is not None:
                self.events[1].record()
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            rec = {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                   "start_ns": self.t0, "end_ns": t1, "host_ms": dur / 1e6, "device_ms": None,
                   "attrs": self.attrs, "_events": self.events}
            if len(_BUF.records) < MAX_RECORDS:
                _BUF.records.append(rec)
            else:
                _BUF.dropped += 1
        return False


def span(name: str, device: bool = False, into: Optional[Dict[str, float]] = None, **attrs):
    """A context manager around one stage; see the module's docstring.
    `device` asks for CUDA timing events (pass whether the stage's tensors
    are on the card); `attrs` are kept with the record, and `.set(**attrs)`
    on the entered span adds more."""
    if not (_BUF.recording or _profiler._is_profiler_enabled):
        return _OFF if into is None else _Span(name, False, into, None, False)
    return _Span(name, bool(device), into, attrs, True)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block, with or without the profiler."""
    _BUF.recording += 1
    try:
        yield
    finally:
        _BUF.recording -= 1


def records() -> List[dict]:
    """The finished spans: name, id, parent, root, start_ns, end_ns, host_ms,
    device_ms (the stream's ms between the span's events, else None), attrs.
    Resolving device_ms waits for the span's last event."""
    out = []
    for rec in list(_BUF.records):
        events = rec.pop("_events", None)
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
        out.append(dict(rec, attrs=dict(rec["attrs"])))
    return out


def clear() -> None:
    """Empty the buffer and its count of dropped spans."""
    _BUF.records.clear()
    _BUF.dropped = 0


def dropped() -> int:
    """Spans not kept since the last `clear()` because the buffer was full."""
    return _BUF.dropped


__all__ = ["MAX_RECORDS", "clear", "dropped", "records", "recording", "span"]
