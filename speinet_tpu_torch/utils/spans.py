"""The program's spans: named stretches of its work, kept while a
torch.profiler session records.

    with span("engine.restore", n=len(windows)):
        ...

The switch is torch's own flag, `torch.autograd.profiler.
_is_profiler_enabled`, which torch sets when a profiler session starts and
clears when it stops, whatever the session records. Off, a span costs that
flag read and a shared null context, and nothing is kept. On, a span opens
`torch.profiler.record_function(name)`, so the session's trace shows the
program's stages beside its operators and kernels, and keeps its name, its
entry and exit on `time.perf_counter()`, whether it ran on the main thread,
and `n`, the frames, windows or batches it handled. A span is kept only if
the switch was on at both its ends: one that straddles a session's start or
stop is dropped.

With `device=True` a span also records a pair of timing CUDA events on the
current stream (where CUDA has been initialised). Its device time is the
stream's time between the two events, the stream's idle time between them
included. Events are resolved in `recorded()`, with one synchronize.

`recorded()` returns the kept spans, `reset()` clears them and
`as_host_spans()` gives them as (name, start, end, on the main thread)
tuples. Every name, where it is recorded and what reads it is listed in
PERF.md's table of spans.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_KEPT: list = []        # (name, start, end, main thread, n, events or device ms)


class Span(NamedTuple):
    name: str
    start: float        # time.perf_counter() at entry, s
    end: float          # ... at exit
    main_thread: bool
    n: int
    device_ms: Optional[float]   # the stream's time between the span's ends


def span(name: str, n: int = 1, device: bool = False):
    """A context manager that keeps the span while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, n, device)


class _Open:
    __slots__ = ("name", "n", "events", "annotation", "t0")

    def __init__(self, name: str, n: int, device: bool):
        self.name, self.n = name, n
        self.events = None
        if device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        self.annotation.__exit__(*exc)
        if _profiler._is_profiler_enabled:
            kept = (self.name, self.t0, t1,
                    threading.current_thread() is threading.main_thread(),
                    self.n, self.events)
            with _LOCK:
                _KEPT.append(kept)
        return False


def recorded() -> List[Span]:
    """The kept spans in the order they ended, each with its device ms
    where it recorded events (None elsewhere)."""
    with _LOCK:
        if any(isinstance(k[5], tuple) for k in _KEPT):
            torch.cuda.synchronize()
            for i, k in enumerate(_KEPT):
                if isinstance(k[5], tuple):
                    _KEPT[i] = k[:5] + (k[5][0].elapsed_time(k[5][1]),)
        return [Span(*k) for k in _KEPT]


def reset() -> None:
    """Forget every kept span."""
    with _LOCK:
        _KEPT.clear()


def as_host_spans() -> list:
    """The kept spans as (name, start, end, on the main thread) on the host
    clock: the shape of the spans a trace reduction labels idle gaps by."""
    with _LOCK:
        return [k[:4] for k in _KEPT]
