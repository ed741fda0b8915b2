"""The port's spans and counters.

``span(name, **attrs)`` marks one piece of work at a layer boundary (the
plan's phases, an epoch's host steps and copies, a kernel wrapper's
launch). It records only while recording is on: while a
``torch.profiler`` session records (the profiler's own Python flag), or
inside ``recording()``. Off, it returns one shared no-op context, so
that a span costs the flag check and the call. A recorded span keeps
its name, attrs, start and end in nanoseconds on the profiler's host
clock (unix time, as kineto's host events), its id, its parent's id and
its epoch's id (the id of the root of its tree: the ``step.iterate`` of
an epoch). While a profiler session records, each span also opens the
range ``record_function("mml." + name)``, so that the device trace
carries it.

Counters are always on: ``phase`` is a span that also adds its host
seconds to the counter ``<name>.seconds`` (once per outermost phase of
a name); ``counters()`` returns them. The kernel wrappers count their
own launches (their ``.launches`` attributes).

Nothing here synchronises with the device: a span around a copy from
pageable host memory, which waits for the stream, measures that wait.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_spans: list = []
_ids = itertools.count(1)
_current = contextvars.ContextVar("mml_trace_span", default=None)
_phases = contextvars.ContextVar("mml_trace_phases", default=())
_counters: dict = {}
_lock = threading.Lock()
_forced = 0
# time_ns() - perf_counter_ns(), taken when recording starts
_offset = None


class _Off:
    """The context of every span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOOP = _Off()


class Span:
    """One recorded span; ``start`` / ``end`` in unix nanoseconds."""

    __slots__ = ("name", "attrs", "start", "end", "id", "parent", "epoch",
                 "_token", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start = self.end = None

    def set(self, **attrs):
        """Adds attrs known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        global _offset
        parent = _current.get()
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.epoch = parent.epoch if parent is not None else self.id
        self._token = _current.set(self)
        if _offset is None:
            _offset = time.time_ns() - time.perf_counter_ns()
        # stamped before the range opens: the range's first opening in a
        # process takes about a millisecond after its own stamp
        self.start = time.perf_counter_ns() + _offset
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function("mml." + self.name)
            self._range.__enter__()
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns() + _offset
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _current.reset(self._token)
        return False


def on() -> bool:
    """Whether spans record now."""
    return bool(_forced or _profiler._is_profiler_enabled)


def span(name: str, **attrs):
    """The context of one span: recorded while recording is on, else the
    shared no-op ``NOOP``. Both take ``set(**attrs)``."""
    if not (_forced or _profiler._is_profiler_enabled):
        return NOOP
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Records spans inside the block, with or without a profiler."""
    global _forced, _offset
    if not _forced:
        _offset = time.time_ns() - time.perf_counter_ns()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


@contextlib.contextmanager
def phase(name: str, **attrs):
    """A span that always counts: its host seconds added to
    ``<name>.seconds``. A phase inside a phase of the same name is
    neither counted nor recorded again (the outermost call counts)."""
    active = _phases.get()
    if name in active:
        yield
        return
    token = _phases.set(active + (name,))
    t0 = time.perf_counter()
    try:
        with span(name, **attrs):
            yield
    finally:
        dt = time.perf_counter() - t0
        _phases.reset(token)
        with _lock:
            _counters[name + ".seconds"] = \
                _counters.get(name + ".seconds", 0.0) + dt


def spans() -> list:
    """The recorded spans, in the order they started."""
    return list(_spans)


def reset():
    """Clears the spans and the counters."""
    global _offset
    with _lock:
        _spans.clear()
        _counters.clear()
    if not on():
        _offset = None


def counters() -> dict:
    """Every counter: ``{"<phase>.seconds": seconds}``."""
    with _lock:
        return dict(_counters)
