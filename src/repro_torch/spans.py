"""Spans of the serving path: named, nested intervals kept in memory for one
``serve`` call, and ranges on the profiler's host timeline. Port-only (the
reference has no counterpart).

A span is a record (``Span``): its name, its start and end on the host's
``time.perf_counter_ns`` clock, the index of the span that encloses it (-1
at the top), and a few integer attributes (``rid``: the request's index in
the call's queue, ``slot``, ``layer``, ``step``, token counts). Names are
those of ``serving/engine.py::SERVE_STAGES`` wherever a stage exists, so
spans and retrolint's schedule events share one vocabulary.

Two kinds:

* ``host(name, **attrs)``: the host's wall time of a block;
* ``device(name, **attrs)``: on the card, a pair of timing
  ``torch.cuda.Event``s (from a pool the recorder reuses) around the work
  the block enqueues. Its seconds are the card's, resolved by ``resolve``
  after a sync the caller makes anyway (the serving engine's first-token
  copy): the recorder never waits for the card inside a ``serve`` call. On
  the CPU the work runs as it is enqueued, and a device span is timed as a
  host span.

A ``Spans`` recorder is active inside ``recording(device)``. The serving
engine opens one per ``serve`` call when it is built with ``spans=True``
and returns it as ``ServeMetrics.spans``; model code reaches it through
this module, not through an argument. With no recorder active a span site
records nothing and makes no event.

While a ``torch.profiler`` profile records, every span site, recorder or
not, is also a range of its name on the profiler's host timeline, so an
idle gap of the card is named by the program span open across it. The
range is a host op (``_RecordFunctionFast``), not a ``record_function``
user annotation: the CUDA profiler mirrors a user annotation onto the
device timeline as an event spanning the kernels launched inside it, which
a reader of device events would count as device work.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

_ACTIVE: ContextVar[Optional["Spans"]] = ContextVar("repro_torch_spans",
                                                    default=None)
_OFF = nullcontext()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1                    # index of the enclosing span
    attrs: Dict[str, int] = field(default_factory=dict)
    on_device: bool = False             # timed by the card's events
    device_s: Optional[float] = None    # the card's seconds, once resolved

    @property
    def seconds(self) -> Optional[float]:
        """The card's seconds for a device span on the card (None until
        resolved), else the host's."""
        if self.on_device:
            return self.device_s
        return (self.end_ns - self.start_ns) * 1e-9


class Spans:
    """The spans of one recording, in the order they opened (``records``),
    with sums by name. ``device``: where device spans run (events on a CUDA
    device, host timing elsewhere)."""

    def __init__(self, device=None):
        self.records: List[Span] = []
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self._stack: List[int] = []
        self._pending: List[Tuple[int, Any, Any]] = []   # (index, start, end)
        self._pool: List[Any] = []

    def _event(self):
        return self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)

    def open(self, name: str, attrs: Dict[str, int], on_device: bool):
        i = len(self.records)
        self.records.append(Span(name, time.perf_counter_ns(),
                                 parent=self._stack[-1] if self._stack
                                 else -1, attrs=attrs, on_device=on_device))
        self._stack.append(i)
        if not on_device:
            return i, None
        ev = self._event()
        ev.record()
        return i, ev

    def close(self, i: int, start) -> None:
        if start is not None:
            end = self._event()
            end.record()
            self._pending.append((i, start, end))
        self.records[i].end_ns = time.perf_counter_ns()
        self._stack.pop()

    def resolve(self, wait: bool = False) -> None:
        """The card's seconds of every device span whose end event has
        completed (of all of them with ``wait``); their events go back to
        the pool."""
        left = []
        for i, start, end in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((i, start, end))
                continue
            self.records[i].device_s = start.elapsed_time(end) * 1e-3
            self._pool += (start, end)
        self._pending = left

    # ------------------------------------------------------------- sums
    def totals(self, by: Optional[str] = None) -> Dict[Any, List]:
        """``[count, seconds, self seconds]`` by name, or by ``(name, the
        attribute by)``. A span's self seconds are its seconds less those
        of its children on the same clock (host or card)."""
        inner = [0.0] * len(self.records)
        for s in self.records:
            if s.parent >= 0 and \
                    self.records[s.parent].on_device == s.on_device:
                inner[s.parent] += s.seconds
        out: Dict[Any, List] = {}
        for s, below in zip(self.records, inner):
            key = s.name if by is None else (s.name, s.attrs.get(by))
            row = out.setdefault(key, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += s.seconds
            row[2] += s.seconds - below
        return out

    def count(self, name: str) -> int:
        return sum(s.name == name for s in self.records)

    def seconds(self, name: str) -> float:
        return sum(s.seconds for s in self.records if s.name == name)

    def self_seconds(self, name: str) -> float:
        return self.totals().get(name, [0, 0.0, 0.0])[2]


class _Open:
    """One open span of a recorder (and its profiler range)."""
    __slots__ = ("rec", "name", "attrs", "on_device", "token", "prof")

    def __init__(self, rec: Spans, name: str, attrs: Dict[str, int],
                 on_device: bool):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.on_device = on_device

    def __enter__(self):
        self.prof = _range(self.name)
        self.prof.__enter__()
        self.token = self.rec.open(self.name, self.attrs, self.on_device)

    def __exit__(self, *exc):
        self.rec.close(*self.token)
        self.prof.__exit__(*exc)


def _range(name: str):
    """A range on the profiler's host timeline while a profiler records."""
    if _RANGE is not None and torch.autograd._profiler_enabled():
        return _RANGE(name)
    return _OFF


def host(name: str, **attrs: int):
    """A host span around a ``with`` block."""
    rec = _ACTIVE.get()
    return _range(name) if rec is None else _Open(rec, name, attrs, False)


def device(name: str, **attrs: int):
    """A device span around a ``with`` block (a host span on the CPU)."""
    rec = _ACTIVE.get()
    return _range(name) if rec is None else \
        _Open(rec, name, attrs, rec.cuda)


def resolve() -> None:
    """Resolve the active recorder's completed device spans (call it right
    after a sync)."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.resolve()


@contextmanager
def recording(device=None) -> Iterator[Spans]:
    """A recorder active for the block; at its end every device span is
    resolved."""
    rec = Spans(device)
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)
        rec.resolve(wait=True)
