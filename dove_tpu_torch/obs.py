"""Spans and counters: the one place where the port times and counts its work.

``span(name)`` opens the range ``"dove.<name>"`` in a torch.profiler trace,
on the clock the kernels share, so a trace names each idle stretch of the
device by the innermost span the host was in. Inside a unit of work (a clip
of ``DovePipeline.process_frames``, a ``Trainer.train_step``: :func:`unit`)
the span is also timed on the clock of its work: on the card by a pair of
CUDA events on the current stream, taken from a pool the units share; a
host-only span (``host=True``), and every span on the CPU, by
``time.perf_counter``. A span keeps its name, its parent and its unit in
memory until the unit ends; outside a unit it only opens its range, and on
a thread other than the unit's (autograd's) too. ``count(name, n)`` adds
``n`` to a counter of the unit.

No span waits for the device. A unit resolves its spans once, when it ends,
at a point that already waits for the device (a clip's copy to the host,
the end of a training step): one wait for the last event it recorded, then
each pair's elapsed time. ``Unit.times`` holds the seconds under each span's
name, summed over its repeats, with the unit's scope taken off
("train.encode" -> "encode"), and the counters under theirs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections.abc import Iterator
from typing import Any

import torch
from torch.profiler import record_function


class LaunchCounter:
    """Number of kernel launches: the wrapper adds one per launch, and only
    there, so a run can show that its path went through the kernel. Set
    ``shapes`` to a list to have each launch also append its input's shape."""

    def __init__(self) -> None:
        self.count = 0
        self.shapes: list | None = None

    def reset(self) -> None:
        self.count = 0

    def add(self, shape: torch.Size) -> None:
        self.count += 1
        if self.shapes is not None:
            self.shapes.append(tuple(shape))


# free timing events by device index, reused across units
_free_events: dict[int, list[torch.cuda.Event]] = {}
_local = threading.local()


@dataclasses.dataclass
class Span:
    """One timed span: its marks are perf_counter seconds or CUDA events."""

    name: str
    parent: str | None
    start: Any
    end: Any = None


class Unit:
    """The spans and counters of one unit of work on ``device``; ``scope``
    is the prefix taken off their names in :attr:`times`."""

    def __init__(self, device: torch.device | str, scope: str = "") -> None:
        self.device = torch.device(device)
        self.prefix = f"{scope}." if scope else ""
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.times: dict[str, float] = {}  # filled when the unit ends
        self._open: list[Span] = []
        self._last: torch.cuda.Event | None = None
        self._index = None
        if self.device.type == "cuda":
            self._index = (torch.cuda.current_device() if self.device.index is None
                           else self.device.index)

    def key(self, name: str) -> str:
        return name[len(self.prefix):] if name.startswith(self.prefix) else name

    def mark(self, host: bool) -> Any:
        """Now, on the host's clock or (a device span on the card) as an
        event recorded on the current stream."""
        if host or self.device.type != "cuda":
            return time.perf_counter()
        free = _free_events.setdefault(self._index, [])
        event = free.pop() if free else torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._index))
        self._last = event
        return event

    def _events(self) -> Iterator[torch.cuda.Event]:
        for s in self.spans:
            for m in (s.start, s.end):
                if isinstance(m, torch.cuda.Event):
                    yield m

    def resolve(self) -> dict[str, float]:
        """Every span's seconds and every counter -> :attr:`times`; the
        events go back to the pool."""
        if self._last is not None:
            self._last.synchronize()
        times: dict[str, float] = {}
        for s in self.spans:
            if isinstance(s.start, torch.cuda.Event):
                seconds = s.start.elapsed_time(s.end) / 1e3
            else:
                seconds = s.end - s.start
            k = self.key(s.name)
            times[k] = times.get(k, 0.0) + seconds
        times.update(self.counts)
        self.release()
        self.times = times
        return times

    def release(self) -> None:
        """Hand the unit's events back to the pool."""
        for event in self._events():
            _free_events.setdefault(self._index, []).append(event)
        self.spans, self._open, self._last = [], [], None


def _units() -> list[Unit]:
    units = getattr(_local, "units", None)
    if units is None:
        units = _local.units = []
    return units


def current() -> Unit | None:
    """The innermost unit open on this thread, or None."""
    units = _units()
    return units[-1] if units else None


@contextlib.contextmanager
def unit(device: torch.device | str, scope: str = "") -> Iterator[Unit]:
    """A unit of work: the spans and counters opened on this thread until it
    ends, resolved then into ``Unit.times`` (not when it raises)."""
    u = Unit(device, scope)
    units = _units()
    units.append(u)
    try:
        yield u
    except BaseException:
        units.remove(u)
        u.release()
        raise
    units.remove(u)
    u.resolve()


@contextlib.contextmanager
def span(name: str, host: bool = False) -> Iterator[None]:
    """The range ``"dove.<name>"``; inside a unit also a timed span, on the
    host's clock where ``host`` or off the card, else on the device's."""
    with record_function("dove." + name):
        u = current()
        if u is None:
            yield
            return
        s = Span(name, u._open[-1].name if u._open else None, u.mark(host))
        u.spans.append(s)
        u._open.append(s)
        try:
            yield
        finally:
            u._open.pop()
            s.end = u.mark(host)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the unit open on this thread."""
    u = current()
    if u is not None:
        k = u.key(name)
        u.counts[k] = u.counts.get(k, 0) + n
