"""Spans of the port's own work: where a request or a training step spends
its host time and its stream time.

    from ovmr_tpu_torch.utils import trace

    with trace.span("heads"):
        ...

A span records only while a ``torch.profiler`` session is recording, or
after :func:`enable`. Otherwise :func:`span` reads two flags and returns a
shared no-op context: it allocates nothing, makes no CUDA event and calls
nothing of torch. So a traced run (a profiler over the window, or
``OVMR_PROFILE_DIR`` in the trainer) gets the spans with no switch of its
own, and an untraced run pays two attribute reads a span.

While it records, a span

- keeps its name, its parent (the span open around it on the same thread)
  and its request id: a span opened with no parent is a root and takes a
  fresh id (``generate``, ``generate_from_features``, a training ``step``),
  and every span under it carries that id;
- stamps its start and end with ``time.time_ns()``, the host clock on which
  the profiler's events are stamped, so its records line up with the trace;
- opens a profiler range ``span:ovmr.<name>``, so the trace names it: the
  profiler's fast record function where this torch has it (a tenth of
  ``torch.profiler.record_function``'s host cost under a profiler), that
  one otherwise;
- on CUDA, records a pair of events on the current stream; their distance,
  the span's stream time, holds what the device ran between the two
  enqueues and any wait of the device for the host inside the span. The
  pairs are resolved when they have completed (at a root's end, without
  waiting) or by :func:`summary`, and then reused.

``host_only=True`` is for spans inside per-name loops (the tokenizer's two
stages): host time alone, with no annotation and no event.

``wait=True`` marks a span in which the host blocks on the device (a
synchronising call, a copy to the host); :func:`summary` sums the host time
of the outermost such spans.

The recorder keeps per name the calls, host seconds, stream seconds and
their self parts (less the direct children's), and the span trees of the
last :data:`TREE_CAP` roots, each of at most :data:`TREE_SPANS_CAP` spans. It
never holds more than :data:`PENDING_CAP` unresolved event pairs: past that
it waits for the oldest. Left on, it stays bounded.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "span:ovmr."
TREE_CAP = 64
TREE_SPANS_CAP = 4096
PENDING_CAP = 8192

_forced = False
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


def enable() -> None:
    """Record spans whether or not a profiler is recording."""
    global _forced
    _forced = True


def disable() -> None:
    """Record spans only while a profiler is recording (the default)."""
    global _forced
    _forced = False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str, wait: bool = False, host_only: bool = False):
    """A context that records span ``name`` while a profiler records or
    after :func:`enable`, and a shared no-op otherwise."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, wait, host_only)


class _Total:
    __slots__ = ("calls", "host_ns", "self_host_ns", "stream_ms", "self_stream_ms", "events",
                 "wait")

    def __init__(self, wait: bool):
        self.calls = self.host_ns = self.self_host_ns = self.events = 0
        self.stream_ms = self.self_stream_ms = 0.0
        self.wait = wait


class _Span:
    __slots__ = ("name", "wait", "host_only", "parent", "rid", "tree", "index", "start_ns",
                 "end_ns", "child_ns", "in_wait", "rf", "events", "device", "stream_ms", "light")

    def __init__(self, name: str, wait: bool, host_only: bool):
        self.name = name
        self.wait = wait
        self.host_only = host_only

    def __enter__(self):
        _REC.open(self)
        return self

    def __exit__(self, *exc):
        _REC.close(self)
        return False


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.reset()

    def reset(self):
        with self.lock:
            self.totals = {}
            self.trees = collections.deque(maxlen=TREE_CAP)
            self.pending = collections.deque()
            self.spare = {}  # resolved event pairs by device, for reuse
            self.roots = 0
            self.wait_ns = 0

    def _stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def _total(self, s: _Span) -> _Total:
        total = self.totals.get(s.name)
        if total is None:
            total = self.totals[s.name] = _Total(s.wait)
        return total

    def open(self, s: _Span):
        stack = self._stack()
        parent = stack[-1] if stack else None
        s.parent = parent
        s.child_ns = 0
        s.in_wait = s.wait or (parent is not None and parent.in_wait)
        s.index = s.rf = s.events = s.stream_ms = s.end_ns = None
        s.light = None if s.host_only else {}
        if parent is None:
            s.rid = next(self.ids)
            s.tree = {"id": s.rid, "spans": []}
            with self.lock:
                self.trees.append(s.tree)
                self.roots += 1
        else:
            s.rid, s.tree = parent.rid, parent.tree
        if not s.host_only:
            if len(s.tree["spans"]) < TREE_SPANS_CAP:
                s.index = len(s.tree["spans"])
                s.tree["spans"].append(s)
            s.rf = _range(PREFIX + s.name)
            s.rf.__enter__()
        s.start_ns = time.time_ns()
        if s.rf is not None and torch.cuda.is_initialized():
            s.device = torch.cuda.current_device()
            with self.lock:
                spare = self.spare.get(s.device)
                pair = spare.pop() if spare else None
            if pair is None:
                pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
            s.events = pair
        stack.append(s)

    def close(self, s: _Span):
        if s.events is not None:
            s.events[1].record()
        s.end_ns = time.time_ns()
        if s.rf is not None:
            s.rf.__exit__(None, None, None)
            s.rf = None
        stack = self._stack()
        if s in stack:
            stack.remove(s)
        dur = s.end_ns - s.start_ns
        parent = s.parent
        with self.lock:
            total = self._total(s)
            total.calls += 1
            total.host_ns += dur
            total.self_host_ns += dur - s.child_ns
            if s.wait and not (parent is not None and parent.in_wait):
                self.wait_ns += dur
            if s.events is not None:
                total.events += 1
                self.pending.append(s)
            if parent is None:
                self._resolve(block=False)
                return
            parent.child_ns += dur
            if parent.light is not None and s.host_only:
                calls, ns = parent.light.get(s.name, (0, 0))
                parent.light[s.name] = (calls + 1, ns + dur)
            if len(self.pending) > PENDING_CAP:
                self._resolve(block=True, keep=PENDING_CAP // 2)

    def _resolve(self, block: bool, keep: int = 0):
        """Stream times of the pending spans whose events have completed,
        oldest first; with ``block``, waits until ``keep`` remain."""
        while len(self.pending) > keep:
            s = self.pending[0]
            start, end = s.events
            if block:
                end.synchronize()
            elif not end.query():
                break
            self.pending.popleft()
            s.stream_ms = start.elapsed_time(end)
            s.events = None
            self.spare.setdefault(s.device, []).append((start, end))
            total = self._total(s)
            total.stream_ms += s.stream_ms
            total.self_stream_ms += s.stream_ms
            if s.parent is not None and not s.parent.host_only:
                self._total(s.parent).self_stream_ms -= s.stream_ms

    def summary(self) -> dict:
        with self.lock:
            self._resolve(block=True)
            spans = {}
            for name, t in self.totals.items():
                spans[name] = {
                    "calls": t.calls, "wait": t.wait,
                    "host_s": t.host_ns / 1e9, "self_host_s": t.self_host_ns / 1e9,
                    "stream_s": t.stream_ms / 1e3 if t.events else None,
                    "self_stream_s": t.self_stream_ms / 1e3 if t.events else None,
                }
            trees = [{"id": tree["id"], "spans": [_record(s) for s in tree["spans"]]}
                     for tree in self.trees]
            return {"spans": spans, "roots": self.roots, "wait_host_s": self.wait_ns / 1e9,
                    "requests": trees}


def _record(s: _Span) -> dict:
    return {
        "name": s.name,
        "parent": None if s.parent is None else s.parent.index,
        "request": s.rid,
        "wait": s.wait,
        "start_ns": s.start_ns,
        "end_ns": s.end_ns,
        "stream_s": None if s.stream_ms is None else s.stream_ms / 1e3,
        "host_only": {k: {"calls": c, "host_s": ns / 1e9} for k, (c, ns) in s.light.items()},
    }


_REC = _Recorder()


def reset() -> None:
    """Forget every span recorded so far (events not yet resolved too)."""
    _REC.reset()


def summary() -> dict:
    """What the recorder holds, its CUDA events resolved (waiting for them):

    - ``spans``: per name ``calls``, ``host_s``, ``self_host_s`` (less the
      direct children's host time), ``stream_s`` and ``self_stream_s``
      (None for a name that recorded no events: the CPU, host-only spans)
      and ``wait``;
    - ``roots``: the root spans opened (requests and steps);
    - ``wait_host_s``: host seconds in ``wait`` spans not inside another;
    - ``requests``: the trees of the last :data:`TREE_CAP` roots, each
      ``{"id", "spans": [{"name", "parent" (index in the list, None for the
      root), "request", "wait", "start_ns", "end_ns", "stream_s",
      "host_only": {name: {"calls", "host_s"}}}]}``, in the order the spans
      opened.
    """
    return _REC.summary()
