"""Spans around the program's layers, and what the device trace says.

Spans are the benchmark's own: in a traced run :class:`Spans` replaces each
named function of the program (``"module:attribute"``, as the per-layer
metrics' files give them) by a wrapper that records a CUDA event before and
after the call, the host's seconds in it, and a profiler annotation
``span:<label>``. A span's device time is the time between its two events on
the stream (so it holds any gap inside the span in which the device waited
for the host). A function that is not there any more leaves its span empty
and its metric null.

The device's busy time is the union of the intervals of its kernels, copies
and sets in the ``torch.profiler`` trace (annotations projected onto the
device left out) inside the window's annotation.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import time

import torch


class Span:
    def __init__(self):
        self.calls = 0
        self.host_s = 0.0
        self.events = []
        self.device_s = None

    def finish(self):
        if self.events:
            torch.cuda.synchronize()
            self.device_s = sum(a.elapsed_time(b) for a, b in self.events) / 1e3
            self.events = []


class Spans:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans = collections.defaultdict(Span)
        self._restore = []
        self.active = False

    def install(self, label: str, target: str) -> bool:
        module_name, attr = target.split(":")
        try:
            module = importlib.import_module(module_name)
            original = getattr(module, attr)
        except (ImportError, AttributeError):
            return False
        span = self.spans[label]

        def wrapper(*args, **kwargs):
            if not self.active:
                return original(*args, **kwargs)
            with torch.profiler.record_function(f"span:{label}"):
                if self.cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                t = time.perf_counter()
                out = original(*args, **kwargs)
                span.host_s += time.perf_counter() - t
                if self.cuda:
                    b.record()
                    span.events.append((a, b))
                span.calls += 1
            return out

        setattr(module, attr, wrapper)
        self._restore.append((module, attr, original))
        return True

    def finish(self):
        for span in self.spans.values():
            span.finish()

    def restore(self):
        for module, attr, original in reversed(self._restore):
            setattr(module, attr, original)
        self._restore = []


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_profile(prof, window_label: str = "window", top: int = 10):
    """(busy_s, window_s, breakdown) of a finished profile: the device's busy
    seconds inside the ``window_label`` annotation, that annotation's length,
    and the device operations that took most time and the idle gaps summed
    by what the host was doing (the innermost annotation and operation open
    at each gap's middle). busy_s is None when the trace holds no device
    operation."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    windows = [(e.start_ns(), e.end_ns()) for e in events
               if e.device_type() != cuda and e.name() == window_label]
    if not windows:
        return None, None, None
    lo, hi = windows[0]
    dev, host = [], []
    ops = collections.Counter()
    for e in events:
        if e.device_type() == cuda:
            if e.is_user_annotation() or not lo <= e.start_ns() < hi:
                continue
            dev.append((e.start_ns(), min(e.end_ns(), hi)))
            ops[e.name()[:96]] += e.duration_ns() / 1e9
        elif lo <= e.start_ns() < hi and e.name() != window_label:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    window_s = (hi - lo) / 1e9
    if not dev:
        return None, window_s, None
    merged = _merge(dev)
    busy_s = sum(e - s for s, e in merged) / 1e9
    spans = sorted(h for h in host if _is_span(h[2]))
    others = sorted(h for h in host if not _is_span(h[2]))
    gaps = collections.Counter()
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e - s >= SHORT_GAP_NS:
            mid = (s + e) // 2
            gaps[f"{_innermost(spans, mid) or 'harness'} / {_innermost(others, mid) or '-'}"[:96]] \
                += (e - s) / 1e9
        elif e > s:
            gaps["gaps under 5 us"] += (e - s) / 1e9
    breakdown = {
        "device_ops": [[k, v] for k, v in ops.most_common(top)],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(top)],
    }
    return busy_s, window_s, breakdown


SHORT_GAP_NS = 5000


def _is_span(name: str) -> bool:
    return name.startswith("span:") or name in ("request", "step")


def _innermost(intervals, t, scan=400):
    """The name of the latest-starting interval of ``intervals`` (sorted
    (start, end, name)) that is open at ``t``, looking back ``scan`` entries."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    for j in range(i, max(-1, i - scan), -1):
        s, e, name = intervals[j]
        if e >= t:
            return name
    return None
