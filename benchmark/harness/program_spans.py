"""The program's own spans (``ovmr_tpu_torch.utils.trace``), read for the
per-layer metrics: the recorder's summary over the window's counts. The
recorder records while a profiler does, and a run of ``benchmark/run.py``
profiles only its traced window, in a process of its own; so the summary is
the window's. A program without the recorder, or a span the window never
opened, reads None."""

from __future__ import annotations

import importlib


def summary():
    """The recorder's summary, or None where the program has no recorder."""
    try:
        trace = importlib.import_module("ovmr_tpu_torch.utils.trace")
    except ImportError:
        return None
    return trace.summary()


def _span(name: str):
    s = summary()
    return None if s is None else s["spans"].get(name)


def stream_us(ctx, name: str, per: str):
    """Microseconds of stream time in span ``name`` per ``per`` counted:
    None off CUDA, where the spans record no events."""
    span = _span(name)
    if span is None or span["stream_s"] is None or not ctx.counts.get(per):
        return None
    return 1e6 * span["stream_s"] / ctx.counts[per]


def host_us(ctx, name: str, per: str):
    """Microseconds of host time in span ``name`` per ``per`` counted."""
    span = _span(name)
    if span is None or not span["calls"] or not ctx.counts.get(per):
        return None
    return 1e6 * span["host_s"] / ctx.counts[per]


def wait_us(ctx, per: str):
    """Microseconds of host time blocked in the program's ``wait`` spans
    (the outermost of each nest) per ``per`` counted."""
    s = summary()
    if s is None or not ctx.counts.get(per):
        return None
    if not any(span["wait"] and span["calls"] for span in s["spans"].values()):
        return None
    return 1e6 * s["wait_host_s"] / ctx.counts[per]
