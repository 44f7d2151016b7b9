"""What the per-layer metrics' readers share: each metric's own file under
``benchmark/metrics/`` names its spans and calls one of these on the run's
:class:`benchmark.harness.runner.LayerContext`. Each returns None where the
run gave it nothing to read."""

from __future__ import annotations

from benchmark import work


def device_idle_pct(ctx):
    """Share of the traced window in which the device ran no kernel, copy or
    set (the profiler's device events, merged, inside the window)."""
    if not ctx.busy_s or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu_pct(ctx):
    """The window's model FLOPs (``benchmark/work.py``, from the shapes of the
    requests or steps it finished) over its length at the bf16 peak."""
    if not ctx.window_s or not ctx.flops:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * work.PEAK_BF16)


def kernels_roofline(ctx):
    """The least time the window's work needs (per unit the larger of its
    FLOPs at the bf16 peak and its bytes at the memory bandwidth) over the
    device's busy time."""
    if not ctx.busy_s or not ctx.bound_s:
        return None
    return 100.0 * ctx.bound_s / ctx.busy_s


def span_device_us(ctx, label: str, per: str):
    """Microseconds of device time in span ``label`` per ``per`` counted."""
    span = ctx.span(label)
    if span is None or span.device_s is None or not ctx.counts.get(per):
        return None
    return 1e6 * span.device_s / ctx.counts[per]


def span_host_us(ctx, label: str, per: str):
    """Microseconds of host time in span ``label`` per ``per`` counted."""
    span = ctx.span(label)
    if span is None or not span.calls or not ctx.counts.get(per):
        return None
    return 1e6 * span.host_s / ctx.counts[per]

