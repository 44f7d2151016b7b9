"""One run of one cell: set-up, the measured window, the comparison, and the
result's last line.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` with the per-layer
metrics' spans installed, and the metrics are the per-layer ones.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from benchmark.harness import common, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "ovmr_tpu")


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (by default the
    process's loaded modules), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def make_cell(root, workload: str, seed: int, device, overrides=None) -> common.Cell:
    """The cell's files, with ``overrides`` ({"config": {...}, "traffic":
    {...}, "limits": {...}}) laid over them (the CPU tests' small sizes)."""
    bench = spec.load_benchmark(root)
    w = spec.find_cell(bench, workload)
    parts = {"config": spec.load_config(root, w["config"]),
             "traffic": spec.load_traffic(root, w["traffic"]),
             "limits": spec.load_limits(root, workload)}
    for key, extra in (overrides or {}).items():
        parts[key] = {**parts[key], **extra}
    return common.Cell(root=root, name=workload, seed=int(seed), device=torch.device(device),
                       **parts)


def make_driver(cell: common.Cell, variant=None):
    """The driver that the cell's traffic names, set up; ``variant`` puts a
    control or a fault in the program's place (``benchmark/readings.py``)."""
    return spec.load_driver(cell.root, cell.traffic["driver"])(cell, variant)


def end_to_end(root, name: str, w: common.Window, setup_s: float) -> float:
    """End-to-end metric ``name``, as its file under ``end_to_end/`` says."""
    m = spec.load_end_to_end(root, name)
    if m["reads"] == "setup_s":
        return setup_s
    if m["reads"] == "rate":
        return w.counts.get(m["count"], 0) / w.seconds
    return w.latency_ms(m["quantile"])


class LayerContext:
    """What a per-layer metric's reader reads."""

    def __init__(self, window: common.Window, busy_s, window_s, spans: trace.Spans):
        self.window = window
        self.counts = window.counts
        self.flops = window.work.flops
        self.bound_s = window.work.bound_s
        self.busy_s = busy_s
        self.window_s = window_s
        self._spans = spans

    def span(self, label):
        return self._spans.spans.get(label) if self._spans else None


def run(root, workload: str, seed: int, seconds: float, traced: bool, device="cuda",
        overrides=None, t_process=None, out=sys.stdout, err=sys.stderr) -> dict:
    """Runs the cell and prints its result; returns the result (None for a
    cell that could not run)."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = spec.load_benchmark(root)
    cell = make_cell(root, workload, seed, device, overrides)
    cuda = cell.device.type == "cuda"
    if cuda:
        from ovmr_tpu_torch.ops import cuda_lib

        cuda_lib.build_all()
    driver = make_driver(cell)
    driver.warm()
    per_layer = spec.cell_metrics(bench, workload, "per_layer") if traced else []
    readers = {m["name"]: spec.load_metric(root, m["name"]) for m in per_layer}
    spans = trace.Spans(cuda)
    for reader in readers.values():
        for label, target in getattr(reader, "SPANS", {}).items():
            if label not in spans.spans:
                spans.install(label, target)
    setup = {}

    def on_start():
        setup["s"] = time.perf_counter() - t_process
        spans.active = traced

    prof = None
    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    with torch.profiler.record_function("window"):
        window = driver.window(seconds, on_start)
    spans.active = False
    busy_s = window_s = breakdown = None
    if prof is not None:
        common.sync(cell.device)
        prof.stop()
        busy_s, window_s, breakdown = trace.read_profile(prof)
        spans.finish()
    spans.restore()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.free()
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"benchmark: the run loaded {', '.join(forbidden)}", file=err)
        return None
    limits = cell.limits
    t_check = time.perf_counter()
    numbers, info = driver.check(limits)
    info["check_s"] = time.perf_counter() - t_check
    checks = {k: [numbers[k], float(v)] for k, v in limits["compared"].items()}
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    if traced:
        ctx = LayerContext(window, busy_s, window_s if window_s else window.seconds, spans)
        for m in per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec.cell_metrics(bench, workload, "end_to_end"):
            value = end_to_end(root, m["name"], window, setup["s"])
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if traced:
        dev["busy_s"] = busy_s
        dev["window_s"] = window_s
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps({"info": info, "counts": window.counts, "window_s": window.seconds}),
          file=err)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result
