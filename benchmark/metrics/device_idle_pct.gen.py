"""Share of the traced window in which the device idled; in
clip_vit_b16.generate."""

from benchmark.harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
