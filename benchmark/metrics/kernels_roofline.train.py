"""The least time the window's work needs over the device's busy time; in
clip_vit_b16.train."""

from benchmark.harness import readers


def read(ctx):
    return readers.kernels_roofline(ctx)
