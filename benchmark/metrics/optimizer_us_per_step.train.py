"""Stream time of the optimizer (``zero_grad`` and the Adam update: the
program's ``optimizer`` spans) per step; in clip_vit_b16.train."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.stream_us(ctx, "optimizer", "steps")
