"""Stream time of the step's backward (through the text tower, K3/K4, into
the generator: the program's ``backward`` span) per training image; in
clip_vit_b16.train."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.stream_us(ctx, "backward", "images")
