"""Stream time of the text tower (the frozen pass and the two spliced
passes of every chunk: the program's ``text_tower`` span) per class; in
clip_vit_b16.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.stream_us(ctx, "text_tower", "classes")
