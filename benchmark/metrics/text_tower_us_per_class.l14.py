"""Stream time of the text tower (the program's ``text_tower`` span) per
class; in clip_vit_l14_336.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.stream_us(ctx, "text_tower", "classes")
