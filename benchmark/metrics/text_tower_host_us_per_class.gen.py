"""Host time of the text tower (the enqueue of its three passes a chunk: the
program's ``text_tower`` span) per class; in clip_vit_b16.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.host_us(ctx, "text_tower", "classes")
