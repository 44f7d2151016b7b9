"""Stream time of the step's part without gradients (the vision tower over
the query and exemplar images, the prompt embeddings: the program's
``frozen`` span) per training image; in clip_vit_b16.train."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.stream_us(ctx, "frozen", "images")
