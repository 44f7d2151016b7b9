"""Host time of the tokenizer's text cleaning (the program's ``prompt.clean``
span, every name and the visual template) per class; in
clip_vit_b16.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.host_us(ctx, "prompt.clean", "classes")
