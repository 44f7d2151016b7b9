"""Host time of the tokenizer's pre-tokenising and BPE merging (the
program's ``prompt.bpe`` span) per class; in clip_vit_b16.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.host_us(ctx, "prompt.bpe", "classes")
