"""The window's model FLOPs over its length at the card's bf16 peak; in
clip_vit_b16.generate."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
