"""Host time blocked on the device inside the program's ``wait`` spans (the
fusion's counts, the result's copy) per request; in clip_vit_b16.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.wait_us(ctx, "requests")
