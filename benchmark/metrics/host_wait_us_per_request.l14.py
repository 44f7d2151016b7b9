"""Host time blocked on the device inside the program's ``wait`` spans per
request; in clip_vit_l14_336.generate."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.wait_us(ctx, "requests")
