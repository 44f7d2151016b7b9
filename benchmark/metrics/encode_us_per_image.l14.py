"""Device time of the exemplar encoding per exemplar image; in
clip_vit_l14_336.generate."""

from benchmark.harness import readers

SPANS = {"encode": "ovmr_tpu_torch.api:encode_features"}


def read(ctx):
    return readers.span_device_us(ctx, "encode", "images")
