"""Device time of the preference fusion per class; in
clip_vit_l14_336.generate."""

from benchmark.harness import readers

SPANS = {"fusion": "ovmr_tpu_torch.models.ovmr:fusion_from_classifiers"}


def read(ctx):
    return readers.span_device_us(ctx, "fusion", "classes")
