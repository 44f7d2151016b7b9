"""Device time of the step's augmentation per training image; in
clip_vit_b16.train."""

from benchmark.harness import readers

SPANS = {"augment": "ovmr_tpu_torch.engine.train_step:augment_images"}


def read(ctx):
    return readers.span_device_us(ctx, "augment", "images")
