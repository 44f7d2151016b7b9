"""Device time of the classifier heads (prompt embeddings, the splice, the
generator, the text tower's three passes) per class; in
clip_vit_b16.generate."""

from benchmark.harness import readers

SPANS = {"heads": "ovmr_tpu_torch.models.ovmr:generate_classifiers_chunked"}


def read(ctx):
    return readers.span_device_us(ctx, "heads", "classes")
