"""Host time of prompt building (tokenising ``"a {name}."``) per class; in
clip_vit_l14_336.generate."""

from benchmark.harness import readers

SPANS = {"prompt": "ovmr_tpu_torch.models.ovmr:build_prompt_tokens"}


def read(ctx):
    return readers.span_host_us(ctx, "prompt", "classes")
