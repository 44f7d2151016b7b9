"""Image normalisation on the device.

The port's copy of ``normalize_u8`` (``ovmr_tpu/ops/preprocess.py:27-38``):
uint8 HWC batches, already resized and cropped on the host, go to the device
four times smaller than fp32 and are scaled and normalised there.
"""

from __future__ import annotations

from typing import Sequence

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_u8(
    images_u8: torch.Tensor,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised NHWC in ``out_dtype``, computed in
    fp32 as ToTensor + Normalize on the host would."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(out_dtype)
