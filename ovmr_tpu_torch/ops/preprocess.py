"""Image preprocessing on the device.

The port's copy of ``ovmr_tpu/ops/preprocess.py``: uint8 HWC batches go to
the device four times smaller than fp32. ``normalize_u8`` (:27-38) scales
and normalises batches already resized and cropped on the host;
``preprocess_batch`` (:42-75) also resizes and centre-crops them there.
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


_RESIZE_MODES = {"bicubic": "bicubic", "cubic": "bicubic", "bilinear": "bilinear",
                 "linear": "bilinear"}


def preprocess_batch(
    images_u8: torch.Tensor,
    size: int = 224,
    method: str = "bicubic",
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised [B, 3, size, size] in ``out_dtype``
    (``preprocess_batch`` :42-75): the smaller edge resized to ``size``
    (aspect kept, one resize to the scaled shape), then a centre crop, the
    geometry of the test transform.

    ``jax.image.resize`` antialiases on a downscale and its cubic kernel is
    Keys' a = -0.5; ``F.interpolate`` with ``antialias=True`` computes the
    same kernels (its default a = -0.75 holds only without antialias). The
    crop offsets round half to even, as the JAX function's ``round`` does."""
    import torch.nn.functional as F

    if method not in _RESIZE_MODES:
        raise ValueError(f"method {method!r}: expected one of {sorted(_RESIZE_MODES)}")
    b, h, w, c = images_u8.shape
    # a true division on every device (a CUDA tensor over a Python scalar
    # multiplies by the reciprocal)
    x = images_u8.float() / torch.full((1,), 255.0, device=images_u8.device)
    x = x.permute(0, 3, 1, 2)
    if h <= w:
        nh, nw = size, max(int(round(w * size / h)), size)
    else:
        nh, nw = max(int(round(h * size / w)), size), size
    x = F.interpolate(x, size=(nh, nw), mode=_RESIZE_MODES[method], align_corners=False,
                      antialias=True)
    top = int(round((nh - size) / 2.0))
    left = int(round((nw - size) / 2.0))
    x = x[:, :, top:top + size, left:left + size]
    dev = x.device
    m = torch.tensor(mean, dtype=torch.float32, device=dev).reshape(1, 3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=dev).reshape(1, 3, 1, 1)
    return ((x - m) / s).to(out_dtype)
