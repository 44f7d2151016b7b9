"""Classifier artifact export (``mm_classifiers.pt`` / ``visual_tokens.pt``).

Counterpart of ``ovmr_tpu/engine/checkpoint.py`` ``export_classifiers_torch``:
the reference's key names and fp32 dtype (``mm_…:276-291``).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch


def _fp32_cpu(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous()
    return torch.tensor(np.asarray(value, np.float32))


def export_classifiers_torch(classifiers: dict, output_dir: str) -> None:
    """Write ``mm_classifiers.pt`` + ``visual_tokens.pt``. ``text_classifier``
    and ``fusion_weight`` may be absent (the >=5000-class guard); a missing
    mm/vision classifier or visual_tokens raises before anything is written."""
    for key in ("mm_classifier", "vision_classifier", "visual_tokens"):
        if classifiers.get(key) is None:
            raise KeyError(f"export_classifiers_torch: required key {key!r} missing")
    os.makedirs(output_dir, exist_ok=True)
    artifact = {
        key: _fp32_cpu(classifiers[key])
        for key in ("text_classifier", "vision_classifier", "mm_classifier", "fusion_weight")
        if classifiers.get(key) is not None
    }
    torch.save(artifact, osp.join(output_dir, "mm_classifiers.pt"))
    torch.save(
        {"visual_tokens": _fp32_cpu(classifiers["visual_tokens"])},
        osp.join(output_dir, "visual_tokens.pt"),
    )
