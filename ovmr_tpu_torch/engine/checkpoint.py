"""Classifier artifact export (``mm_classifiers.pt`` / ``visual_tokens.pt``)
and reference-format generator checkpoints (``model.pth.tar-N``).

Counterpart of ``ovmr_tpu/engine/checkpoint.py`` ``export_classifiers_torch``
(the reference's key names and fp32 dtype, ``mm_…:276-291``),
``aggregator_to_torch_state_dict`` :268 and ``save_torch_checkpoint`` :302.
The save/resume cycle with optimizer state comes with the trainer class.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ovmr_tpu_torch.models.import_torch import TORCH_BLOCK_KEYS


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


def aggregator_to_torch_state_dict(agg_params: dict) -> dict:
    """Inverse of ``import_torch.prompt_learner_params_from_state_dict``:
    aggregator params -> the reference prompt_learner state_dict
    (``aggregator.resblocks.{i}.*`` + ``cls_token``, fp32, linear weights
    ``[out, in]``), so a generator trained here loads in the reference."""
    blocks = agg_params["blocks"]
    sd = {"cls_token": _fp32_cpu(agg_params["cls_token"])}
    for i in range(blocks["w_qkv"].shape[0]):
        for key, torch_key, transpose in TORCH_BLOCK_KEYS:
            value = _fp32_cpu(blocks[key][i])
            sd[f"aggregator.resblocks.{i}.{torch_key}"] = (
                value.t().contiguous() if transpose else value
            )
    return sd


def save_torch_checkpoint(
    directory: str, name: str, epoch: int, agg_params: dict, model_name: str = ""
) -> str:
    """Reference-format ``{directory}/{name}/model.pth.tar-{epoch}`` (or
    ``{model_name}.pth.tar`` for best-val saves); returns the path."""
    subdir = osp.join(directory, name)
    os.makedirs(subdir, exist_ok=True)
    fname = f"{model_name}.pth.tar" if model_name else f"model.pth.tar-{epoch}"
    path = osp.join(subdir, fname)
    torch.save(
        {"state_dict": aggregator_to_torch_state_dict(agg_params), "epoch": epoch}, path
    )
    return path
