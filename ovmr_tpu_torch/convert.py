"""Carry the JAX package's parameters over to the port.

The JAX package and the port share one parameter layout: the same nested
keys (``visual``/``text``/``blocks``/``w_qkv``, ...), stacked layer axes
and right-multiplied ``[in, out]`` weights. Given the JAX parameters as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``),
these functions check the structure and copy every array into a torch
tensor, so both packages compute the same function on the same weights.
:func:`aggregator_params_to_numpy` is the way back, for comparing trained
parameters. No JAX is imported here; the caller does the ``np.asarray``.

A ModifiedResNet image tower converts too: its stem, its stages (lists
of bottleneck dicts) and its attention pool keep the JAX package's keys.
A tower's blocks may be packed (``w_qkv``/``b_qkv``) or in the split-qkv
layout of tensor parallelism (``w_q``/``w_k``/``w_v`` and their biases,
head-padded or not): the numpy of the JAX package's
``split_clip_qkv(params, m, cfg)`` converts as it is, and equals the port's
own ``split_clip_qkv`` of the converted packed towers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ovmr_tpu_torch.ops.block_fused import BLOCK_KEYS
from ovmr_tpu_torch.ops.block_fused_tp import TP_KEYS

_BLOCK_KEYS = frozenset(BLOCK_KEYS)
_SPLIT_BLOCK_KEYS = frozenset(TP_KEYS)
_VISUAL_KEYS = frozenset(
    ("patch_embed_w", "class_embedding", "positional_embedding", "ln_pre_scale",
     "ln_pre_bias", "blocks", "ln_post_scale", "ln_post_bias", "proj")
)
_RESNET_KEYS = frozenset(("stem", "stages", "attnpool"))
_BN_KEYS = frozenset(("scale", "bias", "mean", "var"))
# the stem's keys, and a bottleneck's (the first of a stage adds the
# downsample's down_conv_w and down_bn)
_STEM_KEYS = frozenset(("conv1_w", "bn1", "conv2_w", "bn2", "conv3_w", "bn3"))
_ATTNPOOL_KEYS = frozenset(
    ["positional_embedding"] + [f"{n}_{s}" for n in "qkvc" for s in ("w", "b")]
)
_TEXT_KEYS = frozenset(
    ("token_embedding", "positional_embedding", "blocks", "ln_final_scale",
     "ln_final_bias", "text_projection")
)


def _require_keys(tree: Mapping, keys: frozenset, where: str) -> None:
    if set(tree) != keys:
        missing, extra = sorted(keys - set(tree)), sorted(set(tree) - keys)
        raise KeyError(f"{where}: missing {missing}, unexpected {extra}")


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def _blocks(tree: Mapping, where: str, device, dtype, split_ok: bool = False) -> dict:
    _require_keys(tree, _SPLIT_BLOCK_KEYS if split_ok and "w_q" in tree else _BLOCK_KEYS, where)
    return {k: _tensor(v, device, dtype) for k, v in tree.items()}


def _resnet_visual(tree: Mapping, device, dtype) -> dict:
    """A ModifiedResNet visual tree (``ovmr_tpu/models/resnet.py``): the
    stem, the stages as lists of bottleneck dicts, the attention pool."""
    where = "params['visual']"
    _require_keys(tree, _RESNET_KEYS, where)
    _require_keys(tree["attnpool"], _ATTNPOOL_KEYS, f"{where}['attnpool']")

    def conv_bn(node, keys, at):
        _require_keys(node, keys, at)
        out = {}
        for k, v in node.items():
            if k.startswith(("bn", "down_bn")):
                _require_keys(v, _BN_KEYS, f"{at}[{k!r}]")
                out[k] = {n: _tensor(a, device, dtype) for n, a in v.items()}
            else:
                out[k] = _tensor(v, device, dtype)
        return out

    stages = [
        [conv_bn(block, _STEM_KEYS | ({"down_conv_w", "down_bn"} & set(block)),
                 f"{where}['stages'][{i}][{j}]")
         for j, block in enumerate(stage)]
        for i, stage in enumerate(tree["stages"])
    ]
    return {
        "stem": conv_bn(tree["stem"], _STEM_KEYS, f"{where}['stem']"),
        "stages": stages,
        "attnpool": {k: _tensor(v, device, dtype) for k, v in tree["attnpool"].items()},
    }


def clip_params_from_numpy(params: Mapping, device="cpu", dtype=torch.float32) -> dict:
    """JAX CLIP params (numpy leaves) -> the port's CLIP params: ViT towers
    with packed or split-qkv blocks, or a ModifiedResNet image tower.
    ``logit_scale`` stays fp32 whatever ``dtype`` is."""
    _require_keys(params, frozenset(("visual", "text", "logit_scale")), "params")
    _require_keys(params["text"], _TEXT_KEYS, "params['text']")

    def tower(tree, where):
        return {
            k: _blocks(v, f"{where}['blocks']", device, dtype, split_ok=True)
            if k == "blocks" else _tensor(v, device, dtype)
            for k, v in tree.items()
        }

    if "stem" in params["visual"]:
        visual = _resnet_visual(params["visual"], device, dtype)
    else:
        _require_keys(params["visual"], _VISUAL_KEYS, "params['visual']")
        visual = tower(params["visual"], "params['visual']")
    return {
        "visual": visual,
        "text": tower(params["text"], "params['text']"),
        "logit_scale": _tensor(params["logit_scale"], device, torch.float32),
    }


def aggregator_params_from_numpy(params: Mapping, device="cpu", dtype=torch.float32) -> dict:
    """JAX aggregator params (numpy leaves) -> the port's aggregator params."""
    _require_keys(params, frozenset(("blocks", "cls_token")), "aggregator params")
    return {
        "blocks": _blocks(params["blocks"], "aggregator params['blocks']", device, dtype),
        "cls_token": _tensor(params["cls_token"], device, dtype),
    }


def aggregator_params_to_numpy(params: Mapping) -> dict:
    """The port's aggregator params -> nested dict of fp32 numpy arrays in
    the JAX package's layout (the same keys and shapes)."""
    _require_keys(params, frozenset(("blocks", "cls_token")), "aggregator params")
    _require_keys(params["blocks"], _BLOCK_KEYS, "aggregator params['blocks']")

    def array(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    return {
        "blocks": {k: array(v) for k, v in params["blocks"].items()},
        "cls_token": array(params["cls_token"]),
    }
