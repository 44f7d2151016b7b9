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

The Dassl models (:mod:`ovmr_tpu_torch.modeling`, the trainers' heads) are
``nn.Module``s whose submodules carry the flax modules' names, so their
state maps leaf by leaf: :func:`dassl_state_from_numpy` copies a flax
``{"params", "batch_stats"}`` state (numpy leaves) into a module and
:func:`dassl_state_to_numpy` is the way back. Convolution kernels go from
HWIO to OIHW, linear kernels are transposed, BatchNorm's
``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``;
any other parameter or buffer keeps its name and layout (a ``TransNorm``'s,
``StackedLinears``' stacked ``kernel``). :func:`dassl_leaves` lists that
map, which the Dassl checkpoints also apply to the optimizer's moments.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

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


# --------------------------------------------------------------------------
# the Dassl models
# --------------------------------------------------------------------------

class DasslLeaf(NamedTuple):
    """One leaf of a flax Dassl state and the module tensor that holds it:
    its collection (``params`` or ``batch_stats``), its flax path, the
    tensor, and the layout maps ``to_flax``/``from_flax`` (numpy or torch
    arrays of the tensor's rank)."""

    collection: str
    path: Tuple[str, ...]
    tensor: torch.Tensor
    to_flax: Callable
    from_flax: Callable


def _same(a):
    return a


def _conv_to_flax(w):
    return w.permute(2, 3, 1, 0) if isinstance(w, torch.Tensor) else np.transpose(w, (2, 3, 1, 0))


def _conv_from_flax(k):
    return k.permute(3, 2, 0, 1) if isinstance(k, torch.Tensor) else np.transpose(k, (3, 2, 0, 1))


def _t(w):
    return w.t() if isinstance(w, torch.Tensor) else np.transpose(w)


def dassl_leaves(module: nn.Module) -> List[DasslLeaf]:
    """Every parameter and running statistic of a Dassl module with its
    flax collection, path and layout maps, in the module's order."""
    from ovmr_tpu_torch.modeling.layers import TorchBatchNorm

    leaves = []
    for name, m in module.named_modules():
        prefix = tuple(name.split(".")) if name else ()
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            to, back = ((_conv_to_flax, _conv_from_flax) if isinstance(m, nn.Conv2d)
                        else (_t, _t))
            leaves.append(DasslLeaf("params", prefix + ("kernel",), m.weight, to, back))
            if m.bias is not None:
                leaves.append(DasslLeaf("params", prefix + ("bias",), m.bias, _same, _same))
        elif isinstance(m, TorchBatchNorm):
            for coll, flax_name, t in (("params", "scale", m.weight), ("params", "bias", m.bias),
                                       ("batch_stats", "mean", m.running_mean),
                                       ("batch_stats", "var", m.running_var)):
                leaves.append(DasslLeaf(coll, prefix + (flax_name,), t, _same, _same))
        else:
            for pname, p in m.named_parameters(recurse=False):
                leaves.append(DasslLeaf("params", prefix + (pname,), p, _same, _same))
            for bname, b in m.named_buffers(recurse=False):
                leaves.append(DasslLeaf("batch_stats", prefix + (bname,), b, _same, _same))
    return leaves


def _lookup(tree: Mapping, path: Tuple[str, ...], where: str):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError(f"{where}: missing leaf {'/'.join(path)!r}")
        node = node[p]
    return node


def _count(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count(v) for v in tree.values())
    return 1


@torch.no_grad()
def dassl_state_from_numpy(module: nn.Module, state: Mapping) -> nn.Module:
    """Copy a flax Dassl state ``{"params": ..., "batch_stats": ...}`` of
    numpy leaves into ``module`` in place (its device and dtypes kept);
    a missing, extra or misshapen leaf raises."""
    leaves = dassl_leaves(module)
    for coll in ("params", "batch_stats"):
        want = sum(1 for leaf in leaves if leaf.collection == coll)
        have = _count(state.get(coll, {}))
        if want != have:
            raise KeyError(f"state[{coll!r}] holds {have} leaves; the module has {want}")
    for leaf in leaves:
        value = leaf.from_flax(np.asarray(_lookup(state[leaf.collection], leaf.path,
                                                  f"state[{leaf.collection!r}]")))
        if tuple(value.shape) != tuple(leaf.tensor.shape):
            raise ValueError(f"{leaf.collection}/{'/'.join(leaf.path)}: shape {value.shape} "
                             f"does not fit {tuple(leaf.tensor.shape)}")
        leaf.tensor.copy_(torch.from_numpy(np.array(value, copy=True)))
    return module


def dassl_state_to_numpy(module: nn.Module) -> dict:
    """A Dassl module's state as the JAX package's flax state: nested dicts
    of fp32 numpy arrays under ``params`` and ``batch_stats``."""
    out = {"params": {}, "batch_stats": {}}
    for leaf in dassl_leaves(module):
        node = out[leaf.collection]
        for p in leaf.path[:-1]:
            node = node.setdefault(p, {})
        node[leaf.path[-1]] = leaf.to_flax(
            leaf.tensor.detach().to("cpu", torch.float32)).contiguous().numpy().copy()
    return out
