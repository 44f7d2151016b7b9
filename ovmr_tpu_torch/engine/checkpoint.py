"""Checkpoints and artifact export.

Counterpart of ``ovmr_tpu/engine/checkpoint.py``:

- the save/resume cycle (``save_checkpoint`` :54, ``load_checkpoint`` :118,
  ``resume_from_checkpoint`` :194): ``{directory}/{name}/model-{epoch}.npz``
  with the JAX package's ``params//...`` keys and ``__epoch__`` entry, and
  the ``checkpoint`` pointer file, best-model names and pointer-vs-best
  preference of the reference trainer (``dassl/utils/torchtools.py:27-157``);
- ``export_classifiers_torch`` (the reference's key names and fp32 dtype,
  ``mm_…:276-291``), ``aggregator_to_torch_state_dict`` :268 and
  ``save_torch_checkpoint`` :302 (``model.pth.tar-N``).

The optimizer state lives in the ``torch.optim`` optimizer. For ``adam``
(the flagship recipe) its ``opt//...`` keys are the JAX package's optax
layout, with torch's ``exp_avg``, ``exp_avg_sq`` and ``step`` as optax's
``mu``, ``nu`` and ``count``, so either package resumes the other's
checkpoint. Every other optimizer writes torch's own state under
``opt//.torch.<kind>//...`` and refuses a layout written by another. The
orbax backend of the JAX package is not ported.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

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


# --------------------------------------------------------------------------
# the save/resume cycle
# --------------------------------------------------------------------------

SEP = "//"


def named_leaves(params: dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(key, leaf)`` pairs of a nested dict of tensors, keys joined with
    ``//`` as the JAX package flattens its pytrees, in
    :func:`ovmr_tpu_torch.engine.optimizers.param_leaves` order (sorted
    keys, depth first)."""
    out = []
    for key in sorted(params):
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        value = params[key]
        out.extend(named_leaves(value, path) if isinstance(value, dict) else [(path, value)])
    return out


def _unflatten_like(template: dict, flat: Dict[str, np.ndarray], prefix: str = "") -> dict:
    out = {}
    for key, value in template.items():
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            out[key] = _unflatten_like(value, flat, path)
        elif path not in flat:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        else:
            out[key] = torch.as_tensor(np.asarray(flat[path])).to(value.dtype)
    return out


def _is_optax_adam(optimizer: torch.optim.Optimizer) -> bool:
    """``torch.optim.Adam`` as the ``adam`` of ``build_optimizer`` makes it:
    L2 decay, no amsgrad, one param group."""
    group = optimizer.param_groups[0]
    return (type(optimizer) is torch.optim.Adam and len(optimizer.param_groups) == 1
            and not group["amsgrad"] and not group.get("decoupled_weight_decay", False))


def _torch_kind(optimizer: torch.optim.Optimizer) -> str:
    kind = type(optimizer).__name__
    return kind + "-amsgrad" if optimizer.param_groups[0].get("amsgrad") else kind


def _adam_inner(optimizer: torch.optim.Optimizer) -> str:
    # optax.chain(add_decayed_weights, scale_by_adam, scale): the adam
    # state is the chain's second entry with a decay, its first without
    return f".inner_state{SEP}{1 if optimizer.param_groups[0]['weight_decay'] > 0 else 0}"


def optimizer_state_arrays(optimizer: torch.optim.Optimizer, params: dict) -> Dict[str, np.ndarray]:
    """The optimizer's state as the ``opt//`` entries of a checkpoint (numpy
    copies, so later steps do not change them)."""
    named = named_leaves(params)
    if _is_optax_adam(optimizer):
        inner = _adam_inner(optimizer)
        steps = [float(optimizer.state[p]["step"]) for _, p in named if p in optimizer.state]
        count = np.asarray(int(steps[0]) if steps else 0, np.int32)
        out = {
            ".count": count,
            f".hyperparams{SEP}lr": np.asarray(optimizer.param_groups[0]["lr"], np.float32),
            f"{inner}{SEP}.count": count,
        }
        for key, p in named:
            state = optimizer.state.get(p, {})
            for ours, theirs in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                value = state.get(theirs, torch.zeros_like(p))
                out[f"{inner}{SEP}.{ours}{SEP}{key}"] = _fp32_cpu(value).numpy().copy()
        return out
    kind = _torch_kind(optimizer)
    out = {}
    for key, p in named:
        for sname, value in optimizer.state.get(p, {}).items():
            if isinstance(value, torch.Tensor):
                out[f".torch.{kind}{SEP}{key}{SEP}{sname}"] = value.detach().cpu().numpy().copy()
    return out


def load_optimizer_state(optimizer: torch.optim.Optimizer, params: dict,
                         flat: Dict[str, np.ndarray]) -> None:
    """Restore the optimizer from a checkpoint's ``opt//`` entries (keys
    without the ``opt//`` prefix); a layout another optimizer wrote raises."""
    named = named_leaves(params)
    index = {id(p): i for i, p in enumerate(optimizer.param_groups[0]["params"])}
    state = {}
    if _is_optax_adam(optimizer):
        inner = _adam_inner(optimizer)
        want = {".count", f".hyperparams{SEP}lr", f"{inner}{SEP}.count"} | {
            f"{inner}{SEP}.{m}{SEP}{key}" for key, _ in named for m in ("mu", "nu")}
        if set(flat) != want:
            raise ValueError(
                "the checkpoint's optimizer state is not adam's optax layout for these "
                f"parameters and this weight decay (expected {sorted(want)[:3]}..., found "
                f"{sorted(flat)[:3]}...)")
        step = torch.tensor(float(flat[f"{inner}{SEP}.count"]), dtype=torch.float32)
        for key, p in named:
            state[index[id(p)]] = {
                "step": step.clone(),
                "exp_avg": torch.as_tensor(flat[f"{inner}{SEP}.mu{SEP}{key}"]),
                "exp_avg_sq": torch.as_tensor(flat[f"{inner}{SEP}.nu{SEP}{key}"]),
            }
    else:
        prefix = f".torch.{_torch_kind(optimizer)}{SEP}"
        foreign = [k for k in flat if not k.startswith(prefix)]
        if foreign:
            raise ValueError(
                f"the checkpoint's optimizer state was not written by {_torch_kind(optimizer)} "
                f"(found {foreign[:3]}...)")
        for key, p in named:
            names = {k[len(prefix) + len(key) + len(SEP):] for k in flat
                     if k.startswith(f"{prefix}{key}{SEP}")}
            if names:
                state[index[id(p)]] = {
                    n: torch.as_tensor(flat[f"{prefix}{key}{SEP}{n}"]) for n in names}
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def save_checkpoint(
    directory: str,
    name: str,
    epoch: int,
    params: dict,
    optimizer: Optional[torch.optim.Optimizer] = None,
    is_best: bool = False,
    model_name: str = "",
) -> str:
    """Write ``{directory}/{name}/model-{epoch}.npz`` + pointer file. With
    ``model_name`` the file is ``{model_name}.npz`` instead (the
    reference's best-val save passes ``model-best``,
    ``dassl/engine/trainer.py:448-455``); the pointer always tracks the
    latest write, matching ``torchtools.py:65-69``."""
    subdir = osp.join(directory, name)
    os.makedirs(subdir, exist_ok=True)
    fname = f"{model_name}.npz" if model_name else f"model-{epoch}.npz"
    path = osp.join(subdir, fname)
    payload = {f"params{SEP}{k}": v.detach().cpu().numpy() for k, v in named_leaves(params)}
    payload["__epoch__"] = np.asarray(epoch)
    if optimizer is not None:
        payload.update({f"opt{SEP}{k}": v
                        for k, v in optimizer_state_arrays(optimizer, params).items()})
    np.savez(path, **payload)
    with open(osp.join(subdir, "checkpoint"), "w") as f:
        f.write(osp.basename(path))
    if is_best:
        np.savez(osp.join(subdir, "model-best.npz"), **payload)
    print(f"Checkpoint saved to {path}")
    return path


def load_checkpoint(
    directory: str,
    name: str,
    params_template: dict,
    epoch: Optional[int] = None,
    prefer: str = "best",
) -> Tuple[dict, Optional[Dict[str, np.ndarray]], int]:
    """Load by explicit epoch; else prefer ``model-best`` then the pointer
    file — the reference's ``load_model`` defaults to the best model
    (``mm_…:470-476``); its resume path follows the pointer only
    (``torchtools.py:118-157`` — pass ``prefer="pointer"``). Native npz and
    reference ``model.pth.tar`` files both load (the latter through
    :func:`ovmr_tpu_torch.models.import_torch.load_prompt_learner`).
    Returns ``(params on the CPU in the template's dtypes, the opt//
    entries without their prefix or None, epoch)``."""
    subdir = osp.join(directory, name)
    if epoch is not None:
        candidates = [f"model-{epoch}.npz", f"model.pth.tar-{epoch}"]
    else:
        candidates = ["model-best.npz", "model-best.pth.tar"] if prefer == "best" else []
        pointer = osp.join(subdir, "checkpoint")
        if osp.exists(pointer):
            with open(pointer) as f:
                base = f.read().strip()
            if base and base not in candidates:
                candidates.append(base)
        if not candidates:
            raise FileNotFoundError(f"No checkpoint pointer at {pointer}")
    path = next((osp.join(subdir, c) for c in candidates if osp.exists(osp.join(subdir, c))),
                None)
    if path is None:
        raise FileNotFoundError(f'Model not found under "{subdir}" (tried {candidates})')
    if not path.endswith(".npz"):
        from ovmr_tpu_torch.models.import_torch import load_prompt_learner

        params, ep = load_prompt_learner(path)
        return params, None, ep

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    params = _unflatten_like(params_template, {
        k[len("params" + SEP):]: v for k, v in flat.items() if k.startswith("params" + SEP)})
    opt = {k[len("opt" + SEP):]: v for k, v in flat.items() if k.startswith("opt" + SEP)}
    ep = int(flat["__epoch__"]) if "__epoch__" in flat else int(epoch or 0)
    return params, opt or None, ep


def copy_into(params: dict, loaded: dict) -> None:
    """Copy ``loaded`` into the leaves of ``params`` in place, so an
    optimizer that holds them keeps training them."""
    ours, theirs = named_leaves(params), named_leaves(loaded)
    if [k for k, _ in ours] != [k for k, _ in theirs]:
        raise KeyError(f"checkpoint leaves {[k for k, _ in theirs]} do not match the "
                       f"parameters' {[k for k, _ in ours]}")
    with torch.no_grad():
        for (_, leaf), (_, value) in zip(ours, theirs):
            leaf.copy_(value.to(leaf.device, leaf.dtype))


def resume_from_checkpoint(directory: str, name: str, params: dict,
                           optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Resume the latest (pointer-tracked) checkpoint if there is one: its
    parameters into ``params`` in place and its optimizer state into
    ``optimizer``; return its epoch, else 0 with nothing changed (reference
    ``resume_from_checkpoint``, ``torchtools.py:118-157``)."""
    try:
        loaded, opt, epoch = load_checkpoint(directory, name, params, prefer="pointer")
    except FileNotFoundError:
        return 0
    copy_into(params, loaded)
    if optimizer is not None and opt is not None:
        load_optimizer_state(optimizer, params, opt)
    print(f"Resumed from epoch {epoch}")
    return epoch
