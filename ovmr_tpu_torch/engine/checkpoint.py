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

The optimizer state lives in the ``torch.optim`` optimizer. Its
``opt//...`` keys are the JAX package's optax layout for every optimizer
``build_optimizer`` makes: torch's ``exp_avg``, ``exp_avg_sq`` and ``step``
are optax's ``mu``, ``nu`` and ``count`` (adam, adamw, radam,
custom_adam), amsgrad adds ``max_exp_avg_sq`` as ``nu_max``, rmsprop's
``square_avg`` is ``nu`` and a ``momentum_buffer`` is ``optax.trace``'s
``trace`` (sgd, rmsprop); staged learning rates keep each group's state
under ``multi_transform``'s ``inner_states//<stage>``. So either package
resumes the other's checkpoint, and a layout another optimizer wrote is
refused. An optimizer with no optax twin cannot be saved.

``backend="orbax"`` (``CUDA.CHECKPOINT_BACKEND``) routes the epoch-keyed
save/resume cycle through :mod:`ovmr_tpu_torch.engine.orbax_io` (orbax's
layout, ``torch.distributed.checkpoint``'s files), on every rank; named
saves (best-val) stay npz. Under a process group the npz path writes on
rank 0 only (the state is replicated; JAX :74-89) and every rank waits for
the write.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ovmr_tpu_torch.engine.optimizers import SGD, CustomAdam, RAdam
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


def _optax_entries(optimizer: torch.optim.Optimizer, group: dict) -> List[Tuple[str, str]]:
    """The optax chain entries that hold one param group's state:
    ``(key under the chain's inner_state, torch state name)`` pairs, the
    torch name ``"step"`` for an entry's own count. An optimizer without an
    optax twin raises.

    ``build_optimizer`` chains ``add_decayed_weights`` (stateless) first
    where the decay is > 0, so adam's, amsgrad's, sgd's and rmsprop's state
    starts at the chain's second entry with a decay and at its first
    without; adamw decays after its moments, radam and custom_adam inside
    their one stateful entry. rmsprop's momentum is a second entry
    (``optax.trace``) after ``scale_by_rms``."""
    d = 1 if group["weight_decay"] > 0 else 0
    moments = [(f"{{i}}{SEP}.count", "step"), (f"{{i}}{SEP}.mu", "exp_avg"),
               (f"{{i}}{SEP}.nu", "exp_avg_sq")]
    kind = type(optimizer)
    if kind is torch.optim.AdamW or group.get("decoupled_weight_decay", False):
        return [(k.format(i=0), n) for k, n in moments]
    if kind is torch.optim.Adam:
        extra = [(f"{{i}}{SEP}.nu_max", "max_exp_avg_sq")] if group["amsgrad"] else []
        return [(k.format(i=d), n) for k, n in moments + extra]
    if kind in (RAdam, CustomAdam):
        return [(k.format(i=0), n) for k, n in moments]
    if kind is SGD:
        # optax.trace's state is torch's momentum buffer; without momentum
        # the chain holds no state but its count
        return [(f"{d}{SEP}.trace", "momentum_buffer")] if group["momentum"] > 0 else []
    if kind is torch.optim.RMSprop and not group.get("centered", False):
        entries = [(f"{d}{SEP}.nu", "square_avg")]
        if group["momentum"] > 0:
            entries.append((f"{d + 1}{SEP}.trace", "momentum_buffer"))
        return entries
    raise ValueError(f"{kind.__name__} has no optax layout; build the optimizer with "
                     f"build_optimizer")


def _optax_layout(optimizer: torch.optim.Optimizer) -> List[Tuple[dict, str, List[Tuple[str, str]]]]:
    """Where the JAX package's optax layout holds this optimizer's state:
    one ``(group, prefix of its chain's inner state, entries)`` a param
    group (:func:`_optax_entries`). Staged groups live under
    ``multi_transform``'s state, keyed by their stage name."""
    groups = optimizer.param_groups
    staged = len(groups) > 1 or "stage" in groups[0]
    out = []
    for group in groups:
        if staged and "stage" not in group:
            raise ValueError("several param groups need a stage name each "
                             "(build_optimizer's OPTIM.STAGED_LR names them)")
        prefix = (f".inner_state{SEP}.inner_states{SEP}{group['stage']}{SEP}.inner_state"
                  if staged else ".inner_state")
        out.append((group, prefix, _optax_entries(optimizer, group)))
    return out


def _identity(a):
    return a


def _named(params) -> List[Tuple[str, torch.Tensor, Callable, Callable]]:
    """``(key, leaf, to_saved, from_saved)`` of each parameter: a nested dict
    gives its :func:`named_leaves` in their own layout; a list of such
    4-tuples (a Dassl module's leaves with their flax layout maps) passes
    through."""
    if isinstance(params, dict):
        return [(k, p, _identity, _identity) for k, p in named_leaves(params)]
    return list(params)


def optimizer_state_arrays(optimizer: torch.optim.Optimizer, params) -> Dict[str, np.ndarray]:
    """The optimizer's state as the ``opt//`` entries of a checkpoint (numpy
    copies, so later steps do not change them). ``params`` is the nested
    dict the optimizer was built on, or :func:`_named`'s 4-tuples."""
    named = _named(params)
    layout = _optax_layout(optimizer)
    steps = [float(optimizer.state[p]["step"]) for _, p, _, _ in named
             if "step" in optimizer.state.get(p, {})]
    count = np.asarray(int(steps[0]) if steps else 0, np.int32)
    group0 = optimizer.param_groups[0]
    lr = group0["lr"] / group0.get("lr_mult", 1.0)
    out = {".count": count, f".hyperparams{SEP}lr": np.asarray(lr, np.float32)}
    for group, prefix, entries in layout:
        members = {id(p) for p in group["params"]}
        for key, theirs in entries:
            if theirs == "step":
                out[f"{prefix}{SEP}{key}"] = count
                continue
            for name, p, to_saved, _ in named:
                if id(p) not in members:
                    continue
                value = optimizer.state.get(p, {}).get(theirs)
                value = torch.zeros_like(p) if value is None else value
                out[f"{prefix}{SEP}{key}{SEP}{name}"] = to_saved(
                    _fp32_cpu(value)).contiguous().numpy().copy()
    return out


def load_optimizer_state(optimizer: torch.optim.Optimizer, params,
                         flat: Dict[str, np.ndarray]) -> None:
    """Restore the optimizer from a checkpoint's ``opt//`` entries (keys
    without the ``opt//`` prefix); a layout another optimizer wrote raises.
    ``params`` as :func:`optimizer_state_arrays` takes it."""
    named = _named(params)
    # torch numbers the parameters of all groups in order
    ordered = [p for group in optimizer.param_groups for p in group["params"]]
    index = {id(p): i for i, p in enumerate(ordered)}
    layout = _optax_layout(optimizer)
    want = {".count", f".hyperparams{SEP}lr"}
    for group, prefix, entries in layout:
        members = {id(p) for p in group["params"]}
        for key, theirs in entries:
            want |= ({f"{prefix}{SEP}{key}"} if theirs == "step" else
                     {f"{prefix}{SEP}{key}{SEP}{name}" for name, p, _, _ in named
                      if id(p) in members})
    if set(flat) != want:
        kind = type(optimizer).__name__
        raise ValueError(
            f"the checkpoint's optimizer state was not written by {kind} with these "
            f"parameters and this weight decay: it is not that optax layout (expected "
            f"{sorted(want)[:3]}..., found {sorted(flat)[:3]}...)")
    step = torch.tensor(float(flat[".count"]), dtype=torch.float32)
    state = {}
    for group, prefix, entries in layout:
        members = {id(p) for p in group["params"]}
        for name, p, _, from_saved in named:
            if id(p) not in members:
                continue
            entry = {"step": step.clone()}
            for key, theirs in entries:
                if theirs != "step":
                    value = from_saved(np.asarray(flat[f"{prefix}{SEP}{key}{SEP}{name}"]))
                    entry[theirs] = torch.from_numpy(np.ascontiguousarray(value))
            state[index[id(p)]] = entry
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def save_checkpoint(
    directory: str,
    name: str,
    epoch: int,
    params: dict,
    optimizer: Optional[torch.optim.Optimizer] = None,
    is_best: bool = False,
    model_name: str = "",
    backend: str = "npz",
    opt_params=None,
) -> str:
    """Write ``{directory}/{name}/model-{epoch}.npz`` + pointer file. With
    ``model_name`` the file is ``{model_name}.npz`` instead (the
    reference's best-val save passes ``model-best``,
    ``dassl/engine/trainer.py:448-455``); the pointer always tracks the
    latest write, matching ``torchtools.py:65-69``. ``backend="orbax"``
    sends an epoch save to :func:`ovmr_tpu_torch.engine.orbax_io.save_orbax`
    instead. ``opt_params`` names the optimizer's parameters where they are
    not the leaves of ``params`` (a Dassl model's flax-layout leaves)."""
    if backend not in ("npz", "orbax"):
        raise ValueError(f"CHECKPOINT_BACKEND {backend!r}: expected 'npz' or 'orbax'")
    if backend == "orbax" and not model_name and not is_best:
        from ovmr_tpu_torch.engine.orbax_io import save_orbax

        return save_orbax(directory, name, epoch, params, optimizer, opt_params=opt_params)
    from ovmr_tpu_torch.parallel.multihost import barrier, is_primary

    subdir = osp.join(directory, name)
    fname = f"{model_name}.npz" if model_name else f"model-{epoch}.npz"
    path = osp.join(subdir, fname)
    if not is_primary():
        barrier()  # written by rank 0
        return path
    os.makedirs(subdir, exist_ok=True)
    payload = {f"params{SEP}{k}": v.detach().cpu().numpy() for k, v in named_leaves(params)}
    payload["__epoch__"] = np.asarray(epoch)
    if optimizer is not None:
        payload.update({f"opt{SEP}{k}": v for k, v in optimizer_state_arrays(
            optimizer, params if opt_params is None else opt_params).items()})
    np.savez(path, **payload)
    with open(osp.join(subdir, "checkpoint"), "w") as f:
        f.write(osp.basename(path))
    if is_best:
        np.savez(osp.join(subdir, "model-best.npz"), **payload)
    print(f"Checkpoint saved to {path}")
    barrier()
    return path


def load_checkpoint(
    directory: str,
    name: str,
    params_template: dict,
    epoch: Optional[int] = None,
    prefer: str = "best",
    torch_converter: Optional[Callable[[str], Tuple[dict, int]]] = None,
    backend: str = "npz",
) -> Tuple[dict, Optional[Dict[str, np.ndarray]], int]:
    """Load by explicit epoch; else prefer ``model-best`` then the pointer
    file — the reference's ``load_model`` defaults to the best model
    (``mm_…:470-476``); its resume path follows the pointer only
    (``torchtools.py:118-157`` — pass ``prefer="pointer"``). Native npz and
    reference ``model.pth.tar`` files both load (the latter through
    ``torch_converter``, a path -> ``(params, epoch)`` function; by default
    :func:`ovmr_tpu_torch.models.import_torch.load_prompt_learner`).
    Returns ``(params on the CPU in the template's dtypes, the opt//
    entries without their prefix or None, epoch)``. With ``backend="orbax"``
    an orbax-layout checkpoint is read first, the npz and torch files after
    it when the directory holds none (JAX :135-143)."""
    if backend == "orbax":
        from ovmr_tpu_torch.engine.orbax_io import load_orbax

        try:
            return load_orbax(directory, name, params_template, epoch=epoch)
        except FileNotFoundError:
            pass
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
        if torch_converter is None:
            from ovmr_tpu_torch.models.import_torch import load_prompt_learner

            torch_converter = load_prompt_learner
        params, ep = torch_converter(path)
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
                           optimizer: Optional[torch.optim.Optimizer] = None,
                           backend: str = "npz") -> int:
    """Resume the latest (pointer-tracked) checkpoint if there is one: its
    parameters into ``params`` in place and its optimizer state into
    ``optimizer``; return its epoch, else 0 with nothing changed (reference
    ``resume_from_checkpoint``, ``torchtools.py:118-157``). With
    ``backend="orbax"`` the orbax pointer is followed first."""
    loaded = None
    if backend == "orbax":
        from ovmr_tpu_torch.engine.orbax_io import load_orbax

        try:
            loaded, opt, epoch = load_orbax(directory, name, params,
                                            with_opt_state=optimizer is not None)
            note = " (orbax)"
        except FileNotFoundError:
            pass  # interop: the directory may hold npz or torch checkpoints
    if loaded is None:
        try:
            loaded, opt, epoch = load_checkpoint(directory, name, params, prefer="pointer")
        except FileNotFoundError:
            return 0
        note = ""
    copy_into(params, loaded)
    if optimizer is not None and opt is not None:
        load_optimizer_state(optimizer, params, opt)
    print(f"Resumed from epoch {epoch}{note}")
    return epoch
