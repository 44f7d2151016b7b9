"""The sharded checkpoint backend (``CUDA.CHECKPOINT_BACKEND "orbax"``).

Counterpart of ``ovmr_tpu/engine/orbax_io.py``: the same directory layout
and contract, written by ``torch.distributed.checkpoint`` (which ships
with torch; orbax does not run here):

- ``{directory}/{name}/orbax-{epoch}/params`` and ``.../opt_state``, one
  checkpoint each, so a params-only restore reads a checkpoint saved with
  optimizer state;
- ``.../orbax-{epoch}/meta.json`` (``epoch``, ``has_opt_state``, and here
  ``format``) and the ``{directory}/{name}/checkpoint_orbax`` pointer.

The array files are torch's, not orbax's: a directory the JAX package's
orbax wrote is refused with a message, never misread. npz stays the format
both packages read. Save and load are collectives under a process group:
every rank calls them, with no early return (the primary rank writes the
meta file and the pointer; ``torch.distributed.checkpoint`` writes each
replicated array once). The optimizer state is
:func:`ovmr_tpu_torch.engine.checkpoint.optimizer_state_arrays`' entries,
the npz path's ``opt//`` layout.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch

FORMAT = "torch.distributed.checkpoint"


def save_orbax(directory: str, name: str, epoch: int, params: dict, optimizer=None,
               opt_params=None) -> str:
    """Write ``{directory}/{name}/orbax-{epoch}/{params,opt_state}``, its
    ``meta.json`` and the pointer; returns the checkpoint's directory.
    ``opt_params`` names the optimizer's parameters where they are not the
    leaves of ``params`` (a Dassl model's flax-layout leaves,
    :func:`ovmr_tpu_torch.engine.checkpoint.optimizer_state_arrays`)."""
    import torch.distributed.checkpoint as dcp

    from ovmr_tpu_torch.engine.checkpoint import named_leaves, optimizer_state_arrays
    from ovmr_tpu_torch.parallel.multihost import barrier, is_primary

    subdir = osp.join(osp.abspath(directory), name)
    path = osp.join(subdir, f"orbax-{epoch}")
    os.makedirs(path, exist_ok=True)
    dcp.save({k: v.detach().cpu() for k, v in named_leaves(params)},
             checkpoint_id=osp.join(path, "params"))
    if optimizer is not None:
        opt = optimizer_state_arrays(optimizer, params if opt_params is None else opt_params)
        dcp.save({k: torch.as_tensor(v) for k, v in opt.items()},
                 checkpoint_id=osp.join(path, "opt_state"))
    if is_primary():
        with open(osp.join(path, "meta.json"), "w") as f:
            json.dump({"epoch": int(epoch), "has_opt_state": optimizer is not None,
                       "format": FORMAT}, f)
        with open(osp.join(subdir, "checkpoint_orbax"), "w") as f:
            f.write(osp.basename(path))
    barrier()
    print(f"Checkpoint saved to {path}")
    return path


def _read(path: str, template: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The flat arrays of one checkpoint, shaped by its own metadata (and
    checked against ``template``'s keys)."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if template is not None and set(meta) != set(template):
        raise KeyError(f"checkpoint {path} holds {sorted(meta)[:4]}..., the parameters are "
                       f"{sorted(template)[:4]}...")
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(state, checkpoint_id=path)
    return state


def load_orbax(directory: str, name: str, params_template: dict, with_opt_state: bool = True,
               epoch: Optional[int] = None) -> Tuple[dict, Optional[Dict[str, np.ndarray]], int]:
    """Read the checkpoint of ``epoch`` (else the pointer's): ``(params on
    the CPU in the template's dtypes, the optimizer entries or None,
    epoch)``, the npz path's contract. No checkpoint raises
    FileNotFoundError; one the JAX package's orbax wrote raises ValueError."""
    from ovmr_tpu_torch.engine.checkpoint import _unflatten_like, named_leaves

    subdir = osp.join(osp.abspath(directory), name)
    if epoch is not None:
        path = osp.join(subdir, f"orbax-{epoch}")
    else:
        pointer = osp.join(subdir, "checkpoint_orbax")
        if not osp.exists(pointer):
            raise FileNotFoundError(f"No orbax pointer at {pointer}")
        with open(pointer) as f:
            path = osp.join(subdir, f.read().strip())
    meta_path = osp.join(path, "meta.json")
    if not osp.exists(meta_path):
        raise FileNotFoundError(f"No orbax checkpoint at {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path} was written by orbax (the JAX package's backend), whose array files the "
            "PyTorch port cannot read; its orbax-layout directories hold torch.distributed."
            "checkpoint files. Resume from the npz checkpoint, the format both packages read "
            "(CHECKPOINT_BACKEND npz)")
    flat = _read(osp.join(path, "params"), dict(named_leaves(params_template)))
    params = _unflatten_like(params_template, {k: v.numpy() for k, v in flat.items()})
    opt = None
    if with_opt_state and meta.get("has_opt_state"):
        opt = {k: v.numpy() for k, v in _read(osp.join(path, "opt_state")).items()}
    return params, opt, int(meta["epoch"])
