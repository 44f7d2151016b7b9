"""``torch.optim`` optimizer factory for the port's trainers.

Counterpart of ``ovmr_tpu/engine/optimizers.py`` ``build_optimizer`` :203 and
``set_lr`` :292. The JAX factory was built to reproduce the torch optimizers
the reference constructs (``dassl/optim/optimizer.py:88-147``), so each name
maps onto ``torch.optim`` with no correction term:

- ``adam`` / ``amsgrad``: ``Adam`` with L2 decay added to the gradient before
  the moments (:216-225), eps 1e-8 outside the root; ``amsgrad`` maxes the
  raw second moment (:44-81).
- ``adamw``: ``AdamW``, decoupled decay applied together with the lr (:227-234).
- ``sgd``: ``SGD`` with momentum, optional nesterov, no dampening (:236-242).
- ``rmsprop``: ``RMSprop`` with eps outside the root (:244-258).

The learning rate is set once per epoch with :func:`set_lr`, as the
reference steps its scheduler per epoch. ``radam``, ``custom_adam`` and
staged learning rates (``OPTIM.STAGED_LR``) are not ported yet: CoOp and
the Dassl families use them, the flagship OVMR recipe is plain ``adam``.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import torch

_LATER = "it is ported with the CoOp / Dassl trainer slice"


def param_leaves(params: Union[dict, Iterable[torch.Tensor]]) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict of parameters, in key order; an
    iterable of tensors passes through."""
    if isinstance(params, dict):
        return [leaf for key in sorted(params) for leaf in param_leaves(params[key])]
    if isinstance(params, torch.Tensor):
        return [params]
    return list(params)


def build_optimizer(optim_cfg, params) -> torch.optim.Optimizer:
    """The optimizer ``optim_cfg.NAME`` over ``params`` (a nested dict of
    leaf tensors, or an iterable of them). ``optim_cfg`` is any object with
    the ``OPTIM`` attributes (NAME, LR, WEIGHT_DECAY, MOMENTUM, SGD_NESTEROV,
    RMSPROP_ALPHA, ADAM_BETA1, ADAM_BETA2, STAGED_LR)."""
    name = optim_cfg.NAME
    lr = float(optim_cfg.LR)
    wd = float(optim_cfg.WEIGHT_DECAY)
    betas = (float(optim_cfg.ADAM_BETA1), float(optim_cfg.ADAM_BETA2))
    mom = float(optim_cfg.MOMENTUM)
    if bool(optim_cfg.STAGED_LR):
        raise ValueError(f"OPTIM.STAGED_LR is not supported yet: {_LATER}")
    leaves = param_leaves(params)
    if name in ("adam", "amsgrad"):
        return torch.optim.Adam(
            leaves, lr=lr, betas=betas, eps=1e-8, weight_decay=wd, amsgrad=name == "amsgrad"
        )
    if name == "adamw":
        return torch.optim.AdamW(leaves, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(
            leaves, lr=lr, momentum=mom, dampening=0.0, weight_decay=wd,
            nesterov=bool(optim_cfg.SGD_NESTEROV) and mom > 0,
        )
    if name == "rmsprop":
        return torch.optim.RMSprop(
            leaves, lr=lr, alpha=float(optim_cfg.RMSPROP_ALPHA), eps=1e-8,
            weight_decay=wd, momentum=mom,
        )
    if name in ("radam", "custom_adam"):
        raise ValueError(f"optimizer {name!r} is not supported yet: {_LATER}")
    raise ValueError(f"unsupported optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set every param group's learning rate (per-epoch stepping)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
