"""``torch.optim`` optimizer factory for the port's trainers.

Counterpart of ``ovmr_tpu/engine/optimizers.py`` ``build_optimizer`` :203 and
``set_lr`` :292. The JAX factory was built to reproduce the torch optimizers
the reference constructs (``dassl/optim/optimizer.py:88-147``), so each name
maps onto ``torch.optim`` with no correction term:

- ``adam`` / ``amsgrad``: ``Adam`` with L2 decay added to the gradient before
  the moments (:216-225), eps 1e-8 outside the root; ``amsgrad`` maxes the
  raw second moment (:44-81).
- ``adamw``: ``AdamW``, decoupled decay applied together with the lr (:227-234).
- ``sgd``: ``SGD`` with momentum, optional nesterov, no dampening (:236-242),
  counting its steps as optax's ``count``.
- ``rmsprop``: ``RMSprop`` with eps outside the root (:244-258).

Two have no ``torch.optim`` twin and are written here: :class:`RAdam`, the
rectified Adam vendored in ``dassl/optim/radam.py`` (``scale_by_radam_torch``
:84-148: plain moments, the SGD step while the rectifier's N_sma is below 5,
decoupled lr-scaled decay; ``torch.optim.RAdam`` differs), and
:class:`CustomAdam`, the reference's masked Adam
(``dassl/optim/optimizer.py:152-208``, ``scale_by_custom_adam`` :151-187).
Their step-dependent scalars are fp32, as the JAX package's transforms
compute them, so either package resumes the other's state to the step;
the reference takes Python floats, within the golden trajectories'
tolerances of both (``tests/test_optim_extra.py``).

``OPTIM.STAGED_LR`` makes two param groups (:190-200): leaves under a
top-level key named in ``OPTIM.NEW_LAYERS`` train at ``LR`` ("new"), the
rest at ``LR * BASE_LR_MULT`` ("base"); each group names its stage
(``"stage"``), as optax's ``multi_transform`` keys its states. The learning rate is set once per
epoch with :func:`set_lr`, which keeps each group's ratio, as the reference
steps its scheduler per epoch.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

import torch


def param_leaves(params: Union[dict, Iterable[torch.Tensor]]) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict of parameters, in key order; an
    iterable of tensors passes through."""
    if isinstance(params, dict):
        return [leaf for key in sorted(params) for leaf in param_leaves(params[key])]
    if isinstance(params, torch.Tensor):
        return [params]
    return list(params)


def _count_step(state: dict) -> torch.Tensor:
    """Advance and return ``state["step"]`` (an fp32 tensor, as Adam's)."""
    state["step"] = state.get("step", torch.tensor(0.0)) + 1
    return state["step"]


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` that also counts its steps in each parameter's
    state (``step``, as Adam keeps it), so a checkpoint holds optax's
    ``count``."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = super().step(closure)
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    _count_step(self.state[p])
        return loss


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as ``dassl/optim/radam.py:50-130`` computes it (JAX
    ``scale_by_radam_torch`` then ``scale(-lr)``): EMA moments; with N_sma
    >= 5 the rectified adaptive step, else the SGD step ``m / (1 - b1^t)``
    (or no step at all, decay included, without ``degenerated_to_sgd``);
    decay decoupled and scaled by the lr."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, degenerated_to_sgd: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      degenerated_to_sgd=degenerated_to_sgd))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            n_sma_max = 2.0 / (1 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "exp_avg" not in state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                t = _count_step(state)
                beta2_t = b2 ** t
                n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
                if float(n_sma) >= 5.0:
                    rect = torch.sqrt(
                        (1 - beta2_t) * (n_sma - 4) / (n_sma_max - 4) * (n_sma - 2) / n_sma
                        * n_sma_max / (n_sma_max - 2)) / (1 - b1 ** t)
                    upd = rect.to(p.device) * m / (v.sqrt() + group["eps"])
                elif group["degenerated_to_sgd"]:
                    upd = (1.0 / (1 - b1 ** t)).to(p.device) * m
                else:
                    continue  # the reference skips the whole update, decay too
                if group["weight_decay"] != 0:
                    upd = upd + group["weight_decay"] * p
                p.add_(upd * -group["lr"])
        return loss


class CustomAdam(torch.optim.Optimizer):
    """The reference's ``CustomAdam`` (``dassl/optim/optimizer.py:152-208``,
    JAX ``scale_by_custom_adam``): L2 decay folds into the gradient, the
    moments update only where that gradient is nonzero, and the step
    ``sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)`` applies to every
    entry."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"] != 0:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if "exp_avg" not in state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                t = _count_step(state)
                live = g != 0
                m.copy_(torch.where(live, b1 * m + (1 - b1) * g, m))
                v.copy_(torch.where(live, b2 * v + (1 - b2) * g * g, v))
                factor = (torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)).to(p.device)
                p.add_(factor * m / (v.sqrt() + group["eps"]) * -group["lr"])
        return loss


def staged_lr_labels(params: dict, new_layers) -> Optional[dict]:
    """Label tree for staged learning rates: leaves under a top-level key
    named in ``new_layers`` -> "new", everything else -> "base" (the
    reference splits by ``model.named_children()``, ``optimizer.py:60-75``);
    None when ``new_layers`` names nothing."""
    new = set([new_layers] if isinstance(new_layers, str) else new_layers or [])
    if not new:
        return None

    def label(tree, name):
        if isinstance(tree, dict):
            return {k: label(v, name) for k, v in tree.items()}
        return name

    return {k: label(v, "new" if k in new else "base") for k, v in params.items()}


def _label_leaves(labels) -> List[str]:
    """The labels of a label tree in :func:`param_leaves` order."""
    if isinstance(labels, dict):
        return [tag for key in sorted(labels) for tag in _label_leaves(labels[key])]
    return [labels]


def _param_groups(optim_cfg, params, lr: float):
    """One group over every leaf, or with ``STAGED_LR`` the "base" group at
    ``lr * BASE_LR_MULT`` and the "new" group at ``lr`` (each remembers its
    ratio to the base learning rate as ``lr_mult``)."""
    if not bool(optim_cfg.STAGED_LR):
        return [{"params": param_leaves(params), "lr": lr, "lr_mult": 1.0}]
    labels = staged_lr_labels(params, optim_cfg.NEW_LAYERS) if isinstance(params, dict) else None
    if labels is None:
        raise ValueError("OPTIM.STAGED_LR needs named parameters (a dict) and OPTIM.NEW_LAYERS "
                         "naming their new top-level keys")
    mult = float(optim_cfg.BASE_LR_MULT)
    groups = []
    for name, ratio in (("base", mult), ("new", 1.0)):
        leaves = [leaf for leaf, tag in zip(param_leaves(params), _label_leaves(labels))
                  if tag == name]
        if leaves:
            groups.append({"params": leaves, "lr": lr * ratio, "lr_mult": ratio,
                           "stage": name})
    return groups


def build_optimizer(optim_cfg, params) -> torch.optim.Optimizer:
    """The optimizer ``optim_cfg.NAME`` over ``params`` (a nested dict of
    leaf tensors, or an iterable of them). ``optim_cfg`` is any object with
    the ``OPTIM`` attributes (NAME, LR, WEIGHT_DECAY, MOMENTUM, SGD_NESTEROV,
    RMSPROP_ALPHA, ADAM_BETA1, ADAM_BETA2, STAGED_LR, and with it NEW_LAYERS
    and BASE_LR_MULT)."""
    name = optim_cfg.NAME
    lr = float(optim_cfg.LR)
    wd = float(optim_cfg.WEIGHT_DECAY)
    betas = (float(optim_cfg.ADAM_BETA1), float(optim_cfg.ADAM_BETA2))
    mom = float(optim_cfg.MOMENTUM)
    groups = _param_groups(optim_cfg, params, lr)
    if name in ("adam", "amsgrad"):
        return torch.optim.Adam(
            groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd, amsgrad=name == "amsgrad"
        )
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if name == "sgd":
        return SGD(
            groups, lr=lr, momentum=mom, dampening=0.0, weight_decay=wd,
            nesterov=bool(optim_cfg.SGD_NESTEROV) and mom > 0,
        )
    if name == "rmsprop":
        return torch.optim.RMSprop(
            groups, lr=lr, alpha=float(optim_cfg.RMSPROP_ALPHA), eps=1e-8,
            weight_decay=wd, momentum=mom,
        )
    if name == "radam":
        return RAdam(groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if name == "custom_adam":
        return CustomAdam(groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    raise ValueError(f"unsupported optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set every param group's learning rate (per-epoch stepping), keeping
    the staged groups' ratio to ``lr``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)
    return optimizer
