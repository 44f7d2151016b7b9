"""Per-epoch learning-rate schedules.

A copy of ``ovmr_tpu/engine/schedule.py`` (plain Python; the port imports
nothing of the JAX package). Closed forms matching the torch scheduler stack the reference uses
(``dassl/optim/lr_scheduler.py:83-152``: cosine / single_step / multi_step,
wrapped by constant or linear warmup). Verified against a torch simulation
of the reference classes across the full grid (three schedulers x two
warmup types x WARMUP_RECOUNT on/off — ``tests/test_schedule_torch_parity.py``).

WARMUP_RECOUNT semantics (``lr_scheduler.py:135-137``): with the default
``True`` the successor restarts at 0 after warmup, so the post-warmup phase
is indexed by ``t = epoch - warmup`` (with 1-epoch constant warmup +
30-epoch cosine: ``[cons, base, 0.5*base*(1+cos(pi*1/30)), ...]``). With
``False`` the successor's ``last_epoch`` is PRESET to ``warmup_epoch``
without recomputing the group lr; torch's recursive ``get_lr`` then
telescopes off the base lr, giving
``base*(1+cos(pi*epoch/T))/(1+cos(pi*warmup/T))`` for cosine, and step
decays triggered by ABSOLUTE epoch index (milestones <= warmup are skipped
— the group lr was never rebased).
"""

from __future__ import annotations

import math
from typing import Sequence


def lr_for_epoch(
    epoch: int,
    base_lr: float,
    max_epoch: int,
    scheduler: str = "cosine",
    stepsize: Sequence[int] | int = (-1,),
    gamma: float = 0.1,
    warmup_epoch: int = -1,
    warmup_type: str = "linear",
    warmup_cons_lr: float = 1e-5,
    warmup_min_lr: float = 1e-5,
    warmup_recount: bool = True,
) -> float:
    warmup = max(warmup_epoch, 0)
    if epoch < warmup:
        if warmup_type == "constant":
            return warmup_cons_lr
        if warmup_type == "linear":
            # reference LinearWarmupScheduler: min_lr at epoch 0, then
            # base * epoch / warmup_epoch
            if epoch == 0:
                return warmup_min_lr
            return base_lr * epoch / warmup
        raise ValueError(f"unknown warmup type {warmup_type!r}")

    if not warmup_recount and warmup > 0:
        # successor.last_epoch preset to warmup_epoch; decays index off the
        # ABSOLUTE epoch and telescope from base (epoch == warmup -> base)
        if scheduler == "cosine":
            return (
                base_lr
                * (1.0 + math.cos(math.pi * epoch / max_epoch))
                / (1.0 + math.cos(math.pi * warmup / max_epoch))
            )
        if scheduler == "single_step":
            step = stepsize[-1] if isinstance(stepsize, (list, tuple)) else stepsize
            if step <= 0:
                step = max_epoch
            n = sum(1 for k in range(warmup + 1, epoch + 1) if k % step == 0)
            return base_lr * (gamma**n)
        if scheduler == "multi_step":
            steps = (
                list(stepsize) if isinstance(stepsize, (list, tuple)) else [stepsize]
            )
            return base_lr * (gamma ** sum(1 for s in steps if warmup < s <= epoch))
        raise ValueError(f"unknown scheduler {scheduler!r}")

    t = epoch - warmup
    if scheduler == "cosine":
        return 0.5 * base_lr * (1.0 + math.cos(math.pi * t / max_epoch))
    if scheduler == "single_step":
        step = stepsize[-1] if isinstance(stepsize, (list, tuple)) else stepsize
        if step <= 0:
            step = max_epoch
        return base_lr * (gamma ** (t // step))
    if scheduler == "multi_step":
        steps = list(stepsize) if isinstance(stepsize, (list, tuple)) else [stepsize]
        return base_lr * (gamma ** sum(1 for s in steps if t >= s))
    raise ValueError(f"unknown scheduler {scheduler!r}")


def lr_schedule_from_cfg(optim_cfg) -> list:
    """Materialize the whole per-epoch lr table from an OPTIM config node."""
    return [
        lr_for_epoch(
            e,
            base_lr=optim_cfg.LR,
            max_epoch=optim_cfg.MAX_EPOCH,
            scheduler=optim_cfg.LR_SCHEDULER,
            stepsize=optim_cfg.STEPSIZE,
            gamma=optim_cfg.GAMMA,
            warmup_epoch=optim_cfg.WARMUP_EPOCH,
            warmup_type=optim_cfg.WARMUP_TYPE,
            warmup_cons_lr=optim_cfg.WARMUP_CONS_LR,
            warmup_min_lr=optim_cfg.WARMUP_MIN_LR,
            warmup_recount=bool(optim_cfg.WARMUP_RECOUNT),
        )
        for e in range(optim_cfg.MAX_EPOCH)
    ]
