"""The model axis: its size, the shards this process holds, and the reduce.

Counterpart of the 'model' axis of ``ovmr_tpu/parallel/mesh.py``. On the
TPU each chip of the mesh holds one shard of every split block leaf and the
per-chip partials are ``psum``'d over 'model'. Here a :class:`ModelAxis` of
size m runs in one of two ways, through one code path:

- **local shards** (:meth:`ModelAxis.local`): one process holds all m shards
  on one device; each block runs its per-shard kernels once per shard and
  sums the fp32 partials in shard order. This is the all-reduce written as a
  sum: it launches exactly the per-shard kernels, at exactly the per-shard
  shapes, that an m-card run launches (the port's counterpart of the virtual
  CPU mesh the JAX package tests its TP route on);
- **process group** (:meth:`ModelAxis.from_process_group`): with
  ``torch.distributed`` initialised each rank holds its one shard, and the
  partial is then ``all_reduce``'d (SUM) over the group: NCCL on cards,
  gloo on the CPU.

Placement (:func:`place_tower_params`, the counterpart of
``tower_param_shardings``/``place_tower_params`` :172-197 and of the
PartitionSpecs of ``_tp_pspec``/``clip_pspecs`` :132-169): every split
block leaf named in ``ops.block_fused_tp.TP_BLOCK_AXES`` is cut m ways along
its dimension and this process's shards are stacked into
``[L, m_local, ...]``; every other leaf stays whole. ``models.clip.run_blocks``
then hands each layer its ``[m_local, ...]`` shards unchanged. The data axis
and multi-host placement come with the data-parallel work.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from ovmr_tpu_torch.ops.block_fused_tp import TP_BLOCK_AXES


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class ModelAxis:
    """A model axis of ``size`` shards, of which this process holds
    ``shards`` (in order), reduced over ``group`` (None: this process holds
    every shard)."""

    def __init__(self, size: int, shards: Tuple[int, ...], group=None):
        if size < 1 or not shards or any(not 0 <= j < size for j in shards):
            raise ValueError(f"shards {shards} of a model axis of size {size}")
        self.size = size
        self.shards = tuple(shards)
        self.group = group

    @classmethod
    def local(cls, size: int) -> "ModelAxis":
        """All ``size`` shards in this process, summed locally."""
        return cls(size, tuple(range(size)))

    @classmethod
    def from_process_group(cls, group=None) -> "ModelAxis":
        """One shard a rank of ``group`` (the default group when None): an
        axis of the group's size, this rank holding the shard of its rank."""
        import torch.distributed as dist

        ranks, rank = dist.get_world_size(group), dist.get_rank(group)
        if ranks == 1:
            return cls.local(1)
        return cls(ranks, (rank,), group=group if group is not None else dist.group.WORLD)

    def reduce(self, partials: Iterable[torch.Tensor]) -> torch.Tensor:
        """The sum over the whole axis of one partial per local shard: added
        in shard order into the first partial (in place: the partials are
        fresh tensors), then all-reduced over the group."""
        total = None
        for part in partials:
            total = part if total is None else total.add_(part)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total


def shard_block(blocks: dict, axis: ModelAxis, stacked: bool = True) -> dict:
    """This process's shards of one tower's split-qkv blocks: each leaf of
    :data:`TP_BLOCK_AXES` that is split becomes ``[L, m_local, ...]``
    (``[m_local, ...]`` for one unstacked layer); the others pass through."""
    lead = 1 if stacked else 0
    out = {}
    for name, leaf in blocks.items():
        dim = TP_BLOCK_AXES[name]
        if dim is None:
            out[name] = leaf
            continue
        dim += lead
        if leaf.shape[dim] % axis.size:
            raise ValueError(
                f"{name} of shape {tuple(leaf.shape)} does not split {axis.size} ways along "
                f"dim {dim}; pad the heads with split_clip_qkv(params, {axis.size}, cfg)"
            )
        parts = leaf.chunk(axis.size, dim=dim)
        out[name] = torch.stack([parts[j] for j in axis.shards], dim=lead)
    return out


def place_tower_params(axis: ModelAxis, params: dict) -> dict:
    """Split-layout CLIP params (``ops.block_fused_tp.split_clip_qkv``) ->
    this process's shards of both towers' blocks; every other leaf is kept
    as it is (replicated)."""
    out = dict(params)
    for tower in ("visual", "text"):
        t = params.get(tower)
        if isinstance(t, dict) and isinstance(t.get("blocks"), dict):
            if "w_q" not in t["blocks"]:
                raise ValueError(f"{tower} blocks are packed; split them with split_clip_qkv first")
            out[tower] = {**t, "blocks": shard_block(t["blocks"], axis)}
    return out
