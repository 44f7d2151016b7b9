"""The mesh: its data and model axes, the shards this process holds, their collectives.

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
then hands each layer its ``[m_local, ...]`` shards unchanged; the packed
towers of the GSPMD route (int8, ``TP_SPLIT_QKV False``) split only their
MLP (:func:`place_packed_mlp`, ``_PACKED_TP_NAMES`` :118).

The data axis (:class:`DataAxis`, the 'data' axis of :func:`build_mesh`
:29) runs the same two ways: **local shards** run each shard's step body
in turn on one device, their all-gather a ``torch.cat`` and their mean a
mean; under a **process group** each rank holds one shard and gathers and
reduces over its data group (NCCL on cards, gloo on the CPU). A
:class:`Mesh` pairs the two axes; its ranks are laid out data-major, as
JAX's ``devices.reshape(data, model)``. The placement helpers of
``ovmr_tpu/parallel/mesh.py:41-115`` become: :func:`shard_batch` (this
process's block of a batch every rank holds), :func:`shard_batch_local`
and :func:`place_local_batch` (the sliced loader's rows as they are),
:func:`to_host` (gathered to every rank), :func:`replicate`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import numpy as np
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


    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering the shards of a column-parallel product: itself
        forward; backward its cotangent summed over the group (Megatron's
        ``f``), so each rank sees the whole gradient of its replicated input."""
        if self.group is not None and torch.is_grad_enabled() and x.requires_grad:
            return _EnterGroup.apply(x, self.group)
        return x

    def reduce_partials(self, partials: Iterable[torch.Tensor]) -> torch.Tensor:
        """:meth:`reduce` for partials that autograd differentiates: summed
        out of place, the group's all-reduce passing the cotangent through
        unchanged (Megatron's ``g``)."""
        parts = list(partials)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        if self.group is None:
            return total
        if torch.is_grad_enabled() and total.requires_grad:
            return _ReduceGroup.apply(total, self.group)
        return self.reduce([total])


class _EnterGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


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


# --------------------------------------------------------------------------
# the data axis
# --------------------------------------------------------------------------

def _gather_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather ``x`` over ``group`` along dim 0, in rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All-gather over a group whose backward is the reduce-scatter (JAX's
    transpose of ``all_gather``): each rank gets the sum over the ranks of
    the cotangent of its own rows. NCCL reduce-scatters; gloo has no
    reduce-scatter, so it all-reduces the whole cotangent and keeps this
    rank's slice (the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_group(x, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        group = ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous()
        if dist.get_backend(group) == "nccl":
            out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g.chunk(n)[r].contiguous(), None


class DataAxis:
    """A data axis of ``size`` shards, of which this process holds
    ``shards`` (in order), gathered and reduced over ``group`` (None: this
    process holds every shard)."""

    def __init__(self, size: int, shards: Tuple[int, ...], group=None):
        if size < 1 or not shards or any(not 0 <= d < size for d in shards):
            raise ValueError(f"shards {shards} of a data axis of size {size}")
        if group is not None and len(shards) != 1:
            raise ValueError("a data axis over a process group holds one shard a rank")
        self.size = size
        self.shards = tuple(shards)
        self.group = group

    @classmethod
    def local(cls, size: int) -> "DataAxis":
        """All ``size`` shards in this process."""
        return cls(size, tuple(range(size)))

    @classmethod
    def from_process_group(cls, group=None) -> "DataAxis":
        """One shard a rank of ``group`` (the default group when None)."""
        import torch.distributed as dist

        ranks, rank = dist.get_world_size(group), dist.get_rank(group)
        if ranks == 1:
            return cls.local(1)
        return cls(ranks, (rank,), group=group if group is not None else dist.group.WORLD)

    def split(self, x, dim: int = 0) -> list:
        """This process's rows of ``x`` in equal blocks, one a local shard."""
        n = len(self.shards)
        if x.shape[dim] % n:
            raise ValueError(f"{x.shape[dim]} rows do not split over {n} local data shards")
        step = x.shape[dim] // n
        return [x.narrow(dim, i * step, step) for i in range(n)]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The rows of every shard of the axis in shard order, from one part
        a local shard: a ``torch.cat``, then (over a group) the all-gather
        whose backward reduce-scatters, so gradients flow back to each
        shard's own rows."""
        out = parts[0] if len(parts) == 1 else torch.cat(list(parts))
        if self.group is not None:
            if torch.is_grad_enabled() and out.requires_grad:
                return _GatherRows.apply(out, self.group)
            return _gather_group(out, self.group)
        return out

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """The all-reduce (SUM) of ``x`` over the group, in place; the local
        shards' own sum is the caller's."""
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


class Mesh:
    """A ``data x model`` mesh: the axes this process holds shards of."""

    def __init__(self, data: DataAxis, model: ModelAxis):
        self.data, self.model = data, model

    @property
    def shape(self) -> dict:
        return {"data": self.data.size, "model": self.model.size}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, local data shards {self.data.shards})"


def build_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ``data x model`` mesh (``build_mesh`` :29). ``data = -1`` takes
    every rank over the model axis (``world // model``). On one process
    every shard is local; under a process group of ``data x model`` ranks
    each rank holds one shard, ranks laid out data-major (rank ``d * model
    + j`` holds data shard d and model shard j), each data row and model
    column with its own group. Any other split raises."""
    from ovmr_tpu_torch.parallel.multihost import rank, world

    n = world()
    model = max(int(model), 1)
    if data == -1:
        data = max(n // model, 1)
    data = int(data)
    if data < 1:
        raise ValueError(f"mesh data axis {data}")
    if n == 1:
        return Mesh(DataAxis.local(data), ModelAxis.local(model))
    if data * model != n:
        raise ValueError(
            f"mesh {data} x {model} = {data * model} shards does not match the "
            f"{n} ranks of the process group: one rank holds one shard")
    import torch.distributed as dist

    r = rank()
    d, j = divmod(r, model)
    # every rank creates every group, in the same order
    rows = [dist.new_group([e * model + k for k in range(model)]) for e in range(data)]
    cols = [dist.new_group([e * model + k for e in range(data)]) for k in range(model)]
    m_axis = ModelAxis(model, (j,), group=rows[d]) if model > 1 else ModelAxis.local(1)
    d_axis = DataAxis(data, (d,), group=cols[j]) if data > 1 else DataAxis.local(1)
    return Mesh(d_axis, m_axis)


def _data_axis(mesh) -> DataAxis:
    return mesh.data if isinstance(mesh, Mesh) else mesh


def shard_batch(mesh, x, axis: int = 0):
    """This process's block of a batch that every rank holds: the rows of
    its data shards (every row with local shards only)."""
    data = _data_axis(mesh)
    if x.shape[axis] % data.size:
        raise ValueError(f"{x.shape[axis]} rows do not shard over a data axis of {data.size}")
    if data.group is None:
        return x
    step = x.shape[axis] // data.size
    d = data.shards[0]
    index = [slice(None)] * x.ndim
    index[axis] = slice(d * step, (d + 1) * step)
    return x[tuple(index)]


def shard_batch_local(mesh, x, axis: int = 0):
    """This process's rows as the sliced loader decoded them: they already
    are its block, and must split over its local shards."""
    data = _data_axis(mesh)
    if x.shape[axis] % len(data.shards):
        raise ValueError(
            f"{x.shape[axis]} local rows do not split over {len(data.shards)} data shards")
    return x


def place_local_batch(mesh, *arrays, axis: int = 0):
    """Guarded placement for sliced-loader batches (each array holds only
    this process's rows): a sliced batch without a mesh cannot be
    assembled and fails loudly (``place_local_batch`` :73)."""
    if mesh is None:
        raise RuntimeError(
            "sliced multi-host batch without a mesh — set CUDA.MESH.DATA "
            "!= 1 or disable CUDA.MULTIHOST_SLICED_LOADER"
        )
    return tuple(shard_batch_local(mesh, a, axis) for a in arrays)


def to_host(mesh, x: torch.Tensor) -> np.ndarray:
    """Each shard's rows of a data-sharded result, gathered to every rank
    in shard order, as numpy."""
    if mesh is not None:
        x = _data_axis(mesh).gather([x])
    return x.detach().cpu().numpy()


def replicate(mesh, tree, device=None):
    """A host tree that every rank holds identically, on this process's
    device (every shard of the process reads the one copy)."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


def map_data_shards(mesh, fn: Callable, *arrays):
    """``fn`` on each local data shard's block of ``arrays`` (their rows
    split over the data axis), the outputs (a tensor or a tuple of them)
    gathered along dim 0 to every rank: the class-sharded seams of
    classifier generation and the eval encode."""
    data = _data_axis(mesh)
    blocks = [data.split(shard_batch(data, a)) for a in arrays]
    outs = [fn(*args) for args in zip(*blocks)]
    if isinstance(outs[0], tuple):
        return tuple(data.gather([o[i] for o in outs]) for i in range(len(outs[0])))
    return data.gather(outs)


# --------------------------------------------------------------------------
# the packed towers' MLP-only split (the GSPMD route)
# --------------------------------------------------------------------------

# packed-qkv towers shard only the Megatron MLP split (``_PACKED_TP_NAMES``
# :120); an int8 c_fc carries its per-column scale with it
PACKED_TP_AXES = {"c_fc_w": 1, "c_fc_b": 0, "c_proj_w": 0, "c_fc_w_scale": 0}


def place_packed_mlp(axis: ModelAxis, params: dict) -> dict:
    """Packed CLIP towers (float or int8) -> this process's shards of each
    block's MLP (c_fc column, c_proj row) stacked ``[L, m_local, ...]``;
    attention, LayerNorm, ``c_proj_b`` and every other leaf stay whole."""
    out = dict(params)
    for tower in ("visual", "text"):
        t = params.get(tower)
        if not (isinstance(t, dict) and isinstance(t.get("blocks"), dict)):
            continue
        blocks = dict(t["blocks"])
        for name, dim in PACKED_TP_AXES.items():
            if name not in blocks:
                continue
            leaf = blocks[name]
            if leaf.shape[1 + dim] % axis.size:
                raise ValueError(f"{tower} {name} of shape {tuple(leaf.shape)} does not split "
                                 f"{axis.size} ways")
            parts = leaf.chunk(axis.size, dim=1 + dim)
            blocks[name] = torch.stack([parts[j] for j in axis.shards], dim=1)
        out[tower] = {**t, "blocks": blocks}
    return out
