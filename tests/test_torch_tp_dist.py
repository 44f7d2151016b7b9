"""The model axis over a process group: two gloo ranks, one shard each.

Each rank initialises ``torch.distributed`` (gloo, a rendezvous file under
the test's temporary directory, so that parallel test workers never share
a port), holds its own shard of a TINY_TP layer
(``ModelAxis.from_process_group``) and runs the TP block forward and
backward; the partials are all-reduced over the group. Output, dx and the
weight gradients must equal the local-shard run at model axis 2 exactly in
fp32: with two ranks the all-reduce adds the same two partials the local
sum adds.
"""

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.ops import block_fused_tp as ttp
from ovmr_tpu_torch.ops.layers import causal_mask
from ovmr_tpu_torch.parallel import ModelAxis, shard_block

N_HEAD = 2


def _inputs():
    p = {k: v[0] for k, v in tclip.init_params(tclip.TINY_TP, seed=1)["text"]["blocks"].items()}
    g = torch.Generator().manual_seed(2)
    for k in ("b_qkv", "b_out", "c_fc_b", "c_proj_b", "ln_1_bias", "ln_2_bias"):
        p[k] = 0.05 * torch.randn(p[k].shape, generator=g)
    x = torch.randn(3, 17, 64, generator=g)
    cot = torch.randn(3, 17, 64, generator=g)
    return ttp.split_qkv_blocks(p), x, cot


def _run(axis):
    """Forward and backward of the TP block over ``axis``'s shards."""
    torch.set_num_threads(1)
    split, x, cot = _inputs()
    leaves = {k: v.requires_grad_(True)
              for k, v in shard_block(split, axis, stacked=False).items()}
    x = x.requires_grad_(True)
    out = ttp.make_tp_block(axis)(x, leaves, N_HEAD, causal_mask(17))
    (out * cot).sum().backward()
    return {"out": out.detach(), "dx": x.grad,
            **{f"d_{k}": v.grad for k, v in leaves.items()}}


def _rank(rank, world, init_file, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        axis = ModelAxis.from_process_group()
        assert axis.size == world and axis.shards == (rank,) and axis.group is not None
        torch.save(_run(axis), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_equal_the_local_shards(tmp_path):
    mp.spawn(_rank, args=(2, str(tmp_path / "rendezvous"), str(tmp_path)), nprocs=2, join=True)
    threads = torch.get_num_threads()
    try:
        local = _run(ModelAxis.local(2))
    finally:
        torch.set_num_threads(threads)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    for key, want in local.items():
        split_leaf = key[2:] in ttp.TP_KEYS and ttp.TP_BLOCK_AXES[key[2:]] is not None
        for r, got in enumerate(ranks):
            # a rank holds its own shard's cotangent of a split leaf
            expect = want[r : r + 1] if split_leaf else want
            assert torch.equal(got[key], expect), (key, r)
