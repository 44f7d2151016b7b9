"""The data axis over a process group: two gloo ranks, one data shard each.

Each rank joins the group the way ``python -m ovmr_tpu_torch.train`` does
(``parallel.multihost.maybe_initialize_distributed`` from the
``OVMR_COORDINATOR`` variables, here a ``file://`` rendezvous under the
test's temporary directory, so that parallel test workers never share a
port), then:

- the autograd all-gather of ``DataAxis.gather`` on gloo (all-reduce, then
  this rank's slice, in its backward) against the local shards'
  ``torch.cat``, exactly;
- MM_CLS_OP for one epoch of two steps over ``Synthetic`` with the sliced
  loader (each rank decodes its own class groups): both ranks' losses
  equal, and equal to the one-process run at ``CUDA.MESH.DATA 2`` (local
  shards) within 1e-5; the aggregator and the adam state equal bit for bit
  across the ranks; the npz checkpoint written by rank 0 alone; classifier
  generation gathered to both ranks;
- the same epoch with ``CUDA.CHECKPOINT_BACKEND "orbax"``, saved on both
  ranks and resumed by a second trainer on both, bit for bit;
- four ranks as data 2 x model 2: the sliced rows by data coordinate, the
  TP block's reduce over each model group, against the local shards.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.trainer import build_trainer
from ovmr_tpu_torch.parallel import DataAxis
from ovmr_tpu_torch.utils import get_cfg_default


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the TINY tensors gain nothing from more,
    and under the suite's parallel workers the spinning thread pools of
    each worker slow every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _NoWriter:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass


def _cfg(root, out, backend="npz", data=-1, epochs=1):
    cfg = get_cfg_default()
    cfg.OUTPUT_DIR, cfg.SEED = out, 1
    cfg.DATASET.ROOT, cfg.DATASET.NAME, cfg.DATASET.NUM_SHOTS = root, "Synthetic", 4
    cfg.INPUT.SIZE, cfg.INPUT.TRANSFORMS = (32, 32), ["normalize"]
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TRAIN_X.N_INS = 16, 4
    cfg.DATALOADER.TEST.BATCH_SIZE, cfg.DATALOADER.NUM_WORKERS = 8, 2
    cfg.MODEL.BACKBONE.NAME, cfg.TRAINER.NAME, cfg.TRAINER.COCOOP.N_CTX = "TINY", "MM_CLS_OP", 2
    cfg.OPTIM.MAX_EPOCH, cfg.TRAIN.CHECKPOINT_FREQ, cfg.TEST.NO_TEST = epochs, 1, True
    cfg.CUDA.DTYPE, cfg.CUDA.DEVICE, cfg.CUDA.MESH.DATA = "float32", "cpu", data
    cfg.CUDA.CHECKPOINT_BACKEND = backend
    return cfg


def _train(cfg):
    """One run: the trainer, its losses and the sliced rows it saw."""
    return _train_with(build_trainer(cfg))


def _state(trainer):
    return {"params": {k: v.detach().clone() for k, v in ckpt.named_leaves(trainer.agg_params)},
            "opt": ckpt.optimizer_state_arrays(trainer.optimizer, trainer.agg_params)}


def _gather_case(rank):
    """Forward and backward of the gather of two ranks' rows, each rank
    weighting the gathered rows by its own cotangent."""
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(rank)).requires_grad_(True)
    w = torch.randn(6, 4, generator=torch.Generator().manual_seed(10 + rank))
    return x, w


def _rank(rank, world, tmp):
    os.environ.update(OVMR_COORDINATOR=f"file://{tmp}/rendezvous", OVMR_NUM_PROCESSES=str(world),
                      OVMR_PROCESS_ID=str(rank), OVMR_SYNTHETIC="8,8,32")
    torch.set_num_threads(1)
    from ovmr_tpu_torch.parallel import maybe_initialize_distributed

    assert maybe_initialize_distributed("cpu")
    assert not maybe_initialize_distributed("cpu")  # a group exists: no-op
    import torch.distributed as dist

    try:
        out = {}
        axis = DataAxis.from_process_group()
        x, w = _gather_case(rank)
        y = axis.gather([x])
        (y * w).sum().backward()
        out["gather"] = (y.detach(), x.grad)

        trainer_mod.TrainerBase.init_writer = lambda self: _NoWriter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            trainer, seen = _train(_cfg(f"{tmp}/data", f"{tmp}/npz_run"))
            out["classifiers"] = trainer.generate_classifiers()
        out["npz_saved"] = "Checkpoint saved to" in log.getvalue()
        out["seen"], out["npz"] = seen, _state(trainer)

        first, _ = _train(_cfg(f"{tmp}/data", f"{tmp}/orbax_run", "orbax"))
        second = build_trainer(_cfg(f"{tmp}/data", f"{tmp}/orbax_run", "orbax", epochs=2))
        out["resumed_epoch"] = second.resume_model_if_exist(f"{tmp}/orbax_run")
        out["orbax"], out["orbax_resumed"] = _state(first), _state(second)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_train_as_the_local_shards(tmp_path, monkeypatch):
    monkeypatch.setenv("OVMR_SYNTHETIC", "8,8,32")
    monkeypatch.setattr(trainer_mod.TrainerBase, "init_writer", lambda self: _NoWriter())
    # the one-process run at two local data shards (it also writes the data)
    local, local_seen = _train(_cfg(str(tmp_path / "data"), str(tmp_path / "local"), data=2))
    assert local.mesh.shape == {"data": 2, "model": 1} and len(local_seen) == 2
    local_cls = local.generate_classifiers()

    mp.spawn(_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    # the gloo gather and its backward against the local shards' cat
    xs = [_gather_case(r)[0] for r in range(2)]
    y = DataAxis.local(2).gather(xs)
    sum((y * _gather_case(r)[1]).sum() for r in range(2)).backward()
    for r, got in enumerate(ranks):
        assert torch.equal(got["gather"][0], y.detach())
        assert torch.equal(got["gather"][1], xs[r].grad)

    # each rank decoded its own 8 rows of every 16-row batch
    for got in ranks:
        assert [(local_, n) for _, local_, n in got["seen"]] == [(True, 8), (True, 8)]
    losses = [[loss for loss, _, _ in got["seen"]] for got in ranks]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], [loss for loss, _, _ in local_seen], atol=1e-5, rtol=0)
    # replicated state, bit for bit across the ranks; the local run within 1e-5
    for kind in ("npz", "orbax", "orbax_resumed"):
        a, b = ranks[0][kind], ranks[1][kind]
        for key in a["params"]:
            assert torch.equal(a["params"][key], b["params"][key]), (kind, key)
        for key in a["opt"]:
            np.testing.assert_array_equal(a["opt"][key], b["opt"][key], err_msg=f"{kind} {key}")
    for key, leaf in ckpt.named_leaves(local.agg_params):
        np.testing.assert_allclose(ranks[0]["npz"]["params"][key].numpy(),
                                   leaf.detach().numpy(), atol=1e-5, rtol=0, err_msg=key)
    # npz: rank 0 writes, rank 1 does not
    assert [got["npz_saved"] for got in ranks] == [True, False]
    assert (tmp_path / "npz_run" / "prompt_learner" / "model-1.npz").is_file()
    # orbax: saved on both ranks, resumed on both, bit for bit
    assert (tmp_path / "orbax_run" / "prompt_learner" / "checkpoint_orbax").read_text() == \
        "orbax-1"
    for got in ranks:
        assert got["resumed_epoch"] == 1
        for key, value in got["orbax"]["params"].items():
            assert torch.equal(got["orbax_resumed"]["params"][key], value), key
        for key, value in got["orbax"]["opt"].items():
            np.testing.assert_array_equal(got["orbax_resumed"]["opt"][key], value, err_msg=key)
    # classifier generation sharded over the ranks and gathered to both
    for got in ranks:
        for key in ("mm_classifier", "vision_classifier", "text_classifier"):
            np.testing.assert_allclose(got["classifiers"][key], local_cls[key], atol=1e-5,
                                       rtol=0, err_msg=key)


def _rank_4(rank, world, tmp):
    """A rank of a data 2 x model 2 mesh of four gloo ranks: one MM_CLS_OP
    epoch at TINY_TP (the TP block, K7/K8's plain twins, reduced over the
    model group), its losses, rows and state."""
    os.environ.update(OVMR_COORDINATOR=f"file://{tmp}/rendezvous4",
                      OVMR_NUM_PROCESSES=str(world), OVMR_PROCESS_ID=str(rank),
                      OVMR_SYNTHETIC="8,8,32")
    torch.set_num_threads(1)
    from ovmr_tpu_torch.parallel import maybe_initialize_distributed

    assert maybe_initialize_distributed("cpu")
    import torch.distributed as dist

    try:
        trainer_mod.TrainerBase.init_writer = lambda self: _NoWriter()
        cfg = _cfg(f"{tmp}/data", f"{tmp}/dm_run{rank}", data=2)
        cfg.CUDA.MESH.MODEL, cfg.MODEL.BACKBONE.NAME = 2, "TINY_TP"
        indices = []
        trainer = build_trainer(cfg)
        orig = trainer.forward_backward
        trainer.forward_backward = lambda batch: indices.append(batch["index"].tolist()) or \
            orig(batch)
        trainer, seen = _train_with(trainer)
        torch.save({"seen": seen, "indices": indices, "state": _state(trainer),
                    "mesh": (trainer.mesh.shape, trainer.mesh.data.shards,
                             trainer.mesh.model.shards, trainer._tp)},
                   f"{tmp}/dm_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _train_with(trainer):
    seen, orig = [], trainer.forward_backward

    def recording(batch):
        out = orig(batch)
        seen.append((out["loss"], bool(batch.get("_local", False)), len(batch["img"])))
        return out

    trainer.forward_backward = recording
    trainer._writer = _NoWriter()
    trainer.train()
    return trainer, seen


def test_four_gloo_ranks_train_data_by_model_as_the_local_shards(tmp_path, monkeypatch):
    """Data 2 x model 2 over four gloo ranks (data-major: ranks 0-1 are
    data shard 0, ranks 2-3 data shard 1): the ranks of one data row decode
    the same rows, every rank's losses and state are equal, and they match
    the one-process run on 2 x 2 local shards within 1e-5."""
    monkeypatch.setenv("OVMR_SYNTHETIC", "8,8,32")
    monkeypatch.setattr(trainer_mod.TrainerBase, "init_writer", lambda self: _NoWriter())
    cfg = _cfg(str(tmp_path / "data"), str(tmp_path / "local"), data=2)
    cfg.CUDA.MESH.MODEL, cfg.MODEL.BACKBONE.NAME = 2, "TINY_TP"
    local, local_seen = _train_with(build_trainer(cfg))
    assert local.mesh.shape == {"data": 2, "model": 2} and local._tp == "pallas"

    mp.spawn(_rank_4, args=(4, str(tmp_path)), nprocs=4, join=True)
    ranks = [torch.load(tmp_path / f"dm_rank{r}.pt", weights_only=False) for r in range(4)]
    for r, got in enumerate(ranks):
        assert got["mesh"] == ({"data": 2, "model": 2}, (r // 2,), (r % 2,), "pallas")
        assert [(loc, n) for _, loc, n in got["seen"]] == [(True, 8), (True, 8)]
    # the sliced rows follow the data coordinate, not the rank
    assert ranks[0]["indices"] == ranks[1]["indices"] != ranks[2]["indices"] == \
        ranks[3]["indices"]
    losses = [[loss for loss, _, _ in got["seen"]] for got in ranks]
    assert losses[0] == losses[1] == losses[2] == losses[3]
    np.testing.assert_allclose(losses[0], [loss for loss, _, _ in local_seen], atol=1e-5, rtol=0)
    for got in ranks[1:]:
        for key, value in ranks[0]["state"]["params"].items():
            assert torch.equal(got["state"]["params"][key], value), key
    for key, leaf in ckpt.named_leaves(local.agg_params):
        np.testing.assert_allclose(ranks[0]["state"]["params"][key].numpy(),
                                   leaf.detach().numpy(), atol=1e-5, rtol=0, err_msg=key)
