"""The port's DA trainers end to end on the CPU, their checkpoints across
the two packages, and the data axis.

- SourceOnly, DANN, ADDA, AdaBN, MCD, MME, SE, M3SDA, DAEL and CDAC through
  ``build_trainer`` -> ``train()`` -> ``test()`` on ``SyntheticDA`` at 32x32
  (template: ``tests/test_dassl_trainers.py:125-252``); ADDA and AdaBN start
  from the checkpoint a SourceOnly run wrote, and AdaBN moves no parameter.
- A DANN run (two models: the model and its critic) saved by the port
  resumes in the JAX package, and the JAX run's next checkpoint in the port;
  saved through ``CUDA.CHECKPOINT_BACKEND orbax`` it resumes in the port.
- DANN on 2 local data shards (``CUDA.MESH.DATA 2``) equals the single
  program, and two gloo ranks, one shard each, equal it too (templates:
  ``tests/test_dassl_mesh.py:75``, ``tests/test_torch_dg_trainers.py``); so
  do M3SDA, DAEL and CDAC, whose losses span the whole batch (domain groups
  cut by the ranks' blocks, moments, pairwise similarities), with dropout in
  their heads, and M3SDA's domain groups that do not split evenly; each
  one's rank-local control misses the gates.
"""

import os
import os.path as osp
import pathlib
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.trainer import build_trainer
from tests.test_torch_dg_trainers import (
    FLOAT64_CASES,
    _assert_ranks_hold,
    _assert_states_equal,
    _flat,
    _jax_trainer,
    domain_batches,
    gate_readings,
    make_cfg,
    rank_local,
    trainer_leaves,
)


class _NoWriter:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """4 classes x 8 images at 32px (train 16, val 8 = the target pool, test
    8), one intra-op thread, and no tensorboard writer."""
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    monkeypatch.setattr(trainer_mod.TrainerBase, "init_writer",
                        lambda self: setattr(self, "_writer", _NoWriter()) or self._writer)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DOMAIN_GROUPS = {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
                 "DATALOADER.TRAIN_X.N_DOMAIN": 2, "DATALOADER.TRAIN_U.SAME_AS_X": False,
                 "DATALOADER.TRAIN_U.BATCH_SIZE": 8}
TRAINERS = {
    "SourceOnly": ({}, ["model"]),
    "DANN": ({}, ["model", "critic"]),
    "MCD": ({"TRAINER.MCD.N_STEP_F": 2}, ["F", "C1", "C2"]),
    "MME": ({}, ["F", "C"]),
    "SE": ({"DATALOADER.K_TRANSFORMS": 2}, ["model"]),
    "M3SDA": ({**DOMAIN_GROUPS, "TRAINER.M3SDA.N_STEP_F": 2}, ["F", "C"]),
    "DAEL": ({**DOMAIN_GROUPS, "TRAINER.DAEL.STRONG_TRANSFORMS": ("random_flip", "cutout",
                                                                  "randaugment2", "normalize")},
             ["F", "E"]),
    "CDAC": ({"DATALOADER.K_TRANSFORMS": 2,
              "TRAINER.CDAC.STRONG_TRANSFORMS": ("random_flip", "cutout", "normalize")},
             ["F", "C"]),
}


def _record_steps(trainer):
    steps = []
    orig = trainer.forward_backward_xu
    trainer.forward_backward_xu = lambda bx, bu: steps.append(orig(bx, bu)) or steps[-1]
    return steps


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_trains_and_tests(tmp_path, name):
    overrides, models = TRAINERS[name]
    trainer = build_trainer(make_cfg(tmp_path, name, **overrides))
    assert trainer.get_model_names() == models
    steps = _record_steps(trainer)
    trainer.train()  # one epoch, then test()
    assert len(steps) == 2 and all(np.isfinite(out["loss"]) for out in steps)
    assert 0.0 <= trainer.test() <= 100.0
    batch = next(iter(trainer.dm.test_loader))
    out = trainer.model_inference(batch)
    assert out.shape == (len(batch["label"]), trainer.num_classes) and np.isfinite(out).all()
    if name in ("M3SDA", "DAEL"):  # ensembles of probabilities
        np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)
    for model in models:
        assert osp.isfile(osp.join(trainer.output_dir, model, "model-1.npz"))


@pytest.mark.parametrize("name", ["ADDA", "AdaBN"])
def test_adapters_start_from_a_source_only_checkpoint(tmp_path, name):
    source = build_trainer(make_cfg(tmp_path / "src", "SourceOnly", **{"TEST.NO_TEST": True}))
    source.train()
    weights = osp.join(source.output_dir, "model", "model-1.npz")
    with pytest.raises(AssertionError, match="source model"):
        build_trainer(make_cfg(tmp_path, name))
    trainer = build_trainer(make_cfg(tmp_path, name, **{"MODEL.INIT_WEIGHTS": weights}))
    _assert_states_equal(trainer.model_state(), source.model_state())
    before = _flat(trainer.model_state())
    steps = _record_steps(trainer)
    trainer.train()
    after = _flat(trainer.model_state())
    assert len(steps) == 2
    if name == "AdaBN":  # the statistics are re-estimated; no parameter moves
        assert steps == [None, None]
        for key in before:
            if key.startswith("params/"):
                np.testing.assert_array_equal(after[key], before[key], err_msg=key)
        assert not np.array_equal(after["batch_stats/head/bn0/mean"],
                                  before["batch_stats/head/bn0/mean"])
    else:  # the target model moves; its classifier and the source copy do not
        assert all(np.isfinite(out["loss"]) for out in steps)
        for key in ("params/classifier/kernel", "params/classifier/bias"):
            np.testing.assert_array_equal(after[key], before[key], err_msg=key)
        assert not np.array_equal(after["params/backbone/conv1/kernel"],
                                  before["params/backbone/conv1/kernel"])
        from ovmr_tpu_torch.convert import dassl_state_to_numpy

        _assert_states_equal(dassl_state_to_numpy(trainer.source_net), source.model_state())


def test_dann_checkpoints_resume_across_the_packages(tmp_path):
    """The port's epoch-1 DANN checkpoint (model and critic) resumes in JAX
    and JAX's epoch-2 one in the port: states equal bit for bit, and the
    second epoch agrees."""
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    kw = {"TRAIN.CHECKPOINT_FREQ": 1, "TEST.NO_TEST": True,
          "DATALOADER.TRAIN_X.SAMPLER": "SequentialSampler"}
    two = {**kw, "OPTIM.MAX_EPOCH": 2}
    port = build_trainer(make_cfg(tmp_path / "p", "DANN", **kw))
    port.train()
    shutil.copytree(tmp_path / "p", tmp_path / "q")
    jax_t = _jax_trainer(make_cfg(tmp_path / "p", "DANN", make=j_cfg, **two))
    assert jax_t.resume_model_if_exist(str(tmp_path / "p" / "out")) == 1
    for model in ("model", "critic"):
        _assert_states_equal(port.model_state(model), jax_t._models[model])
    jax_t.train()  # writes its epoch-2 checkpoint beside the port's epoch-1 one
    resumed = build_trainer(make_cfg(tmp_path / "q", "DANN", **two))
    resumed.train()
    assert resumed.start_epoch == 1
    for model in ("model", "critic"):
        _assert_states_equal(resumed.model_state(model), jax_t._models[model], atol=2e-4)
    # JAX's checkpoint resumes in the port
    port2 = build_trainer(make_cfg(tmp_path / "p", "DANN", **two))
    assert port2.resume_model_if_exist(str(tmp_path / "p" / "out")) == 2
    for model in ("model", "critic"):
        _assert_states_equal(port2.model_state(model), jax_t._models[model])


def test_dassl_orbax_refusal_names_item_8(tmp_path):
    """The orbax refusal (ROADMAP Queue 1 item 8) is lifted: DANN's two
    models save through ``CUDA.CHECKPOINT_BACKEND orbax`` to the npz run's
    state and resume from it, optimizer state included, bit for bit."""
    from tests.test_torch_ssl_trainers import dassl_orbax_round_trip

    resumed = dassl_orbax_round_trip(tmp_path, make_cfg, "DANN")
    assert resumed.get_model_names() == ["model", "critic"]


# --------------------------------------------------------------------------
# the data axis
# --------------------------------------------------------------------------

def _two_steps(trainer):
    trainer.epoch, trainer.max_epoch, trainer.num_batches = 0, 2, 2
    trainer.before_epoch()
    rng = np.random.default_rng(3)
    for trainer.batch_idx in range(2):
        batch_x = {"img": rng.standard_normal((8, 3, 32, 32)).astype(np.float32),
                   "label": rng.integers(0, 4, 8)}
        batch_u = {"img": rng.standard_normal((8, 3, 32, 32)).astype(np.float32),
                   "label": np.zeros(8, np.int64)}
        out = trainer.forward_backward_xu(batch_x, batch_u)
    return out, {m: trainer.model_state(m) for m in trainer.get_model_names()}


def test_dann_on_local_data_shards_equals_one_program(tmp_path):
    from ovmr_tpu_torch.engine import da
    from tests.test_torch_dg_trajectory import replay_trainer

    results = []
    for data in (1, 2):
        cfg = make_cfg(tmp_path, "DANN", **{"CUDA.MESH.DATA": data})
        torch.manual_seed(0)  # one init for both runs
        trainer = replay_trainer(da.DANN, cfg)
        assert (trainer.mesh is None) == (data == 1)
        results.append(_two_steps(trainer))
    (out1, s1), (out2, s2) = results
    for key in ("loss_x", "loss_d"):
        assert out1[key] == pytest.approx(out2[key], rel=1e-5)
    a, b = _flat(s1), _flat(s2)
    assert any("batch_stats/" in k for k in a)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=k)


def _xu_steps(trainer, batches):
    trainer.epoch, trainer.max_epoch, trainer.num_batches = 0, 2, len(batches)
    trainer.before_epoch()
    for trainer.batch_idx, (batch_x, batch_u) in enumerate(batches):
        out = trainer.forward_backward_xu(batch_x, batch_u)
    return out, trainer_leaves(trainer)


def _target(rng, rows):
    return {"img": rng.standard_normal((rows, 3, 32, 32)).astype(np.float32),
            "img2": rng.standard_normal((rows, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 4, rows)}


def _grouped_batches(n_domain, split):
    rng = np.random.default_rng(5)
    return [(x, _target(rng, 8)) for x in domain_batches(n_domain, split)]


def _paired_batches():
    """CDAC's batches: 8 items of two adjacent views a batch."""
    rng = np.random.default_rng(5)

    def views(batch):
        return {k: np.repeat(v, 2, axis=0) for k, v in batch.items()}

    return [(views(_target(rng, 8)), views(_target(rng, 8))) for _ in range(2)]


LIVE_HEAD = {"MODEL.HEAD.DROPOUT": 0.5}  # the heads' dropout draws per global row
# case -> (trainer, overrides, source domains, batches); three groups of 4
# rows cut by the ranks' blocks of 6, or two of 3 that do not split evenly
WHOLE_BATCH = {
    "M3SDA": ("M3SDA", {**TRAINERS["M3SDA"][0], "DATALOADER.TRAIN_X.N_DOMAIN": 3,
                        "DATALOADER.TRAIN_X.BATCH_SIZE": 12}, 3, lambda: _grouped_batches(3, 4)),
    "M3SDA-uneven": ("M3SDA", {**TRAINERS["M3SDA"][0], "DATALOADER.TRAIN_X.BATCH_SIZE": 6}, 2,
                     lambda: _grouped_batches(2, 3)),
    "DAEL": ("DAEL", {**TRAINERS["DAEL"][0], "DATALOADER.TRAIN_X.N_DOMAIN": 3,
                      "DATALOADER.TRAIN_X.BATCH_SIZE": 12, "TRAINER.DAEL.CONF_THRE": 0.3}, 3,
             lambda: _grouped_batches(3, 4)),
    "CDAC": ("CDAC", {**TRAINERS["CDAC"][0], "TRAINER.CDAC.P_THRESH": 0.3}, 2, _paired_batches),
}
CONTROLS = ("M3SDA", "DAEL", "CDAC")


def _whole_batch_case(tmp, case, control=False):
    from ovmr_tpu_torch.engine import da
    from tests.test_torch_da_trajectory import _float64_trainers
    from tests.test_torch_dg_trajectory import replay_trainer

    name, overrides, n_src, batches = WHOLE_BATCH[case]
    torch.manual_seed(0)  # one init for every run
    with _float64_trainers(case in FLOAT64_CASES):
        trainer = replay_trainer(getattr(da, name), make_cfg(tmp, name, **overrides, **LIVE_HEAD),
                                 num_source_domains=n_src)
        return _xu_steps(rank_local(trainer) if control else trainer, batches())


def _gloo_rank(rank, world, tmp):
    os.environ.update(OVMR_COORDINATOR=f"file://{tmp}/rendezvous", OVMR_NUM_PROCESSES=str(world),
                      OVMR_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    torch.manual_seed(0)  # each rank builds its nets after the same seed
    import torch.distributed as dist

    from ovmr_tpu_torch.engine import da
    from ovmr_tpu_torch.parallel import maybe_initialize_distributed
    from tests.test_torch_dg_trajectory import replay_trainer

    path = pathlib.Path(tmp)
    assert maybe_initialize_distributed("cpu")
    try:
        trainer = replay_trainer(da.DANN, make_cfg(path, "DANN"))
        assert trainer.axis.group is not None and trainer.loss_scale == 0.5
        out, state = _two_steps(trainer)
        runs = {case: _whole_batch_case(path, case) for case in WHOLE_BATCH}
        controls = {case: _whole_batch_case(path, case, control=True) for case in CONTROLS}
        torch.save({"out": out, "state": state, "runs": runs, "controls": controls},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """The one-process runs, then one spawn of two gloo ranks running them
    again: DANN, M3SDA, DAEL and CDAC, and the controls."""
    from ovmr_tpu_torch.engine import da
    from tests.test_torch_dg_trajectory import replay_trainer

    tmp = tmp_path_factory.mktemp("gloo")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.manual_seed(0)
        dann = _two_steps(replay_trainer(da.DANN, make_cfg(tmp, "DANN")))
        refs = {case: _whole_batch_case(tmp, case) for case in WHOLE_BATCH}
        mp.spawn(_gloo_rank, args=(2, str(tmp)), nprocs=2, join=True)
    finally:
        torch.set_num_threads(threads)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"dann": dann, "refs": refs, "ranks": ranks}


def test_dann_two_gloo_ranks_equal_one_program(gloo_runs):
    """One data shard a rank: the global BN statistics of the model and the
    critic, the row-mean losses' share and the summed gradients give the
    single program's update on both ranks."""
    out1, s1 = gloo_runs["dann"]
    a = _flat(s1)
    for rank, got in enumerate(gloo_runs["ranks"]):
        for key in ("loss_x", "loss_d", "acc_x"):
            assert got["out"][key] == pytest.approx(out1[key], rel=1e-5), key
        b = _flat(got["state"])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", sorted(WHOLE_BATCH))
def test_whole_batch_da_trainers_on_two_gloo_ranks_equal_one_program(gloo_runs, case):
    """Each rank forwards its rows of every domain group and its block of
    the target batch; the moments (M3SDA) and the pairs (CDAC) take every
    rank's rows through the gather, the pseudo-label counts are summed: both
    ranks take the single program's step, logged values within rel 1e-5 and
    every params, batch_stats and optimizer leaf within 1e-4."""
    _assert_ranks_hold(gloo_runs["refs"][case], [r["runs"][case] for r in gloo_runs["ranks"]])


@pytest.mark.parametrize("case", CONTROLS)
def test_whole_batch_da_rank_local_controls_fail_the_gates(gloo_runs, case):
    """The controls: moments, similarities and domain groups over each
    rank's own block miss the gates the cross-rank steps meet."""
    for got in gloo_runs["ranks"]:
        assert max(gate_readings(gloo_runs["refs"][case], got["controls"][case])) > 1
