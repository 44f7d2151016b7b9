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
  ``tests/test_dassl_mesh.py:75``, ``tests/test_torch_dg_trainers.py``);
  under the process group M3SDA, DAEL and CDAC refuse, naming ROADMAP item 8.
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
from tests.test_torch_dg_trainers import _assert_states_equal, _flat, _jax_trainer, make_cfg


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


def _gloo_rank(rank, world, tmp):
    os.environ.update(OVMR_COORDINATOR=f"file://{tmp}/rendezvous", OVMR_NUM_PROCESSES=str(world),
                      OVMR_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    torch.manual_seed(0)  # each rank builds its nets after the same seed
    import torch.distributed as dist

    from ovmr_tpu_torch.engine import da
    from ovmr_tpu_torch.parallel import maybe_initialize_distributed
    from tests.test_torch_dg_trajectory import replay_trainer

    assert maybe_initialize_distributed("cpu")
    try:
        trainer = replay_trainer(da.DANN, make_cfg(pathlib.Path(tmp), "DANN"))
        assert trainer.axis.group is not None and trainer.loss_scale == 0.5
        out, state = _two_steps(trainer)
        refusals = {}
        for name in ("M3SDA", "DAEL", "CDAC"):
            try:
                replay_trainer(getattr(da, name), make_cfg(pathlib.Path(tmp), name))
            except NotImplementedError as e:
                refusals[name] = str(e)
        torch.save({"out": out, "state": state, "refusals": refusals}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_dann_two_gloo_ranks_equal_one_program(tmp_path):
    """One data shard a rank: the global BN statistics of the model and the
    critic, the row-mean losses' share and the summed gradients give the
    single program's update on both ranks; the whole-batch trainers refuse."""
    from ovmr_tpu_torch.engine import da
    from tests.test_torch_dg_trajectory import replay_trainer

    torch.manual_seed(0)
    out1, s1 = _two_steps(replay_trainer(da.DANN, make_cfg(tmp_path, "DANN")))
    mp.spawn(_gloo_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    a = _flat(s1)
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        for key in ("loss_x", "loss_d", "acc_x"):
            assert got["out"][key] == pytest.approx(out1[key], rel=1e-5), key
        b = _flat(got["state"])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=f"rank {rank} {k}")
        assert sorted(got["refusals"]) == ["CDAC", "DAEL", "M3SDA"]
        for name, message in got["refusals"].items():
            assert message.startswith(f"{name}'s losses span the whole batch")
            assert "ROADMAP Queue 1 item 8" in message
