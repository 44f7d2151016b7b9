"""The port's SSL trainers end to end on the CPU, their checkpoints across
the two packages and through the orbax backend, and the data axis.

- SupBaseline, EntMin, MeanTeacher, MixMatch and FixMatch through
  ``build_trainer`` -> ``train()`` -> ``test()`` on ``SyntheticSSL`` at
  32x32 (template: ``tests/test_dassl_trainers.py:62-118``); MeanTeacher's
  teacher moves, by its own BN statistics and the EMA of the parameters;
  MixMatch and FixMatch refuse their bad configurations.
- A FixMatch run saved by the port resumes in the JAX package, and the JAX
  run's next checkpoint in the port.
- SourceOnly and FixMatch save and resume through ``CUDA.CHECKPOINT_BACKEND
  orbax`` to the npz run's state, optimizer state included (held like
  ``tests/test_torch_orbax.py``).
- FixMatch on 2 local data shards equals the single program, and two gloo
  ranks with the sliced loader, each decoding its block of every batch, equal
  it too (templates: ``tests/test_torch_da_trainers.py``,
  ``tests/multihost_worker.py:268-290``); so does MixMatch, whose shuffle
  and mixup span the whole joint batch, with its draws injected, and its
  rank-local control misses the gates.
"""

import os
import os.path as osp
import pathlib
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.trainer import build_trainer
from tests.test_torch_dg_trainers import (
    _assert_ranks_hold,
    _assert_states_equal,
    _flat,
    _jax_trainer,
    gate_readings,
    rank_local,
    trainer_leaves,
)
from tests.test_torch_dg_trainers import make_cfg as _make_cfg


class _NoWriter:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """4 classes x 8 images at 32px (train 16: 8 labeled, 8 unlabeled; test
    8), one intra-op thread, and no tensorboard writer."""
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    monkeypatch.setattr(trainer_mod.TrainerBase, "init_writer",
                        lambda self: setattr(self, "_writer", _NoWriter()) or self._writer)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STRONG = {"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("random_flip", "cutout", "normalize")}


def make_cfg(tmp_path, trainer, make=None, **overrides):
    kw = {} if make is None else {"make": make}
    return _make_cfg(tmp_path, trainer, **kw, **{
        "DATASET.NAME": "SyntheticSSL", "DATALOADER.TRAIN_U.SAME_AS_X": False,
        "DATALOADER.TRAIN_X.BATCH_SIZE": 4, "DATALOADER.TRAIN_U.BATCH_SIZE": 4, **overrides})


TRAINERS = {
    "SupBaseline": {},
    "EntMin": {},
    "MeanTeacher": {},
    "MixMatch": {"DATALOADER.K_TRANSFORMS": 2},
    "FixMatch": STRONG,
}


def _record_steps(trainer):
    steps = []
    orig = trainer.forward_backward_xu
    trainer.forward_backward_xu = lambda bx, bu: steps.append(orig(bx, bu)) or steps[-1]
    return steps


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_trains_and_tests(tmp_path, name):
    trainer = build_trainer(make_cfg(tmp_path, name, **TRAINERS[name]))
    assert trainer.get_model_names() == ["model"]
    assert len(trainer.dm.dataset.train_u) == 8
    before = _flat(trainer.model_state())
    steps = _record_steps(trainer)
    trainer.train()  # one epoch, then test()
    assert len(steps) == 2 and all(np.isfinite(out["loss"]) for out in steps)
    assert all(out["loss"] == out["loss_x" if name != "SupBaseline" else "loss"]
               for out in steps)
    after = _flat(trainer.model_state())
    assert not np.array_equal(after["params/backbone/conv1/kernel"],
                              before["params/backbone/conv1/kernel"])
    assert 0.0 <= trainer.test() <= 100.0
    batch = next(iter(trainer.dm.test_loader))
    out = trainer.model_inference(batch)
    assert out.shape == (len(batch["label"]), trainer.num_classes) and np.isfinite(out).all()
    assert osp.isfile(osp.join(trainer.output_dir, "model", "model-1.npz"))
    if name == "FixMatch":
        for key in ("loss_u", "y_u_pred_acc_raw", "y_u_pred_acc_thre", "y_u_pred_keep"):
            assert all(np.isfinite(out[key]) for out in steps), key
        assert all(0.0 <= out["y_u_pred_keep"] <= 1.0 for out in steps)


def test_mean_teacher_moves_by_its_own_statistics_and_the_ema(tmp_path):
    from ovmr_tpu_torch.convert import dassl_state_to_numpy

    trainer = build_trainer(make_cfg(tmp_path, "MeanTeacher"))
    init = _flat(dassl_state_to_numpy(trainer.teacher))
    _assert_states_equal(dassl_state_to_numpy(trainer.teacher), trainer.model_state())
    assert not any(p.requires_grad for p in trainer.teacher.parameters())
    trainer.train()
    teacher, student = _flat(dassl_state_to_numpy(trainer.teacher)), _flat(trainer.model_state())
    params = [k for k in init if k.startswith("params/")]
    stats = [k for k in init if k.startswith("batch_stats/")]
    assert params and stats
    assert max(float(np.abs(teacher[k] - init[k]).max()) for k in params) > 0
    assert max(float(np.abs(teacher[k] - init[k]).max()) for k in stats) > 0
    # the teacher's statistics are its own forwards', not the student's
    assert any(not np.array_equal(teacher[k], student[k]) for k in stats)
    # after the first step (decay 0) the teacher's parameters are an EMA, not
    # the student's
    assert any(not np.array_equal(teacher[k], student[k]) for k in params)


@pytest.mark.parametrize("name,overrides", [("MixMatch", {"DATALOADER.K_TRANSFORMS": 1}),
                                            ("FixMatch", {})])
def test_bad_configurations_are_refused(tmp_path, name, overrides):
    with pytest.raises(AssertionError):
        build_trainer(make_cfg(tmp_path, name, **overrides))


def test_fixmatch_batches_carry_the_strong_views(tmp_path):
    trainer = build_trainer(make_cfg(tmp_path, "FixMatch", **STRONG))
    batch_x = next(iter(trainer.dm.train_loader_x))
    batch_u = next(iter(trainer.dm.train_loader_u))
    for batch in (batch_x, batch_u):
        assert batch["img"].shape == batch["img2"].shape == (4, 3, 32, 32)
        assert not np.array_equal(batch["img"], batch["img2"])
    trainer.epoch, trainer.batch_idx, trainer.num_batches = 0, 0, 1
    out = trainer.forward_backward_xu(batch_x, batch_u)
    for key in ("loss_x", "loss_u", "y_u_pred_keep"):
        assert np.isfinite(out[key])


def test_fixmatch_checkpoints_resume_across_the_packages(tmp_path):
    """The port's epoch-1 FixMatch checkpoint resumes in JAX and JAX's
    epoch-2 one in the port: states equal bit for bit, and the second epoch
    agrees."""
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    kw = {**STRONG, "TRAIN.CHECKPOINT_FREQ": 1, "TEST.NO_TEST": True,
          "DATALOADER.TRAIN_X.SAMPLER": "SequentialSampler"}
    two = {**kw, "OPTIM.MAX_EPOCH": 2}
    port = build_trainer(make_cfg(tmp_path / "p", "FixMatch", **kw))
    port.train()
    shutil.copytree(tmp_path / "p", tmp_path / "q")
    jax_t = _jax_trainer(make_cfg(tmp_path / "p", "FixMatch", make=j_cfg, **two))
    assert jax_t.resume_model_if_exist(str(tmp_path / "p" / "out")) == 1
    _assert_states_equal(port.model_state(), jax_t._models["model"])
    jax_t.train()  # writes its epoch-2 checkpoint beside the port's epoch-1 one
    resumed = build_trainer(make_cfg(tmp_path / "q", "FixMatch", **two))
    resumed.train()
    assert resumed.start_epoch == 1
    _assert_states_equal(resumed.model_state(), jax_t._models["model"], atol=2e-4)
    port2 = build_trainer(make_cfg(tmp_path / "p", "FixMatch", **two))
    assert port2.resume_model_if_exist(str(tmp_path / "p" / "out")) == 2
    _assert_states_equal(port2.model_state(), jax_t._models["model"])


def _optimizer_arrays(trainer, name="model"):
    return ckpt.optimizer_state_arrays(trainer._optims[name], trainer._named_params(name))


def dassl_orbax_round_trip(tmp_path, cfg_of, name, **overrides):
    """One epoch of ``name`` saved through each backend from one seed: the
    orbax run writes ``orbax-1`` and its pointer for every model and ends in
    the npz run's state; a second trainer, from another init, resumes it
    (the orbax pointer first) to that state and optimizer state, bit for
    bit."""
    kw = {**overrides, "TEST.NO_TEST": True, "DATALOADER.TRAIN_X.SAMPLER": "SequentialSampler"}
    runs = {}
    for backend in ("npz", "orbax"):
        torch.manual_seed(0)
        runs[backend] = build_trainer(cfg_of(tmp_path / backend, name, **kw, **{
            "CUDA.CHECKPOINT_BACKEND": backend}))
        runs[backend].train()
    models = runs["orbax"].get_model_names()
    out = tmp_path / "orbax" / "out"
    for model in models:
        assert (out / model / "checkpoint_orbax").read_text() == "orbax-1"
        assert {p.name for p in (out / model / "orbax-1").iterdir()} == {
            "params", "opt_state", "meta.json"}
        assert not (out / model / "model-1.npz").exists()
        _assert_states_equal(runs["orbax"].model_state(model), runs["npz"].model_state(model))
    torch.manual_seed(1)
    resumed = build_trainer(cfg_of(tmp_path / "orbax", name, **kw, **{
        "CUDA.CHECKPOINT_BACKEND": "orbax", "OPTIM.MAX_EPOCH": 2}))
    assert resumed.resume_model_if_exist(str(out)) == 1
    for model in models:
        _assert_states_equal(resumed.model_state(model), runs["npz"].model_state(model))
        want = _optimizer_arrays(runs["npz"], model)
        got = _optimizer_arrays(resumed, model)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{model} {key}")
    return resumed


@pytest.mark.parametrize("name", ["SourceOnly", "FixMatch"])
def test_dassl_trainers_round_trip_through_orbax(tmp_path, name):
    if name == "SourceOnly":
        from tests.test_torch_dg_trainers import make_cfg as cfg_of

        kw = {"DATASET.NAME": "SyntheticDA", "DATALOADER.TRAIN_U.SAME_AS_X": True}
    else:
        cfg_of, kw = make_cfg, STRONG
    resumed = dassl_orbax_round_trip(tmp_path, cfg_of, name, **kw)
    resumed.train()  # the second epoch goes on from the resumed state
    assert resumed.start_epoch == 1
    assert (tmp_path / "orbax" / "out" / "model" / "checkpoint_orbax").read_text() == "orbax-2"


# --------------------------------------------------------------------------
# the data axis
# --------------------------------------------------------------------------

def _fixmatch_batches():
    rng = np.random.default_rng(3)

    def batch():
        img = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
        return {"img": img, "img2": img[:, :, :, ::-1].copy(), "label": rng.integers(0, 4, 8)}

    return [(batch(), batch()) for _ in range(2)]


def _steps(trainer, batches):
    trainer.epoch, trainer.max_epoch, trainer.num_batches = 0, 2, len(batches)
    trainer.before_epoch()
    for trainer.batch_idx, (batch_x, batch_u) in enumerate(batches):
        out = trainer.forward_backward_xu(batch_x, batch_u)
    return out, trainer.model_state()


def test_fixmatch_on_local_data_shards_equals_one_program(tmp_path):
    from ovmr_tpu_torch.engine import ssl
    from tests.test_torch_dg_trajectory import replay_trainer

    results = []
    for data in (1, 2):
        cfg = make_cfg(tmp_path, "FixMatch", **STRONG, **{
            "CUDA.MESH.DATA": data, "TRAINER.FIXMATCH.CONF_THRE": 0.3})
        torch.manual_seed(0)  # one init for both runs
        trainer = replay_trainer(ssl.FixMatch, cfg)
        assert (trainer.mesh is None) == (data == 1)
        results.append(_steps(trainer, _fixmatch_batches()))
    (out1, s1), (out2, s2) = results
    assert 0.0 < out1["y_u_pred_keep"] < 1.0  # the mask is live
    for key in ("loss_x", "loss_u", "acc_x", "y_u_pred_keep", "y_u_pred_acc_thre"):
        assert out1[key] == pytest.approx(out2[key], rel=1e-5, abs=1e-7), key
    a, b = _flat(s1), _flat(s2)
    assert any("batch_stats/" in k for k in a)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=k)


SLICED = {**STRONG, "TRAINER.FIXMATCH.CONF_THRE": 0.3, "DATALOADER.NUM_WORKERS": 1}


def _loader_steps(trainer):
    """Two steps on the loaders' first two batches."""
    it_x, it_u = iter(trainer.dm.train_loader_x), iter(trainer.dm.train_loader_u)
    batches = [(next(it_x), next(it_u)) for _ in range(2)]
    return batches[0][0].get("_local", False), _steps(trainer, batches)


def _mixmatch_draws(trainer):
    """Injected MixMatch draws (as ``tests/test_torch_ssl_trajectory.py``
    injects the recorded ones): a function of the step and the joint batch's
    sizes only, so one process and every rank draw the same."""
    def draws(gen, n_x, n_u):
        rng = np.random.default_rng([trainer.batch_idx, n_x, n_u])
        lam_x, lam_u = rng.beta(0.75, 0.75, n_x), rng.beta(0.75, 0.75, n_u)
        return (rng.permutation(n_x + n_u), np.maximum(lam_x, 1 - lam_x).astype(np.float32),
                np.maximum(lam_u, 1 - lam_u).astype(np.float32))

    return draws


def _mixmatch_batches():
    """8 labeled and 8 unlabeled items a batch, two adjacent views each."""
    rng = np.random.default_rng(3)

    def views(n):
        img = rng.standard_normal((n, 2, 3, 32, 32)).astype(np.float32)
        return img.reshape(2 * n, 3, 32, 32)

    return [({"img": views(8), "label": np.repeat(rng.integers(0, 4, 8), 2)},
             {"img": views(8), "label": np.zeros(16, np.int64)}) for _ in range(2)]


def _mixmatch_case(tmp, control=False):
    from ovmr_tpu_torch.engine import ssl
    from tests.test_torch_dg_trajectory import replay_trainer

    torch.manual_seed(0)  # one init for every run
    trainer = replay_trainer(ssl.MixMatch, make_cfg(tmp, "MixMatch", **{
        "DATALOADER.K_TRANSFORMS": 2, "TRAINER.MIXMATCH.RAMPUP": 2}))
    trainer.mixup_draws = _mixmatch_draws(trainer)
    if control:
        rank_local(trainer)
    trainer.epoch, trainer.max_epoch, trainer.num_batches = 0, 2, 2
    trainer.before_epoch()
    for trainer.batch_idx, (batch_x, batch_u) in enumerate(_mixmatch_batches()):
        out = trainer.forward_backward_xu(batch_x, batch_u)
    return out, trainer_leaves(trainer)


def _gloo_rank(rank, world, tmp):
    os.environ.update(OVMR_COORDINATOR=f"file://{tmp}/rendezvous", OVMR_NUM_PROCESSES=str(world),
                      OVMR_PROCESS_ID=str(rank), OVMR_SYNTHETIC="4,8,32")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ovmr_tpu_torch.parallel import maybe_initialize_distributed

    trainer_mod.TrainerBase.init_writer = lambda self: _NoWriter()
    path = pathlib.Path(tmp)
    assert maybe_initialize_distributed("cpu")
    try:
        torch.manual_seed(0)  # each rank builds its net after the same seed
        trainer = build_trainer(make_cfg(path, "FixMatch", **SLICED))
        assert trainer.axis.group is not None and trainer.loss_scale == 0.5
        local, (out, state) = _loader_steps(trainer)
        torch.save({"local": local, "out": out, "state": state,
                    "mixmatch": _mixmatch_case(path),
                    "control": _mixmatch_case(path, control=True)}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """The one-process runs, then one spawn of two gloo ranks running them
    again: FixMatch on its sliced loader, MixMatch and its control."""
    tmp = tmp_path_factory.mktemp("gloo")
    with pytest.MonkeyPatch.context() as mp_env:
        mp_env.setenv("OVMR_SYNTHETIC", "4,8,32")
        mp_env.setattr(trainer_mod.TrainerBase, "init_writer", lambda self: _NoWriter())
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            torch.manual_seed(0)
            fixmatch = _loader_steps(build_trainer(make_cfg(tmp, "FixMatch", **SLICED)))
            mixmatch = _mixmatch_case(tmp)
            mp.spawn(_gloo_rank, args=(2, str(tmp)), nprocs=2, join=True)
        finally:
            torch.set_num_threads(threads)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"fixmatch": fixmatch, "mixmatch": mixmatch, "ranks": ranks}


def test_fixmatch_two_gloo_ranks_with_the_sliced_loader_equal_one_program(gloo_runs):
    """One data shard a rank, each decoding its block of every batch (the
    strong views keyed on the global stream position): the global BN
    statistics, the row-mean losses' share, the summed gradients and the
    summed pseudo-label counts give the single program's step on both
    ranks."""
    local, (out1, s1) = gloo_runs["fixmatch"]
    assert not local
    a = _flat(s1)
    for rank, got in enumerate(gloo_runs["ranks"]):
        assert got["local"] is True
        for key in ("loss_x", "loss_u", "acc_x", "y_u_pred_acc_raw", "y_u_pred_acc_thre",
                    "y_u_pred_keep"):
            assert got["out"][key] == pytest.approx(out1[key], rel=1e-5, abs=1e-7), key
        b = _flat(got["state"])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=f"rank {rank} {k}")


def test_mixmatch_on_two_gloo_ranks_equals_one_program(gloo_runs):
    """The joint batch of every rank's rows ([x; u view 0; u view 1]), its
    shuffle and coefficients drawn over the whole of it, each rank
    forwarding its block of the mixed rows after its guesses: both ranks
    take the single program's step, losses within rel 1e-5 and every
    params, batch_stats and optimizer leaf within 1e-4."""
    _assert_ranks_hold(gloo_runs["mixmatch"], [r["mixmatch"] for r in gloo_runs["ranks"]])


def test_mixmatch_rank_local_control_fails_the_gates(gloo_runs):
    """The control: the shuffle and the mixup over each rank's own block
    miss the gates the cross-rank step meets."""
    for got in gloo_runs["ranks"]:
        assert max(gate_readings(gloo_runs["mixmatch"], got["control"])) > 1
