"""The port's sharded checkpoint backend (``CUDA.CHECKPOINT_BACKEND "orbax"``).

Orbax's layout and contract (``ovmr_tpu/engine/orbax_io.py``) written by
``torch.distributed.checkpoint``: a round trip with the optimizer state,
an explicit epoch, a params-only restore of a checkpoint saved with
optimizer state, the trainer's save and auto-resume through the backend
(the aggregator and the optimizer state back bit for bit), and the refusal, with a
message, of a directory the JAX package's orbax wrote.
"""

import json

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine.optimizers import build_optimizer
from ovmr_tpu_torch.engine.orbax_io import load_orbax, save_orbax
from ovmr_tpu_torch.engine.trainer import build_trainer
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


def _state():
    params = {"w": torch.arange(4.0).requires_grad_(True),
              "blk": {"b": torch.ones(2).requires_grad_(True)}}
    optimizer = build_optimizer(get_cfg_default().OPTIM, params)  # adam
    for p in (params["w"], params["blk"]["b"]):
        p.grad = torch.full_like(p, 0.5)
    optimizer.step()
    return params, optimizer


def test_round_trip_and_params_only_restore(tmp_path):
    params, optimizer = _state()
    path = save_orbax(str(tmp_path), "prompt_learner", 5, params, optimizer)
    sub = tmp_path / "prompt_learner"
    assert (sub / "checkpoint_orbax").read_text() == "orbax-5"
    assert {p.name for p in (sub / "orbax-5").iterdir()} == {"params", "opt_state", "meta.json"}
    meta = json.loads((sub / "orbax-5" / "meta.json").read_text())
    assert meta["epoch"] == 5 and meta["has_opt_state"] is True and path.endswith("orbax-5")

    loaded, opt, epoch = load_orbax(str(tmp_path), "prompt_learner", params)
    assert epoch == 5
    for (k, a), (_, b) in zip(ckpt.named_leaves(loaded), ckpt.named_leaves(params)):
        assert torch.equal(a, b.detach()), k
    want = ckpt.optimizer_state_arrays(optimizer, params)
    assert set(opt) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(opt[key], value, err_msg=key)
    # the state goes back into a fresh optimizer as the npz path's does
    fresh, fresh_opt = _state()
    ckpt.copy_into(fresh, loaded)
    ckpt.load_optimizer_state(fresh_opt, fresh, opt)
    for key, value in ckpt.optimizer_state_arrays(fresh_opt, fresh).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)

    _, _, ep = load_orbax(str(tmp_path), "prompt_learner", params, epoch=5)
    assert ep == 5
    only, none, ep = load_orbax(str(tmp_path), "prompt_learner", params, with_opt_state=False)
    assert none is None and ep == 5 and torch.equal(only["w"], params["w"].detach())
    with pytest.raises(FileNotFoundError):
        load_orbax(str(tmp_path / "nope"), "prompt_learner", params)


def test_a_checkpoint_orbax_wrote_is_refused(tmp_path):
    """The JAX package's orbax writes this layout with orbax's own array
    files: the port refuses it by name, never misreading it."""
    pytest.importorskip("orbax.checkpoint")
    import jax.numpy as jnp

    from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
    from ovmr_tpu.engine.orbax_io import save_orbax as j_save_orbax
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    jparams = {"w": jnp.arange(4.0), "blk": {"b": jnp.ones(2)}}
    j_opt = j_build_optimizer(j_cfg().OPTIM)
    j_save_orbax(str(tmp_path), "prompt_learner", 3, jparams, j_opt.init(jparams))
    params, optimizer = _state()
    for call in (lambda: load_orbax(str(tmp_path), "prompt_learner", params),
                 lambda: ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", params,
                                                     optimizer, backend="orbax")):
        with pytest.raises(ValueError, match="written by orbax.*npz"):
            call()


def _cfg(tmp_path, out, epochs, backend):
    cfg = get_cfg_default()
    cfg.OUTPUT_DIR, cfg.SEED = str(tmp_path / out), 1
    cfg.DATASET.ROOT, cfg.DATASET.NAME, cfg.DATASET.NUM_SHOTS = str(tmp_path / "data"), \
        "Synthetic", 4
    cfg.INPUT.SIZE, cfg.INPUT.TRANSFORMS = (32, 32), ["normalize"]
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TRAIN_X.N_INS = 8, 4
    cfg.DATALOADER.TEST.BATCH_SIZE, cfg.DATALOADER.NUM_WORKERS = 8, 2
    cfg.MODEL.BACKBONE.NAME, cfg.TRAINER.NAME, cfg.TRAINER.COCOOP.N_CTX = "TINY", "MM_CLS_OP", 2
    cfg.OPTIM.MAX_EPOCH, cfg.TRAIN.CHECKPOINT_FREQ, cfg.TEST.NO_TEST = epochs, 1, True
    cfg.CUDA.DTYPE, cfg.CUDA.DEVICE, cfg.CUDA.CHECKPOINT_BACKEND = "float32", "cpu", backend
    return cfg


def test_trainer_saves_and_resumes_through_the_backend(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    first = build_trainer(_cfg(tmp_path, "orbax", 1, "orbax"))
    first.train()
    sub = tmp_path / "orbax" / "prompt_learner"
    assert (sub / "checkpoint_orbax").read_text() == "orbax-1"
    assert not (sub / "model-1.npz").exists() and (sub / "model.pth.tar-1").exists()
    resumed = build_trainer(_cfg(tmp_path, "orbax", 2, "orbax"))
    assert resumed.resume_model_if_exist(str(tmp_path / "orbax")) == 1
    assert "Resumed from epoch 1 (orbax)" in capsys.readouterr().out
    # the aggregator and the adam moments come back bit for bit
    for (k, a), (_, b) in zip(ckpt.named_leaves(resumed.agg_params),
                              ckpt.named_leaves(first.agg_params)):
        assert torch.equal(a.detach(), b.detach()), k
    want = ckpt.optimizer_state_arrays(first.optimizer, first.agg_params)
    for key, value in ckpt.optimizer_state_arrays(resumed.optimizer,
                                                  resumed.agg_params).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    resumed.train()
    assert "Resumed from epoch 1 (orbax)" in capsys.readouterr().out
    assert (sub / "checkpoint_orbax").read_text() == "orbax-2"
    # the eval loads the latest orbax epoch too
    params, _, epoch = ckpt.load_checkpoint(str(tmp_path / "orbax"), "prompt_learner",
                                            resumed.agg_params, backend="orbax")
    assert epoch == 2
