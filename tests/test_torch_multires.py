"""The port's multi-resolution collate (``ovmr_tpu_torch/data/multires.py``)
and its wiring (``data/manager.py``) against the JAX package's, on the CPU.

- ``draw_shape`` over 200 seeds equals JAX's, at patch 14, 16 and 32 and
  with 9, 1 and 0 ratio bins (0: the continuous draw);
- the collate's batch on the same PIL images and ``random.Random`` equals
  JAX's bit for bit (crop, bilinear resize, the batch's flip coin,
  normalisation);
- ``DataManager`` train batches with ``DATALOADER.MULTI_RES_COLLATE`` equal
  the JAX ``DataManager``'s bit for bit, two epochs, and the patch size
  comes from the backbone;
- the combinations the JAX loader refuses raise the same ``ValueError``;
- one MM_CLS_OP step on an off-native batch (TINY, fp32, sgd): the loss
  within 1e-5 and every aggregator gradient within 1e-4 of its scale of
  the JAX step's; and the trainer's ``forward_backward`` on such a batch;
- ``CUDA.DEVICE_AUGS`` with the collate trains from the cached loader, as
  the JAX trainer does with ``TPU.DEVICE_AUGS``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ovmr_tpu.data import multires as jmultires
from ovmr_tpu_torch.data import multires
from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.utils import get_cfg_default


@pytest.mark.parametrize("patch,bins", [(14, 9), (16, 9), (32, 9), (16, 1), (14, 0)])
def test_draw_shape_equals_jax(patch, bins):
    ours = multires.MultiResCollate(patch_size=patch, ratio_bins=bins)
    theirs = jmultires.MultiResCollate(patch_size=patch, ratio_bins=bins)
    assert ours.short_sizes == theirs.short_sizes and ours.ratio_grid == theirs.ratio_grid
    for seed in range(200):
        got = ours.draw_shape(random.Random(seed))
        assert got == theirs.draw_shape(random.Random(seed)), seed
        _, h, w = got
        assert h % patch == 0 and w % patch == 0


def _pils(seed, n):
    rng = np.random.default_rng(seed)
    sizes = [(48, 64), (64, 48), (50, 50), (90, 40), (37, 71)]
    return [Image.fromarray(rng.integers(0, 256, (*sizes[i % 5], 3), np.uint8))
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_collate_bit_equal_jax(seed):
    images = _pils(seed, 5)
    ours = multires.MultiResCollate(patch_size=16)(images, random.Random(seed))
    theirs = jmultires.MultiResCollate(patch_size=16)(images, random.Random(seed))
    assert ours.dtype == np.float32 and ours.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(ours, theirs)


def _cfg(make, root, backbone="TINY", **extra):
    cfg = make()
    cfg.SEED = 1
    cfg.DATASET.ROOT, cfg.DATASET.NAME, cfg.DATASET.NUM_SHOTS = root, "Synthetic", 4
    cfg.INPUT.SIZE = (32, 32)
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TRAIN_X.N_INS = 8, 4
    cfg.DATALOADER.TEST.BATCH_SIZE, cfg.DATALOADER.NUM_WORKERS = 8, 2
    cfg.DATALOADER.MULTI_RES_COLLATE = True
    cfg.MODEL.BACKBONE.NAME = backbone
    for key, value in extra.items():
        node, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        target = cfg
        for part in filter(None, node.split(".")):
            target = target[part]
        target[leaf] = value
    return cfg


def test_data_manager_batches_equal_jax(tmp_path, monkeypatch):
    from ovmr_tpu.data.manager import DataManager as JDataManager
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    monkeypatch.setenv("OVMR_SYNTHETIC", "4,6,48")
    root = str(tmp_path / "data")
    port = DataManager(_cfg(get_cfg_default, root))
    theirs = JDataManager(_cfg(j_cfg, root))
    assert port.train_loader_x.multi_res.patch_size == 16  # TINY's patch
    assert port.eval_set_loader.multi_res is None  # the train loader only
    shapes = set()
    for _ in range(2):
        n = 0
        for a, b in zip(port.train_loader_x, theirs.train_loader_x):
            assert a["impath"] == b["impath"]
            np.testing.assert_array_equal(a["label"], b["label"])
            np.testing.assert_array_equal(a["index"], b["index"])
            np.testing.assert_array_equal(a["img"], b["img"])
            shapes.add(a["img"].shape[2:])
            n += 1
        assert n == len(port.train_loader_x) > 0
    assert (32, 32) not in shapes  # INPUT.SIZE does not apply
    for backbone, patch in (("RN50", 14), ("ViT-L/14", 14), ("ViT-B/32", 32), ("nope", 14)):
        dm = DataManager(_cfg(get_cfg_default, root, backbone=backbone))
        assert dm.train_loader_x.multi_res.patch_size == patch, backbone


@pytest.mark.parametrize("key,value", [("DATALOADER.K_TRANSFORMS", 2),
                                       ("DATALOADER.RETURN_IMG0", True), ("TEXT_ONLY", True)])
def test_refused_combinations_raise_as_jax(tmp_path, monkeypatch, key, value):
    from ovmr_tpu.data.manager import DataManager as JDataManager
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    monkeypatch.setenv("OVMR_SYNTHETIC", "4,6,48")
    root = str(tmp_path / "data")
    with pytest.raises(ValueError, match="MULTI_RES_COLLATE") as ours:
        DataManager(_cfg(get_cfg_default, root, **{key: value}))
    with pytest.raises(ValueError, match="MULTI_RES_COLLATE") as theirs:
        JDataManager(_cfg(j_cfg, root, **{key: value}))
    assert str(ours.value) == str(theirs.value)


def test_off_native_step_matches_jax(tmp_path, monkeypatch):
    """A drawn batch (off the tower's 32 px) through one MM_CLS_OP step of
    each package: TINY towers, dropout 0, split 2, plain sgd, so the JAX
    gradient is the step's change over the learning rate."""
    from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
    from ovmr_tpu.engine.train_step import make_train_step as j_make_train_step
    from ovmr_tpu.models import clip as jclip
    from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch import convert
    from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves
    from ovmr_tpu_torch.engine.train_step import make_train_step
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models import ovmr as tovmr

    monkeypatch.setenv("OVMR_SYNTHETIC", "4,6,48")
    dm = DataManager(_cfg(get_cfg_default, str(tmp_path / "data")))
    batch = next(iter(dm.train_loader_x))
    n_cls, n_ins = 2, 4
    images = batch["img"].reshape(n_cls, n_ins, *batch["img"].shape[1:])
    assert images.shape[3:] != (32, 32)
    names = [dm.lab2cname[int(c)] for c in batch["label"][::n_ins]]
    ptok, eot, vtok = tovmr.build_prompt_tokens(names)

    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jp = np_tree(jclip.init_params(jax.random.PRNGKey(0), jclip.TINY))
    ja = np_tree(j_init_aggregator(jax.random.PRNGKey(0), width=64, layers=2, n_ctx=2))
    lr = 0.05
    optim = j_cfg().OPTIM
    optim.NAME, optim.LR, optim.MOMENTUM, optim.WEIGHT_DECAY = "sgd", lr, 0.0, 0.0
    j_opt = j_build_optimizer(optim)
    ja_new, _, j_loss = j_make_train_step(jclip.TINY, j_opt, dropout=0.0)(
        ja, j_opt.init(ja), jp, jnp.asarray(images), jnp.asarray(ptok), jnp.asarray(eot),
        jnp.asarray(vtok), jax.random.PRNGKey(0), 2)

    ta = convert.aggregator_params_from_numpy(ja)
    for leaf in param_leaves(ta):
        leaf.requires_grad_(True)
    loss = make_train_step(tclip.TINY, dropout=0.0)(
        ta, build_optimizer(optim, ta), convert.clip_params_from_numpy(jp),
        torch.from_numpy(images), torch.tensor(ptok), torch.tensor(eot), torch.tensor(vtok),
        None, 2)
    assert float(loss) == pytest.approx(float(j_loss), abs=1e-5)
    j_grads = jax.tree_util.tree_map(lambda a, b: (a - np.asarray(b)) / lr, ja, np_tree(ja_new))
    ours = {"cls_token": ta["cls_token"].grad, **{k: v.grad for k, v in ta["blocks"].items()}}
    theirs = {"cls_token": j_grads["cls_token"], **j_grads["blocks"]}
    for key, grad in ours.items():
        scale = max(float(np.abs(theirs[key]).max()), 1e-6)
        np.testing.assert_allclose(grad.numpy(), theirs[key], atol=1e-4 * scale, rtol=0,
                                   err_msg=key)


def _trainer_cfg(tmp_path, **extra):
    cfg = _cfg(get_cfg_default, str(tmp_path / "data"), **extra)
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.TRAINER.NAME, cfg.TRAINER.COCOOP.N_CTX, cfg.OPTIM.MAX_EPOCH = "MM_CLS_OP", 2, 1
    cfg.CUDA.DTYPE, cfg.CUDA.DEVICE = "float32", "cpu"
    return cfg


def test_trainer_steps_on_a_drawn_batch(tmp_path, monkeypatch):
    """``tests/test_multires.py::test_multires_trains_through_the_real_step``
    through the port's trainer."""
    from ovmr_tpu_torch.engine.trainer import build_trainer

    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,48")
    trainer = build_trainer(_trainer_cfg(tmp_path))
    batch = next(iter(trainer.train_loader))
    h, w = batch["img"].shape[2:]
    assert (h, w) != (32, 32) and h % 16 == 0 and w % 16 == 0
    assert np.isfinite(trainer.forward_backward(batch)["loss"])


def test_device_augs_takes_precedence_as_in_jax(tmp_path, monkeypatch):
    """With both keys set the JAX trainer trains from its decode-once cache
    (``MM_CLS_OP.train_loader``), so the collate's loader is built and not
    read; the port does the same."""
    from ovmr_tpu.engine import register_all_trainers
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch.engine.trainer import build_trainer

    register_all_trainers()
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,48")
    monkeypatch.setenv("OVMR_CACHE_DIR", str(tmp_path / "cache"))
    port = build_trainer(_trainer_cfg(tmp_path, **{"CUDA.DEVICE_AUGS": True,
                                                   "CUDA.CACHE_SIDE": 40}))
    jcfg = _cfg(j_cfg, str(tmp_path / "data"), **{"TPU.DEVICE_AUGS": True,
                                                  "TPU.CACHE_SIDE": 40})
    jcfg.OUTPUT_DIR, jcfg.TRAINER.NAME, jcfg.TRAINER.COCOOP.N_CTX = str(tmp_path / "j"), \
        "MM_CLS_OP", 2
    jcfg.TPU.DTYPE = "float32"
    jtr = j_build_trainer(jcfg)
    assert port.dm.train_loader_x.multi_res is not None
    assert jtr.dm.train_loader_x.multi_res is not None
    assert type(port.train_loader).__name__ == type(jtr.train_loader).__name__ \
        == "CachedClassBatchLoader"
    assert next(iter(port.train_loader))["img_u8"].dtype == np.uint8
