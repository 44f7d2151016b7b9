"""The port's device-augmentation training path against the JAX package's,
on the CPU: the decode-once uint8 cache and its loader, the NHWC patch
embedding, the training step with ``augment``, and the trainer with
``CUDA.DEVICE_AUGS True``.

The step runs at fp32 with dropout 0; the split point and JAX's augment
draws are injected (torch and JAX random streams cannot match). Tolerances:
loss 1e-4; gradients 1e-4 of their scale (the augmented batch agrees to
~1e-4 and passes through two frozen towers); post-step parameters 1e-5 on
average.
"""

import os
import os.path as osp

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from ovmr_tpu.data.cache import CachedClassBatchLoader as JLoader
from ovmr_tpu.data.cache import ImageArrayCache as JCache
from ovmr_tpu.data.datum import Datum as JDatum
from ovmr_tpu.data.samplers import build_sampler as j_build_sampler
from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from ovmr_tpu.engine.train_step import make_train_step as j_make_train_step
from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu.utils.defaults import get_cfg_default as j_get_cfg_default
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.data.cache import CachedClassBatchLoader, ImageArrayCache
from ovmr_tpu_torch.data.datum import Datum
from ovmr_tpu_torch.data.samplers import build_sampler
from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves
from ovmr_tpu_torch.engine.trainer import build_trainer
from ovmr_tpu_torch.engine.train_step import make_train_step
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr as tovmr
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import residual_attention_block
from ovmr_tpu_torch.utils import get_cfg_default
from test_torch_augment import jax_draws, to_torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_tree(root, n_cls=4, per_class=6):
    """PNGs of mixed sizes and aspects under ``root``: (impath, label) pairs."""
    rng = np.random.RandomState(0)
    items = []
    for label in range(n_cls):
        d = osp.join(root, f"{label:03d}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            h, w = [(40, 56), (60, 44), (48, 48)][(label + i) % 3]
            path = osp.join(d, f"{i:04d}.png")
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path)
            items.append((path, label))
    return items


def test_cache_files_are_shared_with_the_jax_package(tmp_path, capsys):
    items = _write_tree(str(tmp_path / "imgs"))
    port_ds = [Datum(impath=p, label=y, classname=f"c{y}") for p, y in items]
    jax_ds = [JDatum(impath=p, label=y, classname=f"c{y}") for p, y in items]
    port = ImageArrayCache(port_ds, side=32, cache_dir=str(tmp_path / "a"))
    ref = JCache(jax_ds, side=32, cache_dir=str(tmp_path / "b"))
    assert osp.basename(port.path) == osp.basename(ref.path)
    assert port.images.shape == (len(items), 32, 32, 3) and port.images.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(port.images), np.asarray(ref.images))
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert not list((tmp_path / "a").glob("*.tmp.npy"))
    capsys.readouterr()
    # each package reads the file the other wrote, and builds nothing
    crossed = ImageArrayCache(port_ds, side=32, cache_dir=str(tmp_path / "b"))
    back = JCache(jax_ds, side=32, cache_dir=str(tmp_path / "a"))
    assert "Building" not in capsys.readouterr().out
    np.testing.assert_array_equal(np.asarray(crossed.images), np.asarray(ref.images))
    np.testing.assert_array_equal(np.asarray(back.images), np.asarray(port.images))


def test_cache_dir_comes_from_the_environment(tmp_path, monkeypatch):
    items = _write_tree(str(tmp_path / "imgs"), n_cls=2, per_class=2)
    monkeypatch.setenv("OVMR_CACHE_DIR", str(tmp_path / "env"))
    cache = ImageArrayCache([Datum(impath=p, label=y) for p, y in items], side=16)
    assert osp.dirname(cache.path) == str(tmp_path / "env") and osp.isfile(cache.path)


def test_cached_loader_batches_follow_the_jax_loader(tmp_path):
    items = _write_tree(str(tmp_path / "imgs"), n_cls=6, per_class=5)
    port_ds = [Datum(impath=p, label=y, classname=f"c{y}") for p, y in items]
    jax_ds = [JDatum(impath=p, label=y, classname=f"c{y}") for p, y in items]
    cache = ImageArrayCache(port_ds, side=24, cache_dir=str(tmp_path / "c"))
    jcache = JCache(jax_ds, side=24, cache_dir=str(tmp_path / "c"))
    loader = CachedClassBatchLoader(
        cache, build_sampler("RandomClassSampler", port_ds, 8, 4), 8, seed=3)
    ref = JLoader(jcache, j_build_sampler("RandomClassSampler", jax_ds, 8, 4), 8, seed=3)
    assert len(loader) == len(ref) > 1
    for _ in range(2):  # two epochs: epoch e draws from seed + e
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["img_u8", "index", "label"]
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["img_u8"].dtype == np.uint8
            labels = g["label"].reshape(2, 4)
            assert (labels == labels[:, :1]).all()


@pytest.mark.parametrize("block", ["fused", "torch_math"])
def test_nhwc_encode_image_equals_nchw(block):
    block_fn = fused_residual_block if block == "fused" else residual_attention_block
    jp = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY)
    tp = convert.clip_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    nhwc = tclip.encode_image(tp, tclip.TINY, torch.from_numpy(x), block_fn=block_fn,
                              layout="NHWC")
    nchw = tclip.encode_image(tp, tclip.TINY, torch.from_numpy(x).permute(0, 3, 1, 2),
                              block_fn=block_fn)
    np.testing.assert_allclose(nhwc.numpy(), nchw.numpy(), rtol=0, atol=1e-6)
    want = np.asarray(jclip.encode_image(jp, jclip.TINY, jnp.asarray(x), layout="NHWC"))
    np.testing.assert_allclose(nhwc.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        tclip.encode_image(tp, tclip.TINY, torch.from_numpy(x), layout="HWC")


def test_augmented_step_matches_jax_train_step():
    """The same TINY params, uint8 batch, prompts, split and augment draws
    through the JAX step and the port's. SGD with no momentum and no decay,
    so the JAX step's update gives its gradient: (old - new) / lr."""
    key = jax.random.PRNGKey(0)
    jp = jclip.init_params(key, jclip.TINY)
    ja = j_init_aggregator(key, width=64, layers=2, n_ctx=2)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tp = convert.clip_params_from_numpy(np_tree(jp))
    ta = convert.aggregator_params_from_numpy(np_tree(ja))
    for leaf in param_leaves(ta):
        leaf.requires_grad_(True)

    n_cls, n_ins, split, side = 3, 4, 2, 40
    images = np.random.RandomState(5).randint(0, 256, (n_cls, n_ins, side, side, 3)).astype(
        np.uint8)
    ptok, eot, vtok = tovmr.build_prompt_tokens(["red circle", "green square", "blue triangle"])
    optim = j_get_cfg_default().OPTIM
    optim.NAME, optim.LR, optim.MOMENTUM, optim.WEIGHT_DECAY = "sgd", 0.05, 0.0, 0.0
    common = dict(out_size=32, scale=(0.25, 1.0), jitter=(0.4, 0.4, 0.4, 0.1), gn_std=0.15,
                  mean=(0.48145466, 0.4578275, 0.40821073),
                  std=(0.26862954, 0.26130258, 0.27577711))

    j_opt = j_build_optimizer(optim)
    j_step = j_make_train_step(jclip.TINY, j_opt, dropout=0.0,
                               augment=dict(common, out_dtype=jnp.float32))
    rng = jax.random.PRNGKey(9)
    ja_new, _, j_loss = j_step(ja, j_opt.init(ja), jp, jnp.asarray(images), jnp.asarray(ptok),
                               jnp.asarray(eot), jnp.asarray(vtok), rng, split)
    _, aug_rng = jax.random.split(rng)  # the JAX step's own split of its key
    draws = to_torch(jax_draws(aug_rng, n_cls * n_ins, side, 32, common["scale"],
                               common["jitter"], common["gn_std"]))

    optimizer = build_optimizer(optim, ta)
    step = make_train_step(tclip.TINY, dropout=0.0, augment=dict(common, out_dtype=torch.float32))
    loss = step(ta, optimizer, tp, torch.from_numpy(images), torch.tensor(ptok),
                torch.tensor(eot), torch.tensor(vtok), None, split, augment_draws=draws)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0, atol=1e-4)

    before, after = np_tree(ja), convert.aggregator_params_to_numpy(ta)
    ref = np_tree(ja_new)
    grads = {"cls_token": ta["cls_token"].grad.numpy()}
    grads.update({k: v.grad.numpy() for k, v in ta["blocks"].items()})
    pairs = [("cls_token", after["cls_token"], ref["cls_token"], before["cls_token"])] + [
        (k, v, ref["blocks"][k], before["blocks"][k]) for k, v in after["blocks"].items()]
    for name, got, want, old in pairs:
        j_grad = (old - want) / optim.LR
        scale = float(np.abs(j_grad).max())
        assert scale > 1e-4, name
        assert float(np.abs(grads[name] - j_grad).max()) <= 1e-4 * scale, name
        assert float(np.abs(got - want).mean()) <= 1e-5, name


def test_augmented_step_needs_a_generator_or_draws():
    step = make_train_step(tclip.TINY, dropout=0.0, augment=dict(out_size=32))
    with pytest.raises(ValueError, match="generator or injected draws"):
        step({}, None, {}, torch.zeros(1, 2, 40, 40, 3, dtype=torch.uint8), None, None, None,
             None, 1)


def _cfg(tmp_path, **over):
    cfg = get_cfg_default()
    settings = {
        "OUTPUT_DIR": str(tmp_path / "out"), "SEED": 1, "DATASET.ROOT": str(tmp_path / "data"),
        "DATASET.NAME": "Synthetic", "DATASET.NUM_SHOTS": 4, "INPUT.SIZE": (32, 32),
        "INPUT.TRANSFORMS": ("random_resized_crop", "random_flip", "colorjitter",
                             "gaussian_noise", "normalize"),
        "INPUT.RRCROP_SCALE": (0.25, 1.0),
        "DATALOADER.TRAIN_X.SAMPLER": "RandomClassSampler",
        "DATALOADER.TRAIN_X.BATCH_SIZE": 16, "DATALOADER.TRAIN_X.N_INS": 4,
        "DATALOADER.TEST.BATCH_SIZE": 16, "DATALOADER.NUM_WORKERS": 2,
        "MODEL.BACKBONE.NAME": "TINY", "TRAINER.NAME": "MM_CLS_OP",
        "TRAINER.COCOOP.N_CTX": 2, "OPTIM.MAX_EPOCH": 1, "TEST.NO_TEST": True,
        "CUDA.DTYPE": "float32", "CUDA.DEVICE": "cpu", "CUDA.DEVICE_AUGS": True,
        "CUDA.CACHE_SIDE": 40,
    }
    settings.update(over)
    for key, value in settings.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


def test_trainer_trains_with_device_augs(tmp_path, monkeypatch):
    """``CUDA.DEVICE_AUGS True`` on TINY and Synthetic, one epoch on the CPU,
    in the shape of ``tests/test_device_augs_training.py``: the loader ships
    uint8 cache batches, the step augments them and the aggregator moves."""
    monkeypatch.setenv("OVMR_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,48")
    t = build_trainer(_cfg(tmp_path))
    loader = t.train_loader
    assert loader is t.train_loader  # built once
    batch = next(iter(loader))
    assert batch["img_u8"].dtype == np.uint8 and batch["img_u8"].shape == (16, 40, 40, 3)
    seen = []
    orig = t.train_step

    def spy(agg, opt, clip, images, *rest, **kw):
        seen.append((images.dtype, tuple(images.shape)))
        return orig(agg, opt, clip, images, *rest, **kw)

    t.train_step = spy
    before = t.agg_params["cls_token"].detach().clone()
    t.train()
    assert seen and all(s == (torch.uint8, (4, 4, 40, 40, 3)) for s in seen)
    assert not torch.allclose(before, t.agg_params["cls_token"].detach())
    assert len(list((tmp_path / "cache").glob("imgs_*.npy"))) == 1
