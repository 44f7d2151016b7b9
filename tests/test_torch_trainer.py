"""The port's MM_CLS_OP trainer end to end on the CPU.

- The replay of ``e2e_mm_fullloop_golden.npz`` (recorded from the real
  reference stack: dassl ``build_trainer`` -> DataManager -> MM_CLS_OP ->
  ``train()`` -> fusion ``test()`` -> export) through the port's
  ``build_trainer`` / ``train()`` / ``test()``, by the method of
  ``tests/test_e2e_mm_fullloop_parity.py`` and at its tolerances: dropout 0
  through the seam the trainer builds its step with, the recorded split
  points injected through ``trainer.py_rng``, the fixture towers through
  ``OVMR_CLIP_CKPT`` and ``MODEL.INIT_WEIGHTS``, ``CUDA.DEVICE cpu`` and
  ``CUDA.DTYPE float32``.
- The split-point sequence at a seed against the JAX trainer's.
- ``python -m ovmr_tpu_torch.train`` on ``Synthetic`` at ``TINY``: one
  epoch, then ``--eval-only`` fusion.
- Two epochs equal one epoch plus a resume (dropout 0).
- The refusals of the trainer and its config.
"""

import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.trainer import build_trainer
from ovmr_tpu_torch.models.import_torch import prompt_learner_params_from_state_dict
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(ROOT, "tests", "fixtures", "e2e_mm_fullloop_golden.npz")
DATA_ROOT = osp.join(ROOT, "tests", "fixtures", "e2e_mm_dataset")

N_CLS, N_INS, NUM_SHOTS, N_CTX = 4, 4, 8, 2
EPOCHS, BATCHES = 3, 2
SIZE = 224


class _SplitReplay:
    """Replays the recorded reference split draws through the
    ``sample_split_point`` seam."""

    def __init__(self, splits):
        self.splits = list(splits)
        self.i = 0

    def integers(self, lo, hi):
        assert (lo, hi) == (N_INS // 4, (3 * N_INS) // 4)
        v = self.splits[self.i]
        self.i += 1
        return v


def _no_dropout(monkeypatch):
    """Dropout off, like the reference recording: patch the seam the trainer
    builds its step with."""
    orig = trainer_mod.make_train_step

    def make_train_step(*a, **k):
        k["dropout"] = 0.0
        return orig(*a, **k)

    monkeypatch.setattr(trainer_mod, "make_train_step", make_train_step)


def test_mm_fullloop_matches_reference_stack(tmp_path, monkeypatch):
    data = np.load(FIXTURE)
    base_lr, cons_lr, wd, eval_tau = data["optim_scalars"]

    def torch_sd(prefix):
        plen = len(prefix) + 1
        return {k[plen:]: torch.from_numpy(np.array(data[k]))
                for k in data.files if k.startswith(prefix + ".")}

    clip_pt = tmp_path / "tiny_clip.pt"
    torch.save(torch_sd("clip"), clip_pt)
    monkeypatch.setenv("OVMR_CLIP_CKPT", str(clip_pt))
    pl_pt = tmp_path / "pl_init.pt"
    torch.save({"state_dict": torch_sd("pl_init")}, pl_pt)
    _no_dropout(monkeypatch)
    root = tmp_path / "data"
    shutil.copytree(DATA_ROOT, root)

    cfg = get_cfg_default()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 1
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = "DescribableTextures"
    cfg.DATASET.NUM_SHOTS = NUM_SHOTS
    cfg.INPUT.SIZE = (SIZE, SIZE)
    cfg.INPUT.INTERPOLATION = "bilinear"
    cfg.INPUT.TRANSFORMS = ("normalize",)
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = N_CLS * N_INS
    cfg.DATALOADER.TRAIN_X.N_INS = N_INS
    cfg.DATALOADER.TEST.BATCH_SIZE = N_CLS * N_INS
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.MODEL.BACKBONE.NAME = "TINY_E2E_224"  # resolved via OVMR_CLIP_CKPT
    cfg.MODEL.INIT_WEIGHTS = str(pl_pt)
    cfg.TRAINER.NAME = "MM_CLS_OP"
    cfg.TRAINER.COCOOP.N_CTX = N_CTX
    cfg.TRAINER.COCOOP.PREC = "fp32"
    cfg.OPTIM.NAME = "adam"
    cfg.OPTIM.LR = float(base_lr)
    cfg.OPTIM.WEIGHT_DECAY = float(wd)
    cfg.OPTIM.MAX_EPOCH = EPOCHS
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.OPTIM.WARMUP_CONS_LR = float(cons_lr)
    cfg.EVAL_MODE = "fusion"
    cfg.EVAL_TAU = float(eval_tau)
    cfg.TRAIN.PRINT_FREQ = 1
    cfg.CUDA.DTYPE = "float32"
    cfg.CUDA.DEVICE = "cpu"
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)

    trainer = build_trainer(cfg)
    assert trainer.dm.num_classes == N_CLS
    # the committed reference-written few-shot pickle, through the port's
    # compat unpickler: 8 shots per class
    assert len(trainer.dm.dataset.train_x) == N_CLS * NUM_SHOTS
    assert len(trainer.dm.dataset.test) == 12
    trainer.py_rng = _SplitReplay(data["splits"])

    losses, it = [], {"i": 0}
    orig_fb = trainer.forward_backward
    class_images = np.asarray(data["class_images"], np.float32)

    def rec_fb(batch):
        i = it["i"]
        labels = np.asarray(batch["label"])
        np.testing.assert_array_equal(np.sort(labels), data["batch_labels_sorted"][i])
        grp = labels.reshape(N_CLS, N_INS)
        assert (grp == grp[:, :1]).all()
        if i == 0:
            imgs = np.asarray(batch["img"]).reshape(N_CLS, N_INS, 3, SIZE, SIZE)[:, 0]
            np.testing.assert_allclose(imgs[np.argsort(grp[:, 0])], class_images,
                                       atol=2e-3, rtol=0)
        assert trainer.lr_table[trainer.epoch] == pytest.approx(data["lrs"][i], rel=1e-12)
        out = orig_fb(batch)
        losses.append(out["loss"])
        it["i"] += 1
        return out

    monkeypatch.setattr(trainer, "forward_backward", rec_fb)

    names_box, logits_box, tlabels = [], [], []
    orig_mi = trainer.model_inference

    def rec_mi(batch, scale_no=0):
        out = orig_mi(batch, scale_no=scale_no)
        names_box.extend("/".join(p.rsplit("/", 2)[-2:]) for p in batch["impath"])
        logits_box.append(np.asarray(out))
        tlabels.extend(np.asarray(batch["label"]).tolist())
        return out

    monkeypatch.setattr(trainer, "model_inference", rec_mi)
    results_box = {}
    orig_ev = trainer.evaluator.evaluate

    def rec_ev():
        res = orig_ev()
        results_box.update(res)
        return res

    monkeypatch.setattr(trainer.evaluator, "evaluate", rec_ev)

    trainer.train()  # the whole loop; after_train runs test() (NO_TEST off)

    assert it["i"] == EPOCHS * BATCHES
    assert trainer.py_rng.i == EPOCHS * BATCHES
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-4, atol=3e-6)

    ref_final = prompt_learner_params_from_state_dict(torch_sd("pl_final"), 4)
    got = dict(ckpt.named_leaves(trainer.agg_params))
    for key, ref in ckpt.named_leaves(ref_final):
        np.testing.assert_allclose(got[key].detach().numpy(), ref.numpy(), atol=5e-5,
                                   rtol=1e-3, err_msg=key)

    assert len(names_box) == 12
    lg = np.concatenate(logits_box, 0)
    order = np.argsort(np.asarray(names_box))
    names = [names_box[i] for i in order]
    lg = lg[order]
    lb = np.asarray(tlabels, np.int32)[order]
    np.testing.assert_array_equal(np.asarray(names), data["test_names"])
    np.testing.assert_array_equal(lb, data["test_labels"])
    np.testing.assert_allclose(lg, data["test_logits"], atol=3e-4, rtol=1e-3)
    assert float(data["margin"]) > 20 * 3e-4  # argmax can't flip
    np.testing.assert_array_equal(lg.argmax(1), data["test_preds"])

    ref_acc, ref_err, ref_f1 = data["results"]
    assert results_box["accuracy"] == pytest.approx(ref_acc, rel=1e-9)
    assert results_box["error_rate"] == pytest.approx(ref_err, rel=1e-9)
    assert results_box["macro_f1"] == pytest.approx(ref_f1, rel=1e-9)

    exp = torch.load(osp.join(cfg.OUTPUT_DIR, "mm_classifiers.pt"), map_location="cpu",
                     weights_only=False)
    for key, tol in (("text_classifier", 2e-4), ("vision_classifier", 2e-4),
                     ("mm_classifier", 2e-4), ("fusion_weight", 1e-5)):
        np.testing.assert_allclose(exp[key].float().numpy(), data[f"export.{key}"],
                                   atol=tol, rtol=1e-3, err_msg=key)
    vt = torch.load(osp.join(cfg.OUTPUT_DIR, "visual_tokens.pt"), map_location="cpu",
                    weights_only=False)
    np.testing.assert_allclose(vt["visual_tokens"].float().numpy(),
                               data["export.visual_tokens"], atol=2e-4, rtol=1e-3)


def _tiny_cfg(tmp_path, make=get_cfg_default, **over):
    """MM_CLS_OP at TINY on the CPU over a small Synthetic dataset; with the
    JAX package's ``make`` the device keys go to its TPU node."""
    cfg = make()
    device = {"DTYPE": "float32", "DEVICE": "cpu"}
    settings = {
        "OUTPUT_DIR": str(tmp_path / "out"), "SEED": 1, "DATASET.ROOT": str(tmp_path / "data"),
        "DATASET.NAME": "Synthetic", "DATASET.NUM_SHOTS": 4, "INPUT.SIZE": (32, 32),
        "INPUT.TRANSFORMS": ("normalize",), "DATALOADER.TRAIN_X.SAMPLER": "RandomClassSampler",
        "DATALOADER.TRAIN_X.BATCH_SIZE": 8, "DATALOADER.TRAIN_X.N_INS": 4,
        "DATALOADER.TEST.BATCH_SIZE": 8, "DATALOADER.NUM_WORKERS": 2,
        "MODEL.BACKBONE.NAME": "TINY", "TRAINER.NAME": "MM_CLS_OP",
        "TRAINER.COCOOP.N_CTX": 2, "OPTIM.MAX_EPOCH": 1, "TEST.NO_TEST": True,
    }
    settings.update(over)
    if "CUDA" in cfg:
        settings.update({f"CUDA.{k}": v for k, v in device.items() if f"CUDA.{k}" not in over})
    else:
        cfg.TPU.DTYPE = device["DTYPE"]
    for key, value in settings.items():
        node, *path = key.split(".")
        target = cfg
        for part in [node, *path][:-1]:
            target = target[part]
        target[key.split(".")[-1]] = value
    return cfg


def test_split_points_follow_the_jax_trainer(tmp_path, monkeypatch):
    from ovmr_tpu.engine import register_all_trainers
    from ovmr_tpu.engine.train_step import sample_split_point as j_sample_split_point
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch.engine.train_step import sample_split_point

    register_all_trainers()
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    for seed in (1, 7, -1):
        port = build_trainer(_tiny_cfg(tmp_path, SEED=seed))
        jax_trainer = j_build_trainer(_tiny_cfg(tmp_path, j_cfg, SEED=seed))
        for n_ins in (4, 8, 16, 4):
            got = [sample_split_point(port.py_rng, n_ins) for _ in range(25)]
            want = [j_sample_split_point(jax_trainer.py_rng, n_ins) for _ in range(25)]
            assert got == want, (seed, n_ins)


def test_two_epochs_equal_one_epoch_and_a_resume(tmp_path, monkeypatch):
    """Dropout 0 and recorded split points, over the DTD fixture, whose
    images are identical within a class: the resumed run's loader restarts
    its stream, as the reference's does (``dassl/engine/trainer.py:403-407``
    resumes the model and optimizer only), so the only difference a batch
    can show is the order of its class groups. The resume must bring back
    the parameters, adam's moments and its step count."""
    data = np.load(FIXTURE)
    base_lr, cons_lr, wd, _ = data["optim_scalars"]
    splits = [int(s) for s in data["splits"][:4]]
    _no_dropout(monkeypatch)
    root = tmp_path / "data"
    shutil.copytree(DATA_ROOT, root)

    def run(out, epochs, split_seq):
        trainer = build_trainer(_dtd_cfg(tmp_path, root, out, epochs, base_lr, cons_lr, wd))
        trainer.py_rng = _SplitReplay(split_seq)
        losses = []
        orig = trainer.forward_backward

        def fb(batch):
            out_ = orig(batch)
            losses.append(out_["loss"])
            return out_

        monkeypatch.setattr(trainer, "forward_backward", fb)
        trainer.train()
        return trainer, losses

    whole, whole_losses = run(tmp_path / "a", 2, splits)
    _, first_losses = run(tmp_path / "b", 1, splits[:2])
    saved = np.load(tmp_path / "b" / "prompt_learner" / "model-1.npz")
    resumed, resumed_losses = run(tmp_path / "b", 2, splits[2:])
    assert resumed.start_epoch == 1
    np.testing.assert_array_equal(first_losses, whole_losses[:2])
    np.testing.assert_allclose(resumed_losses, whole_losses[2:], rtol=1e-4, atol=3e-6)
    got = dict(ckpt.named_leaves(resumed.agg_params))
    for key, leaf in ckpt.named_leaves(whole.agg_params):
        np.testing.assert_allclose(got[key].detach().numpy(), leaf.detach().numpy(),
                                   atol=5e-5, rtol=1e-3, err_msg=key)
        state = resumed.optimizer.state[got[key]]
        assert float(state["step"]) == 4.0, key
    # the epoch-1 checkpoint held adam's state after two steps
    assert int(saved["opt//.inner_state//1//.count"]) == 2


def _dtd_cfg(tmp_path, root, out, epochs, base_lr, cons_lr, wd):
    cfg = _tiny_cfg(tmp_path)
    cfg.OUTPUT_DIR = str(out)
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = "DescribableTextures"
    cfg.DATASET.NUM_SHOTS = NUM_SHOTS
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = N_CLS * N_INS
    cfg.DATALOADER.TRAIN_X.N_INS = N_INS
    cfg.OPTIM.NAME = "adam"
    cfg.OPTIM.LR = float(base_lr)
    cfg.OPTIM.WEIGHT_DECAY = float(wd)
    cfg.OPTIM.MAX_EPOCH = epochs
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.OPTIM.WARMUP_CONS_LR = float(cons_lr)
    cfg.TRAIN.CHECKPOINT_FREQ = 1
    return cfg


def test_cli_trains_then_evaluates(tmp_path):
    """``python -m ovmr_tpu_torch.train`` as the verify skill drives
    ``train.py``: one epoch, then ``--eval-only`` fusion."""
    opts = ["DATASET.NAME", "Synthetic", "DATASET.NUM_SHOTS", "4", "INPUT.SIZE", "(32,32)",
            "INPUT.TRANSFORMS", '["normalize"]', "DATALOADER.TRAIN_X.SAMPLER",
            "RandomClassSampler", "DATALOADER.TRAIN_X.BATCH_SIZE", "16",
            "DATALOADER.TRAIN_X.N_INS", "4", "DATALOADER.TEST.BATCH_SIZE", "16",
            "DATALOADER.NUM_WORKERS", "2", "MODEL.BACKBONE.NAME", "TINY", "OPTIM.MAX_EPOCH",
            "1", "TRAIN.CHECKPOINT_FREQ", "1", "TPU.DTYPE", "float32", "CUDA.DEVICE", "cpu"]
    env = dict(os.environ, OVMR_SYNTHETIC="8,8,32")
    common = [sys.executable, "-m", "ovmr_tpu_torch.train", "--root", str(tmp_path / "data"),
              "--seed", "1", "--trainer", "MM_CLS_OP", "--n_ctx", "2"]
    train = subprocess.run(
        common + ["--output-dir", str(tmp_path / "train_out")] + opts + ["TEST.NO_TEST", "True"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    assert "Finish training" in train.stdout
    pl = tmp_path / "train_out" / "prompt_learner"
    for name in ("model-1.npz", "model.pth.tar-1", "checkpoint"):
        assert (pl / name).is_file(), name
    assert (tmp_path / "train_out" / "log.txt").is_file()

    ev = subprocess.run(
        common + ["--output-dir", str(tmp_path / "eval_out"), "--model-dir",
                  str(tmp_path / "train_out"), "--load-epoch", "1", "--eval-only",
                  "--eval_mode", "fusion", "--eval_tau", "10"] + opts,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert ev.returncode == 0, ev.stderr[-3000:]
    assert "=> result" in ev.stdout and "* accuracy:" in ev.stdout
    assert "(epoch = 1)" in ev.stdout
    out = tmp_path / "eval_out"
    for name in ("mm_classifiers.pt", "visual_tokens.pt", "acc_per_class.csv",
                 "f1_per_class.csv", "log.txt"):
        assert (out / name).is_file(), name
    assert "=> result" in (out / "log.txt").read_text()
    art = torch.load(out / "mm_classifiers.pt", weights_only=False)
    assert sorted(art) == ["fusion_weight", "mm_classifier", "text_classifier",
                           "vision_classifier"]
    assert art["mm_classifier"].shape == (8, 64)
    np.testing.assert_allclose(art["fusion_weight"].sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("key,value,match", [
    ("CUDA.DEVICE_AUGS", True, "item 1b'"),
    ("DATASET.REGION_AUG", True, "item 1b'"),
    ("CUDA.MESH.MODEL", 2, "item 4"),
    ("MODEL.BACKBONE.NAME", "RN50", "item 5"),
])
def test_trainer_refuses_what_waits(tmp_path, monkeypatch, key, value, match):
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    with pytest.raises(NotImplementedError, match=match):
        build_trainer(_tiny_cfg(tmp_path, **{key: value}))


def test_trainer_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(_tiny_cfg(tmp_path, **{"CUDA.DEVICE": "cuda"}))


def test_eval_mode_is_checked_before_generation(tmp_path, monkeypatch):
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    trainer = build_trainer(_tiny_cfg(tmp_path, EVAL_MODE="nope"))
    with pytest.raises(ValueError, match="unknown EVAL_MODE"):
        trainer.test()
    assert trainer.classifiers is None
