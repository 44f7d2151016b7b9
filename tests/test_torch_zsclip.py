"""The port's zero-shot trainers (``ovmr_tpu_torch/engine/zsclip.py``) against
the JAX package's (``ovmr_tpu/engine/zsclip.py``) on the CPU at fp32.

- the template lists of both trainers equal JAX's for every dataset of
  ``CUSTOM_TEMPLATES`` and an unknown one (ImageNet skips its custom
  template in ``ZeroshotCLIP2``), and the port's template constants are
  the JAX package's;
- the text classifiers equal JAX's within 1e-5, ImageNet included;
- through ``build_trainer`` on ``Synthetic``: the scores of a test batch
  within 1e-4 of JAX's (logit scale ~14 x unit features), and
  ``python -m ovmr_tpu_torch.train --trainer ZeroshotCLIP2``'s ``train()``
  runs ``test()``;
- the entry point builds ``CoOp``, ``MM_CLS``, ``ZeroshotCLIP`` and
  ``ZeroshotCLIP2`` on the CPU when asked, and on the card by default.

The towers come from one TINY reference state dict through
``OVMR_CLIP_CKPT`` for both packages.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.engine.zsclip import ZeroshotCLIP, ZeroshotCLIP2
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")
CLASSNAMES = ["red_panda", "golden retriever", "sports car", "tabby cat", "fire truck"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clip_pt(tmp_path_factory):
    data = np.load(TRAJ)
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(data[k]))
                for k in data.files if k.startswith("clip.")}, path)
    return str(path)


class _DM:
    def __init__(self, classnames):
        self.dataset = type("DS", (), {"classnames": list(classnames)})()


def _pair(name, dataset, monkeypatch, clip_pt):
    from ovmr_tpu.engine import zsclip as jzs
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    out = []
    for cls, cfg in ((dict(ZeroshotCLIP=ZeroshotCLIP, ZeroshotCLIP2=ZeroshotCLIP2)[name],
                      get_cfg_default()), (getattr(jzs, name), j_cfg())):
        cfg.DATASET.NAME = dataset
        if hasattr(cfg, "CUDA"):
            cfg.CUDA.DTYPE, cfg.CUDA.DEVICE = "float32", "cpu"
        else:
            cfg.TPU.DTYPE = "float32"
        trainer = cls.__new__(cls)
        trainer.cfg, trainer.dm = cfg, _DM(CLASSNAMES)
        out.append(trainer)
    return out


def test_template_constants_are_the_jax_packages():
    from ovmr_tpu import text as jtext
    from ovmr_tpu_torch import text

    assert text.IMAGENET_TEMPLATES == jtext.IMAGENET_TEMPLATES
    assert text.IMAGENET_TEMPLATES_SELECT == jtext.IMAGENET_TEMPLATES_SELECT
    assert text.CUSTOM_TEMPLATES == jtext.CUSTOM_TEMPLATES
    assert len(text.IMAGENET_TEMPLATES) == 80 and len(text.IMAGENET_TEMPLATES_SELECT) == 7


@pytest.mark.parametrize("name", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_templates_equal_jax(name, monkeypatch, clip_pt):
    from ovmr_tpu_torch.text import CUSTOM_TEMPLATES

    for dataset in sorted(CUSTOM_TEMPLATES) + ["Synthetic"]:
        port, jtr = _pair(name, dataset, monkeypatch, clip_pt)
        assert port.get_templates() == jtr.get_templates(), dataset
    port, _ = _pair(name, "ImageNet", monkeypatch, clip_pt)
    assert len(port.get_templates()) == (7 if name == "ZeroshotCLIP2" else 1)


@pytest.mark.parametrize("name,dataset", [("ZeroshotCLIP", "OxfordPets"),
                                          ("ZeroshotCLIP2", "DescribableTextures"),
                                          ("ZeroshotCLIP2", "ImageNet")])
def test_text_classifier_matches_jax(name, dataset, monkeypatch, clip_pt):
    port, jtr = _pair(name, dataset, monkeypatch, clip_pt)
    port.build_model()
    jtr.build_model()
    assert port.text_classifier.shape == (len(CLASSNAMES), 128)
    np.testing.assert_allclose(np.linalg.norm(port.text_classifier, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(port.text_classifier, np.asarray(jtr.text_classifier), atol=1e-5)


def test_synthetic_scores_match_jax_and_train_runs_test(tmp_path, monkeypatch, clip_pt):
    from ovmr_tpu.engine import zsclip as _jzs  # noqa: F401  (registers)
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch import train as entry

    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    data, out = str(tmp_path / "data"), str(tmp_path / "zs")
    opts = ["DATASET.NAME", "Synthetic", "DATASET.NUM_SHOTS", "4", "INPUT.SIZE", "(64, 64)",
            "INPUT.TRANSFORMS", "['normalize']", "DATALOADER.TEST.BATCH_SIZE", "32",
            "DATALOADER.NUM_WORKERS", "2", "MODEL.BACKBONE.NAME", "TINY_64"]
    port = entry.main(entry.build_parser().parse_args(
        ["--root", data, "--seed", "1", "--trainer", "ZeroshotCLIP2", "--output-dir", out] + opts
        + ["CUDA.DEVICE", "cpu", "CUDA.DTYPE", "float32"]))
    assert type(port) is ZeroshotCLIP2
    log = open(osp.join(out, "log.txt")).read()
    assert "running test()" in log and "=> result" in log and "(eval mode: zero-shot)" in log

    jcfg = j_cfg()
    jcfg.merge_from_list(opts + ["TPU.DTYPE", "float32"])
    jcfg.DATASET.ROOT, jcfg.OUTPUT_DIR, jcfg.SEED = data, str(tmp_path / "jzs"), 1
    jcfg.TRAINER.NAME = "ZeroshotCLIP2"
    jtr = j_build_trainer(jcfg)
    np.testing.assert_allclose(port.text_classifier, np.asarray(jtr.text_classifier), atol=1e-5)
    jtr.prepare_test()
    batch = next(iter(port.dm.test_loader))
    np.testing.assert_allclose(port.model_inference(batch), jtr.model_inference(batch), atol=1e-4)


@pytest.mark.parametrize("name,cls", [("CoOp", "CoOp"), ("MM_CLS", "CoOp"),
                                      ("ZeroshotCLIP", "ZeroshotCLIP"),
                                      ("ZeroshotCLIP2", "ZeroshotCLIP2")])
def test_entry_point_builds_the_trainer_and_defaults_to_the_card(tmp_path, monkeypatch, clip_pt,
                                                                 name, cls):
    """``python -m ovmr_tpu_torch.train --trainer NAME`` builds the port's
    trainer on the CPU with ``CUDA.DEVICE cpu``; without it the trainer asks
    for the card, and raises where there is none."""
    from ovmr_tpu_torch import train as entry

    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    argv = ["--root", str(tmp_path / "data"), "--seed", "1", "--trainer", name, "--no-train",
            "--output-dir", str(tmp_path / "out"), "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", "2", "INPUT.SIZE", "(64, 64)", "MODEL.BACKBONE.NAME", "TINY_64",
            "TRAINER.COOP.N_CTX", "2", "DATALOADER.NUM_WORKERS", "1"]
    trainer = entry.main(entry.build_parser().parse_args(argv + ["CUDA.DEVICE", "cpu"]))
    assert type(trainer).__name__ == cls and trainer.device.type == "cpu"
    assert entry.setup_cfg(entry.build_parser().parse_args(argv)).CUDA.DEVICE == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(entry.build_parser().parse_args(argv))
