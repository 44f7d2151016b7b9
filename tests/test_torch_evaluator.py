"""The port's utilities and evaluator against the JAX package's: meters,
registry and tools, and ``Classification`` on seeded predictions (the
result dict equal, the per-class CSVs byte-equal, the printed ``=> result``
block equal, the per-class breakdown and the confusion matrix)."""

import os

import numpy as np
import pytest
import torch

from ovmr_tpu.evaluation.evaluator import Classification as JClassification
from ovmr_tpu.utils import meters as jmeters
from ovmr_tpu.utils import registry as jregistry
from ovmr_tpu.utils import tools as jtools
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.evaluation import build_evaluator
from ovmr_tpu_torch.evaluation.evaluator import Classification
from ovmr_tpu_torch.utils import (
    AverageMeter,
    MetricMeter,
    Registry,
    check_availability,
    collect_env_info,
    get_cfg_default,
    listdir_nohidden,
    mkdir_if_missing,
    read_image,
    set_random_seed,
)


def test_meters_match_the_jax_packages():
    rng = np.random.default_rng(0)
    values = rng.standard_normal(20).tolist()
    for ema in (False, True):
        a, b = AverageMeter(ema=ema), jmeters.AverageMeter(ema=ema)
        for i, v in enumerate(values):
            a.update(v, n=1 + i % 3)
            b.update(v, n=1 + i % 3)
            assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)
    m, jm = MetricMeter(), jmeters.MetricMeter()
    for v in values:
        m.update({"loss": v, "lr": 2e-4})
        jm.update({"loss": v, "lr": 2e-4})
    assert str(m) == str(jm)
    m.update(None)
    assert str(m) == str(jm)


def test_registry_matches_the_jax_packages():
    for reg_cls in (Registry, jregistry.Registry):
        reg = reg_cls("THING")

        @reg.register()
        class A:
            pass

        reg.register_alias("B", A)
        assert reg.get("A") is A and reg.get("B") is A and "A" in reg
        assert list(reg.registered_names()) == ["A", "B"]
        with pytest.raises(KeyError, match="already registered"):
            reg.register(A)
        with pytest.raises(KeyError, match="does not exist"):
            reg.get("C")
    check_availability("a", ["a", "b"])
    with pytest.raises(ValueError):
        check_availability("c", ["a", "b"])


def test_tools_match_the_jax_packages(tmp_path):
    from PIL import Image

    d = tmp_path / "a" / "b"
    mkdir_if_missing(str(d))
    mkdir_if_missing(str(d))
    for name in ("z.png", "a.png", ".hidden"):
        (d / name).write_bytes(b"")
    assert listdir_nohidden(str(d), sort=True) == jtools.listdir_nohidden(str(d), sort=True)
    assert listdir_nohidden(str(d), sort=True) == ["a.png", "z.png"]
    rgb = (np.random.default_rng(1).random((9, 7, 3)) * 255).astype(np.uint8)
    for mode, arr in (("RGB", rgb), ("L", rgb[..., 0])):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr, mode).save(path)
        np.testing.assert_array_equal(np.asarray(read_image(path)),
                                      np.asarray(jtools.read_image(path)))
    with pytest.raises(IOError):
        read_image(str(tmp_path / "missing.png"))
    set_random_seed(3)
    a = (np.random.rand(), torch.rand(2))
    set_random_seed(3)
    assert a[0] == np.random.rand() and torch.equal(a[1], torch.rand(2))
    info = collect_env_info()
    assert f"torch: {torch.__version__}" in info and "jax" not in info


def _seeded_predictions(seed, n, n_cls, present_only):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_cls, n)
    if present_only:  # some classes absent from y_true
        labels = labels % max(n_cls - 2, 1)
    logits = rng.standard_normal((n, n_cls)).astype(np.float32)
    # make about half the predictions right
    hit = rng.random(n) < 0.5
    logits[hit, labels[hit]] += 10.0
    return logits, labels


@pytest.mark.parametrize("seed,n,n_cls,present_only,per_class,topk", [
    (0, 37, 5, False, False, 1),
    (1, 200, 12, True, True, 1),
    (2, 64, 7, False, True, 3),
    (3, 11, 30, True, False, 1),
])
def test_evaluator_matches_the_jax_packages(tmp_path, capsys, seed, n, n_cls, present_only,
                                            per_class, topk):
    outputs = {}
    for name, make_cfg, cls in (("port", get_cfg_default, Classification),
                                ("jax", j_cfg, JClassification)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        cfg = make_cfg()
        cfg.OUTPUT_DIR = str(out_dir)
        cfg.TEST.PER_CLASS_RESULT = per_class
        cfg.TEST.COMPUTE_CMAT = True
        lab2cname = {i: f"class {i}" for i in range(n_cls)}
        ev = cls(cfg, lab2cname=lab2cname)
        logits, labels = _seeded_predictions(seed, n, n_cls, present_only)
        # batches of 16, as a loader delivers them
        for s in range(0, n, 16):
            ev.process(logits[s:s + 16], labels[s:s + 16], topk=topk)
        capsys.readouterr()
        results = ev.evaluate()
        printed = capsys.readouterr().out.replace(str(out_dir), "OUT")
        files = {f: (out_dir / f).read_bytes() for f in ("acc_per_class.csv", "f1_per_class.csv")}
        cmat = torch.load(out_dir / "cmat.pt", weights_only=False)
        outputs[name] = (dict(results), printed, files, np.asarray(cmat))
    port, jax_out = outputs["port"], outputs["jax"]
    assert port[0] == jax_out[0]
    assert port[1] == jax_out[1]
    assert "=> result" in port[1] and "* accuracy:" in port[1]
    assert port[2] == jax_out[2]
    np.testing.assert_array_equal(port[3], jax_out[3])


def test_build_evaluator_and_reset(tmp_path):
    cfg = get_cfg_default()
    cfg.OUTPUT_DIR = str(tmp_path)
    ev = build_evaluator(cfg, lab2cname={0: "a"})
    assert isinstance(ev, Classification)
    ev.process(np.asarray([[1.0, 0.0]]), np.asarray([0]))
    ev.reset()
    ev.process(np.asarray([[0.0, 1.0]]), np.asarray([0]))
    assert ev.evaluate()["accuracy"] == 0.0
    assert sorted(os.listdir(tmp_path)) == ["acc_per_class.csv", "f1_per_class.csv"]
