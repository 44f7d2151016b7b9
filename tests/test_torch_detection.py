"""The port's LVIS / COCO exemplar-crop loaders against the JAX package's,
on trees the tests write in the layout of
``tests/test_detection_datasets.py``: the same Datums, class names and
splits, the rare-index base/new split, the OVD split swap, and class lists
equal to the JAX module's."""

import os
import os.path as osp
import random

import numpy as np
import pytest
from PIL import Image

from ovmr_tpu.data.datasets import detection as jdetection
from ovmr_tpu.data.datasets import lvis_coco_classes as jclasses
from ovmr_tpu.utils.defaults import get_cfg_default as j_get_cfg_default
from ovmr_tpu_torch.data import build_dataset
from ovmr_tpu_torch.data.datasets import detection, lvis_coco_classes
from ovmr_tpu_torch.data.datum import Datum
from ovmr_tpu_torch.utils import get_cfg_default


def make_exemplar_tree(root, dataset_dir, labels, per_split=3, size=8):
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        for label in labels:
            d = osp.join(root, dataset_dir, split, str(label))
            os.makedirs(d, exist_ok=True)
            for i in range(per_split):
                Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
                    osp.join(d, f"crop{i}.jpg"))


def both(root, name, shots=-1, subsample="all"):
    """The port's dataset and the JAX one for the same settings; the
    few-shot draws use python's global ``random``, seeded the same for
    each."""
    out = []
    for make, build in ((get_cfg_default, build_dataset),
                        (j_get_cfg_default, lambda c: getattr(jdetection, name)(c))):
        cfg = make()
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.NAME = name
        cfg.DATASET.NUM_SHOTS = shots
        cfg.DATASET.SUBSAMPLE_CLASSES = subsample
        cfg.SEED = 1
        random.seed(5)
        out.append(build(cfg))
    return out


def rows(items):
    return [(d.impath, d.label, d.classname) for d in items]


def assert_same(port, ref):
    assert port.classnames == ref.classnames and port.lab2cname == ref.lab2cname
    for split in ("train_x", "val", "test", "eval_set"):
        assert rows(getattr(port, split)) == rows(getattr(ref, split)), split


def test_class_lists_equal_the_jax_module():
    assert lvis_coco_classes.LVIS_CLASSES == jclasses.LVIS_CLASSES
    assert len(lvis_coco_classes.LVIS_CLASSES) == 1203
    assert lvis_coco_classes.LVIS_RARE_INDEX == jclasses.LVIS_RARE_INDEX
    assert lvis_coco_classes.COCO_CLASSES == jclasses.COCO_CLASSES
    assert len(lvis_coco_classes.COCO_CLASSES) == 80


@pytest.mark.parametrize("subsample", ["all", "base", "new"])
def test_lvis_matches_jax(tmp_path, subsample):
    rare = jclasses.LVIS_RARE_INDEX[:2]
    common = [i for i in range(30) if i not in jclasses.LVIS_RARE_INDEX][:2]
    labels = sorted(rare + common)
    make_exemplar_tree(tmp_path, "lvis_exemplars_mmovod_K30", labels)
    port, ref = both(tmp_path, "LVIS", subsample=subsample)
    assert isinstance(port, detection.LVIS)
    assert_same(port, ref)
    want = {"all": labels, "base": common, "new": rare}[subsample]
    assert {d.classname for d in port.train_x} == {
        lvis_coco_classes.LVIS_CLASSES[i] for i in want}
    if subsample != "all":  # relabelled dense from 0
        assert sorted({d.label for d in port.train_x}) == [0, 1]


@pytest.mark.parametrize("shots", [2, 5])
def test_lvis_few_shot_and_the_ovd_split_swap(tmp_path, shots):
    """NUM_SHOTS 5 with subsample 'all' swaps train and test (the OVD
    export regime, reference lvis.py:70-73); 2 shots does not."""
    make_exemplar_tree(tmp_path, "lvis_exemplars_mmovod_K30", [0, 1], per_split=6)
    port, ref = both(tmp_path, "LVIS", shots=shots)
    assert_same(port, ref)
    swapped = shots == 5
    assert all(("/val/" in d.impath) == swapped for d in port.train_x)
    assert all(("/train/" in d.impath) == swapped for d in port.test)
    assert len(port.test if swapped else port.train_x) == 2 * shots


def test_coco_matches_jax(tmp_path):
    make_exemplar_tree(tmp_path, "coco_exemplars_mmovod_K30_final", [0, 1, 2])
    port, ref = both(tmp_path, "COCO")
    assert isinstance(port, detection.COCO)
    assert_same(port, ref)
    assert port.num_classes == 3
    assert port.classnames == lvis_coco_classes.COCO_CLASSES[:3]
    with pytest.raises(NotImplementedError, match="COCO base/new"):
        both(tmp_path, "COCO", subsample="base")


def test_subsample_lvis_classes_matches_jax():
    items = [Datum(impath=f"p{i}", label=i % 6, classname=f"c{i % 6}") for i in range(18)]
    for subsample in ("all", "base", "new"):
        got = detection.subsample_lvis_classes(items, items[:6], subsample=subsample,
                                               novel_index=[1, 4])
        want = jdetection.subsample_lvis_classes(items, items[:6], subsample=subsample,
                                                 novel_index=[1, 4])
        assert [rows(s) for s in got] == [rows(s) for s in want]
    with pytest.raises(ValueError, match="subsample"):
        detection.subsample_lvis_classes(items, subsample="rare")
    with pytest.raises(ValueError, match="novel class indices"):
        detection.subsample_lvis_classes(items, subsample="new")
