"""The port's DG dataset loaders give the JAX loaders' ``Datum`` lists.

On small trees in the reference's layouts, written by the test (the
loaders only list paths, so empty files do; the template is
``tests/test_dassl_datasets.py``): PACS, VLCS, DigitsDG, OfficeHomeDG,
DigitSingle, CIFAR10C/100C, the WILDS trio's ``zhou_preloaded.pkl`` split
cache (written by either package, and its refusal without one) and
``SyntheticDA``; then the DAELDG loader's strong view ``img2`` against the
JAX loader's.
"""

import os
import os.path as osp
import pickle
import random

import numpy as np
import pytest

from ovmr_tpu.data.datum import Datum as JDatum
from ovmr_tpu.data.registry import build_dataset as j_build_dataset
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.data.datum import Datum
from ovmr_tpu_torch.data.registry import build_dataset
from ovmr_tpu_torch.utils import get_cfg_default


def _cfgs(root, name, source=(), target=(), **dataset):
    out = []
    for make in (get_cfg_default, j_cfg):
        cfg = make()
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.NAME = name
        cfg.DATASET.SOURCE_DOMAINS = tuple(source)
        cfg.DATASET.TARGET_DOMAINS = tuple(target)
        for k, v in dataset.items():
            setattr(cfg.DATASET, k, v)
        cfg.SEED = 1
        out.append(cfg)
    return out


def touch(*path):
    p = osp.join(*path)
    os.makedirs(osp.dirname(p), exist_ok=True)
    open(p, "w").close()
    return p


def _rows(items):
    return [(d.impath, d.label, d.domain, d.classname) for d in items]


def assert_same_dataset(port, jax_ds):
    for split in ("train_x", "val", "test"):
        assert _rows(getattr(port, split)) == _rows(getattr(jax_ds, split)), split
    assert port.num_classes == jax_ds.num_classes
    assert port.classnames == jax_ds.classnames


def build_both(root, name, source=(), target=(), **dataset):
    port_cfg, jax_cfg = _cfgs(root, name, source, target, **dataset)
    random.seed(0)
    port = build_dataset(port_cfg)
    random.seed(0)
    jax_ds = j_build_dataset(jax_cfg)
    assert_same_dataset(port, jax_ds)
    return port


def make_pacs(root, domains=("photo", "sketch"), n=3):
    for dname in domains:
        for split in ("train", "crossval"):
            lines = []
            for i in range(n):
                rel = f"{dname}/{('dog', 'horse')[i % 2]}/im_{split}_{i}.png"
                touch(root, "pacs", "images", rel)
                lines.append(f"{rel} {i + 1}")  # kfold labels are 1-based
            if dname == "sketch" and split == "train":
                lines.append("sketch/dog/n02103406_4068-1.png 1")  # the skipped path
            with open(touch(root, "pacs", "splits", f"{dname}_{split}_kfold.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")


def make_digit5(root, domains=("mnist", "usps"), n=5):
    for dname in domains:
        for split_dir in ("train_images", "test_images"):
            for i in range(n):
                touch(root, "digit5", dname, split_dir, f"im{i}_{i % 3}.png")


def test_pacs(tmp_path):
    make_pacs(tmp_path)
    ds = build_both(tmp_path, "PACS", ["photo"], ["sketch"])
    assert len(ds.test) == 6 and not any("n02103406_4068-1" in d.impath for d in ds.test)
    with pytest.raises(FileNotFoundError, match="kfold"):
        build_dataset(_cfgs(tmp_path, "PACS", ["cartoon"], ["sketch"])[0])
    with pytest.raises(ValueError, match="must belong"):
        build_dataset(_cfgs(tmp_path, "PACS", ["nope"], ["sketch"])[0])


def test_vlcs(tmp_path):
    for dname in ("CALTECH", "SUN"):
        for split in ("train", "crossval", "test"):
            for cname in ("bird", "car"):
                for i in range(2):
                    touch(tmp_path, "VLCS", dname, split, cname, f"im{i}.jpg")
    build_both(tmp_path, "VLCS", ["caltech"], ["sun"])


@pytest.mark.parametrize("name,dsdir,domains", [("DigitsDG", "digits_dg", ("mnist", "syn")),
                                                ("OfficeHomeDG", "office_home_dg",
                                                 ("art", "clipart"))])
def test_class_folder_layouts(tmp_path, name, dsdir, domains):
    for dname in domains:
        for split in ("train", "val"):
            for cname in ("Alpha", "Beta"):
                for i in range(2):
                    touch(tmp_path, dsdir, dname, split, cname, f"im{i}.jpg")
    build_both(tmp_path, name, [domains[0]], [domains[1]])
    with pytest.raises(FileNotFoundError, match="expected layout"):
        build_dataset(_cfgs(tmp_path / "empty", name, [domains[0]], [domains[1]])[0])


def test_digit_single(tmp_path):
    make_digit5(tmp_path)
    build_both(tmp_path, "DigitSingle", ["usps"], ["mnist"])


@pytest.mark.parametrize("name,src,tgt", [("CIFAR10C", "cifar10", "cifar10_c"),
                                          ("CIFAR100C", "cifar100", "cifar100_c")])
def test_cifar_c(tmp_path, name, src, tgt):
    for cname in ("airplane", "cat"):
        for i in range(2):
            touch(tmp_path, src, "train", cname, f"im{i}.png")
            touch(tmp_path, tgt, "fog", "3", cname, f"im{i}.png")
    build_both(tmp_path, name, [src], [tgt], CIFAR_C_TYPE="fog", CIFAR_C_LEVEL=3)
    for bad, match in (({"CIFAR_C_TYPE": ""}, "CIFAR_C_TYPE"),
                       ({"CIFAR_C_TYPE": "nope"}, "C_TYPE"),
                       ({"CIFAR_C_TYPE": "fog", "CIFAR_C_LEVEL": 9}, "CIFAR_C_LEVEL")):
        with pytest.raises(ValueError, match=match):
            build_dataset(_cfgs(tmp_path, name, [src], [tgt], **bad)[0])


def _wilds_items(root, dsdir, datum, n_domains=3):
    names = {0: "healthy tissue", 1: "tumor tissue"}
    items = {"train": [], "val": [], "test": []}
    for split, k in (("train", 4), ("val", 2), ("test", 2)):
        for dom in range(n_domains):
            for i in range(k):
                items[split].append(datum(impath=osp.join(str(root), dsdir, f"{split}_{dom}_{i}.png"),
                                          label=i % 2, domain=dom, classname=names[i % 2]))
    return items


@pytest.mark.parametrize("shots", [-1, 1])
def test_wilds_cache_written_by_the_jax_package(tmp_path, shots):
    items = _wilds_items(tmp_path, "camelyon17_v1.0", JDatum)
    os.makedirs(tmp_path / "camelyon17_v1.0")
    with open(tmp_path / "camelyon17_v1.0" / "zhou_preloaded.pkl", "wb") as f:
        pickle.dump(items, f)
    ds = build_both(tmp_path, "Camelyon17", NUM_SHOTS=shots)
    assert ds.classnames == ["healthy tissue", "tumor tissue"]


def test_wilds_cache_written_by_the_port_reads_in_jax(tmp_path, monkeypatch):
    from ovmr_tpu_torch.data.datasets import dg

    items = _wilds_items(tmp_path, "camelyon17_v1.0", Datum)
    os.makedirs(tmp_path / "camelyon17_v1.0")
    monkeypatch.setattr(dg.WILDSBase, "_build_from_wilds",
                        lambda self, name, root: (items["train"], items["val"], items["test"]))
    port = build_dataset(_cfgs(tmp_path, "Camelyon17")[0])
    # the port wrote plain dicts: the JAX package reads them without the port
    with open(tmp_path / "camelyon17_v1.0" / "zhou_preloaded.pkl", "rb") as f:
        assert all(isinstance(d, dict) for d in pickle.load(f)["train"])
    assert_same_dataset(port, j_build_dataset(_cfgs(tmp_path, "Camelyon17")[1]))


def test_wilds_refusals_and_classnames(tmp_path):
    from ovmr_tpu.data.datasets import dg as jdg
    from ovmr_tpu_torch.data.datasets import dg

    os.makedirs(tmp_path / "camelyon17_v1.0")
    with pytest.raises(FileNotFoundError, match="zhou_preloaded"):
        build_dataset(_cfgs(tmp_path, "Camelyon17")[0])
    assert dg.FMoW.load_classnames(dg.FMoW.__new__(dg.FMoW)) == jdg.FMoW.load_classnames(
        jdg.FMoW.__new__(jdg.FMoW))
    obj = dg.IWildCam.__new__(dg.IWildCam)
    obj.dataset_dir = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="categories.csv"):
        obj.load_classnames()
    with open(tmp_path / "categories.csv", "w") as f:
        f.write("category_id,name\n7,empty\n24,deer\n")
    assert obj.load_classnames() == {0: "empty", 1: "deer"}


def test_synthetic_da_and_the_strong_view(tmp_path, monkeypatch):
    """SyntheticDA's splits, and the DAELDG loader (RandomDomainSampler,
    the strong transform's ``img2``, the source-domain count) against the
    JAX DataManager's batches."""
    from ovmr_tpu.data.manager import DataManager as JDataManager
    from ovmr_tpu.data.transforms import build_transform as j_build_transform
    from ovmr_tpu_torch.data.manager import DataManager
    from ovmr_tpu_torch.data.transforms import build_transform

    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    port_cfg, jax_cfg = _cfgs(tmp_path, "SyntheticDA", ("a", "b"))
    port, jax_ds = build_dataset(port_cfg), j_build_dataset(jax_cfg)
    assert_same_dataset(port, jax_ds)
    assert _rows(port.train_u) == _rows(jax_ds.train_u)
    strong = ["random_flip", "cutout", "randaugment2", "normalize"]
    managers = []
    for cfg, manager, tfm in ((port_cfg, DataManager, build_transform),
                              (jax_cfg, JDataManager, j_build_transform)):
        cfg.INPUT.SIZE = (32, 32)
        cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomDomainSampler"
        cfg.DATALOADER.TRAIN_X.N_DOMAIN = 2
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
        cfg.DATALOADER.NUM_WORKERS = 2
        managers.append(manager(cfg, tfm_train_strong=tfm(cfg, is_train=True, choices=strong)))
    assert managers[0].num_source_domains == managers[1].num_source_domains == 2
    for a, b in zip(managers[0].train_loader_x, managers[1].train_loader_x):
        for key in ("img", "img2", "label", "domain"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
