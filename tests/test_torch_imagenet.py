"""The port's ImageNet-family loaders against the JAX package's, on trees
the tests write in the layouts of ``tests/test_imagenet_loaders.py``: the
same Datums (path, label, class name), class names and splits, and the
same few-shot and preprocessed caches (each package reads the other's)."""

import os
import os.path as osp

import numpy as np
import pytest
from PIL import Image

from ovmr_tpu.data.datasets import imagenet as jimagenet
from ovmr_tpu.utils.defaults import get_cfg_default as j_get_cfg_default
from ovmr_tpu_torch.data import build_dataset
from ovmr_tpu_torch.data.datasets import imagenet
from ovmr_tpu_torch.data.datum import save_fewshot_pickle, Datum
from ovmr_tpu_torch.utils import get_cfg_default

FOLDERS = ["n01440764", "n01443537", "n01484850", "n01491361"]
NAMES = ["tench", "goldfish", "great white shark", "tiger shark"]


def write_images(d, n=3, size=12):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(len(d))
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
            osp.join(d, f"im{i}.JPEG"))


def write_classnames(base, folders=FOLDERS, names=NAMES):
    os.makedirs(base, exist_ok=True)
    with open(osp.join(base, "classnames.txt"), "w") as f:
        for folder, name in zip(folders, names):
            f.write(f"{folder} {name}\n")


def make_imagenet(root, dataset_dir="imagenet"):
    base = osp.join(root, dataset_dir)
    write_classnames(base)
    for split in ("train", "val"):
        for folder in FOLDERS:
            write_images(osp.join(base, "images", split, folder))


def cfgs(root, shots=2, subsample="all", name=""):
    out = []
    for make in (get_cfg_default, j_get_cfg_default):
        cfg = make()
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.NAME = name
        cfg.DATASET.NUM_SHOTS = shots
        cfg.DATASET.SUBSAMPLE_CLASSES = subsample
        cfg.SEED = 1
        out.append(cfg)
    return out


def rows(items):
    return [(d.impath, d.label, d.classname) for d in items] if items else items


def assert_same(port, ref):
    assert port.classnames == ref.classnames
    assert port.num_classes == ref.num_classes
    assert port.lab2cname == ref.lab2cname
    for split in ("train_x", "val", "test", "eval_set"):
        assert rows(getattr(port, split)) == rows(getattr(ref, split)), split


def test_read_classnames_and_folder_data(tmp_path):
    make_imagenet(tmp_path)
    base = osp.join(tmp_path, "imagenet")
    names = imagenet.read_classnames(osp.join(base, "classnames.txt"))
    assert names == jimagenet.read_classnames(osp.join(base, "classnames.txt"))
    assert list(names.values()) == NAMES
    got = imagenet.read_folder_data(osp.join(base, "images"), "train", names)
    want = jimagenet.read_folder_data(osp.join(base, "images"), "train", names)
    assert rows(got) == rows(want) and len(got) == 12


@pytest.mark.parametrize("subsample", ["all", "base", "new"])
def test_imagenet_matches_jax(tmp_path, subsample):
    """The port builds the caches, the JAX loader reads them: the same few
    shots; then each package from a fresh tree builds its own."""
    make_imagenet(tmp_path)
    port_cfg, jax_cfg = cfgs(tmp_path, subsample=subsample, name="ImageNet")
    port = build_dataset(port_cfg)
    assert isinstance(port, imagenet.ImageNet)
    assert osp.isfile(tmp_path / "imagenet" / "preprocessed.pkl")
    assert osp.isfile(tmp_path / "imagenet" / "split_fewshot" / "shot_2-seed_1.pkl")
    assert_same(port, jimagenet.ImageNet(jax_cfg))
    assert port.eval_set == port.train_x
    counts = np.bincount([d.label for d in port.train_x])
    assert (counts == 2).all()
    # the JAX package builds its caches and the port reads them
    fresh = tmp_path / "fresh"
    make_imagenet(fresh)
    port_cfg, jax_cfg = cfgs(fresh, subsample=subsample)
    ref = jimagenet.ImageNet(jax_cfg)
    assert_same(imagenet.ImageNet(port_cfg), ref)


def test_imagenet21kp_reads_the_prebuilt_split(tmp_path):
    base = tmp_path / "imagenet_21k_P" / "split_fewshot"
    train = [Datum(impath=f"/data/x/{i}.JPEG", label=i % 3, classname=f"class {i % 3}")
             for i in range(9)]
    save_fewshot_pickle(str(base / "shot_3-seed_1.pkl"), {"train": train})
    port_cfg, jax_cfg = cfgs(tmp_path, shots=3, name="ImageNet21kP")
    port = build_dataset(port_cfg)
    assert_same(port, jimagenet.ImageNet21kP(jax_cfg))
    assert port.test == port.train_x == port.eval_set
    assert port.classnames == ["class 0", "class 1", "class 2"]
    base_cfg = cfgs(tmp_path, shots=3, subsample="base")
    assert_same(imagenet.ImageNet21kP(base_cfg[0]), jimagenet.ImageNet21kP(base_cfg[1]))
    with pytest.raises(FileNotFoundError, match="prebuilt few-shot split"):
        imagenet.ImageNet21kP(cfgs(tmp_path, shots=4)[0])
    with pytest.raises(ValueError, match="NUM_SHOTS"):
        imagenet.ImageNet21kP(cfgs(tmp_path, shots=-1)[0])


@pytest.mark.parametrize("name,dataset_dir,image_subdir", [
    ("ImageNetSketch", "imagenet-sketch", "images"),
    ("ImageNetA", "imagenet-adversarial", "imagenet-a"),
    ("ImageNetR", "imagenet-rendition", "imagenet-r"),
])
def test_variants_label_the_folders_present(tmp_path, name, dataset_dir, image_subdir):
    base = osp.join(tmp_path, dataset_dir)
    write_classnames(base)
    for folder in (FOLDERS[1], FOLDERS[3]):  # two of four classes present
        write_images(osp.join(base, image_subdir, folder), n=2)
    port_cfg, jax_cfg = cfgs(tmp_path, shots=-1, name=name)
    port = build_dataset(port_cfg)
    assert type(port).__name__ == name
    assert_same(port, getattr(jimagenet, name)(jax_cfg))
    assert sorted({d.label for d in port.test}) == [0, 1]
    assert port.classnames == [NAMES[1], NAMES[3]]


def test_imagenet_v2_numeric_folders(tmp_path):
    base = osp.join(tmp_path, "imagenetv2")
    folders = [f"n{i:08d}" for i in range(1000)]
    write_classnames(base, folders, [f"class {i}" for i in range(1000)])
    image_dir = osp.join(base, "imagenetv2-matched-frequency-format-val")
    for label in range(1000):
        os.makedirs(osp.join(image_dir, str(label)), exist_ok=True)
    for label in (0, 7, 999):
        write_images(osp.join(image_dir, str(label)), n=1, size=4)
    port_cfg, jax_cfg = cfgs(tmp_path, shots=-1, name="ImageNetV2")
    port = build_dataset(port_cfg)
    assert_same(port, jimagenet.ImageNetV2(jax_cfg))
    assert [d.label for d in port.test] == [0, 7, 999]
    assert [d.classname for d in port.test] == ["class 0", "class 7", "class 999"]


def test_imagenet_sd_matches_jax(tmp_path):
    make_imagenet(tmp_path, "imagenet_sd")
    port_cfg, jax_cfg = cfgs(tmp_path, name="ImageNetSD")
    port = build_dataset(port_cfg)
    assert osp.isfile(tmp_path / "imagenet_sd" / "split_fewshot" / "shot_2-seed_1.pkl")
    assert_same(port, jimagenet.ImageNetSD(jax_cfg))
    assert len(port.train_x) == 8 and len(port.test) == 12
