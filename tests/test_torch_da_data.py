"""The port's DA data layer against the JAX package's.

- ``utils/tools.check_isfile``, ``data/transforms.to_tensor_transform`` and
  ``resize_with_pad``.
- The seven DA loaders of ``data/datasets/da.py`` (Digit5, VisDA17,
  CIFARSTL, Office31, OfficeHome, DomainNet, miniDomainNet) on trees the
  test writes in the layouts of ``tests/test_dassl_datasets.py``: the same
  items (path, label, domain, class name) in every split.
- ``DataManager``'s unlabeled loader ``train_loader_u`` (``TRAIN_U`` and
  ``SAME_AS_X``, K views, strong views), ``DATALOADER.RETURN_IMG0`` and
  ``TEXT_ONLY`` on the Office-31 fixture: the same items, order and arrays
  over two epochs.
- SourceOnly trains and tests on a Digit-5 tree of PNGs through the port's
  ``build_trainer`` (``tests/test_dassl_datasets.py:396``).
"""

import io
import os
import os.path as osp
import random
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ovmr_tpu.data.manager import DataManager as JDataManager
from ovmr_tpu.data.registry import build_dataset as j_build_dataset
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.data.registry import build_dataset
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
OFFICE = osp.join(ROOT, "tests", "fixtures", "e2e_da_dataset")


def _rows(items):
    return [(d.impath, d.label, d.domain, d.classname) for d in items]


def touch(*path):
    p = osp.join(*path)
    os.makedirs(osp.dirname(p), exist_ok=True)
    open(p, "w").close()
    return p


def test_check_isfile_matches_jax(tmp_path):
    from ovmr_tpu.utils.tools import check_isfile as j_check_isfile
    from ovmr_tpu_torch.utils.tools import check_isfile

    path = touch(str(tmp_path), "w.npz")
    for p in (path, str(tmp_path / "missing.npz"), "", str(tmp_path)):
        port_out, jax_out = io.StringIO(), io.StringIO()
        with redirect_stdout(port_out):
            got = check_isfile(p)
        with redirect_stdout(jax_out):
            want = j_check_isfile(p)
        assert got == want and port_out.getvalue() == jax_out.getvalue()


@pytest.mark.parametrize("size,interp,transforms", [
    ((32, 32), "bilinear", ("normalize",)),
    ((24, 40), "bicubic", ("random_flip",)),
    ((48, 16), "nearest", ("normalize", "random_flip")),
])
def test_to_tensor_transform_and_resize_with_pad_match_jax(size, interp, transforms):
    from PIL import Image

    from ovmr_tpu.data import transforms as jt
    from ovmr_tpu_torch.data import transforms as pt

    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (37, 53, 3), np.uint8))
    cfgs = []
    for make in (get_cfg_default, j_cfg):
        cfg = make()
        cfg.INPUT.SIZE, cfg.INPUT.INTERPOLATION, cfg.INPUT.TRANSFORMS = size, interp, transforms
        cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
        cfgs.append(cfg)
    got, want = pt.to_tensor_transform(cfgs[0])(img), jt.to_tensor_transform(cfgs[1])(img)
    assert got.dtype == want.dtype == np.float32 and got.shape == (3,) + tuple(size)
    np.testing.assert_array_equal(got, want)
    code = pt.INTERP[interp]
    np.testing.assert_array_equal(np.asarray(pt.resize_with_pad(img, size, code)),
                                  np.asarray(jt.resize_with_pad(img, size, jt.INTERP[interp])))


# --------------------------------------------------------------------------
# the seven loaders, on trees in the layouts of tests/test_dassl_datasets.py
# --------------------------------------------------------------------------

def _digit5(root):
    for dname in ("mnist", "usps", "svhn"):
        for split_dir in ("train_images", "test_images"):
            for i in range(5):
                touch(root, "digit5", dname, split_dir, f"im{i}_{i % 3}.png")
    return ("mnist", "svhn"), ("usps",)


def _visda17(root):
    for filedir, n in (("train", 3), ("validation", 2)):
        lines = []
        for i in range(n):
            rel = f"class{i}/im{i}.jpg"
            touch(root, "visda17", filedir, rel)
            lines.append(f"{rel} {i}")
        with open(touch(root, "visda17", filedir, "image_list.txt"), "w") as f:
            f.write("\n".join(lines) + "\n\n")
    return ("synthetic",), ("real",)


def _cifarstl(root):
    for dname in ("cifar", "stl"):
        for split in ("train", "test"):
            for cname in ("0_airplane", "3_cat", "5_dog"):
                for i in range(2):
                    touch(root, "cifar_stl", dname, split, cname, f"im{i}.png")
    return ("cifar",), ("stl",)


def _office(dsdir, domains):
    def make(root):
        for dname in domains:
            for cname in ("Bike", "Monitor", "back_pack"):
                for i in range(2):
                    touch(root, dsdir, dname, cname, f"im{i}.jpg")
        return domains[:-1], domains[-1:]

    return make


def _domainnet(split_dirname, domains):
    def make(root):
        for dname in domains:
            for split in ("train", "test"):
                lines = []
                for i in range(3):
                    rel = f"{dname}/class{i}/im{i}_{split}.jpg"
                    touch(root, "domainnet", rel)
                    lines.append(f"{rel} {i}")
                with open(touch(root, "domainnet", split_dirname, f"{dname}_{split}.txt"),
                          "w") as f:
                    f.write("\n".join(lines) + "\n")
        return domains[:-1], domains[-1:]

    return make


LOADERS = {
    "Digit5": _digit5,
    "VisDA17": _visda17,
    "CIFARSTL": _cifarstl,
    "Office31": _office("office31", ("amazon", "webcam", "dslr")),
    "OfficeHome": _office("office_home", ("art", "clipart", "real_world")),
    "DomainNet": _domainnet("splits", ("clipart", "infograph", "sketch")),
    "miniDomainNet": _domainnet("splits_mini", ("painting", "real", "sketch")),
}


def _dataset_cfg(make, root, name, source, target):
    cfg = make()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = name
    cfg.DATASET.SOURCE_DOMAINS = tuple(source)
    cfg.DATASET.TARGET_DOMAINS = tuple(target)
    cfg.SEED = 1
    return cfg


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_da_loader_matches_jax(tmp_path, name):
    source, target = LOADERS[name](str(tmp_path))
    random.seed(0)
    port = build_dataset(_dataset_cfg(get_cfg_default, tmp_path, name, source, target))
    random.seed(0)
    jax_ds = j_build_dataset(_dataset_cfg(j_cfg, tmp_path, name, source, target))
    assert port.train_x and port.train_u and port.test
    for split in ("train_x", "train_u", "val", "test"):
        assert _rows(getattr(port, split)) == _rows(getattr(jax_ds, split)), split
    assert port.num_classes == jax_ds.num_classes and port.lab2cname == jax_ds.lab2cname
    if name == "Digit5":  # USPS' train set repeats 3x (reference da/digit5.py:58-60)
        assert len(port.train_u) == 3 * 5 and len(port.test) == 5
        assert {d.domain for d in port.train_x} == {0, 1}


def test_da_loaders_refuse_what_jax_refuses(tmp_path):
    _digit5(str(tmp_path))
    for make, build in ((get_cfg_default, build_dataset), (j_cfg, j_build_dataset)):
        with pytest.raises(ValueError, match="nope"):
            build(_dataset_cfg(make, tmp_path, "Digit5", ["mnist"], ["nope"]))
        with pytest.raises(FileNotFoundError, match="<domain>/<class_name>"):
            build(_dataset_cfg(make, tmp_path, "Office31", ["amazon"], ["webcam"]))
        with pytest.raises(FileNotFoundError, match="image_list.txt"):
            build(_dataset_cfg(make, tmp_path, "VisDA17", ["synthetic"], ["real"]))


# --------------------------------------------------------------------------
# the DataManager: train_loader_u, RETURN_IMG0, TEXT_ONLY
# --------------------------------------------------------------------------

def _office_cfg(make, root, **keys):
    cfg = make()
    cfg.SEED = 1
    cfg.DATASET.ROOT = root
    cfg.DATASET.NAME = "Office31"
    cfg.DATASET.SOURCE_DOMAINS = ["amazon"]
    cfg.DATASET.TARGET_DOMAINS = ["webcam"]
    cfg.INPUT.SIZE = (24, 24)
    cfg.INPUT.TRANSFORMS = ("random_flip", "random_translation", "normalize")
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 6
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.DATALOADER.NUM_WORKERS = 3
    for key, value in keys.items():
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return cfg


def _same_loader(port, jax_loader, root, epochs=2):
    assert len(port) == len(jax_loader)
    for _ in range(epochs):
        n = 0
        for a, b in zip(port, jax_loader):
            assert sorted(a) == sorted(b)
            for key in a:
                if key == "impath":
                    assert a[key] == b[key]
                elif key == "_local":
                    assert a[key] is b[key] is False
                else:
                    assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            n += 1
        assert n == len(port)
    return n


def _strong(make, cfg):
    from ovmr_tpu.data.transforms import build_transform as j_build_transform
    from ovmr_tpu_torch.data.transforms import build_transform

    build = build_transform if make is get_cfg_default else j_build_transform
    return build(cfg, is_train=True, choices=("random_flip", "cutout", "normalize"))


@pytest.mark.parametrize("same_as_x", [True, False])
def test_train_loader_u_matches_jax(tmp_path, same_as_x):
    keys = {"DATALOADER.TRAIN_U.SAME_AS_X": same_as_x, "DATALOADER.TRAIN_U.BATCH_SIZE": 4,
            "DATALOADER.TRAIN_U.SAMPLER": "SequentialSampler", "DATALOADER.K_TRANSFORMS": 2}
    managers = []
    for make, cls in ((get_cfg_default, DataManager), (j_cfg, JDataManager)):
        cfg = _office_cfg(make, OFFICE, **keys)
        managers.append(cls(cfg, tfm_train_strong=_strong(make, cfg)))
    port, jax_dm = managers
    assert len(port.dataset.train_u) == 16 and port.train_loader_u.drop_last
    assert port.train_loader_u.batch_size == (6 if same_as_x else 4)
    assert _same_loader(port.train_loader_u, jax_dm.train_loader_u, OFFICE) > 0
    batch = next(iter(port.train_loader_u))
    assert batch["img"].shape[0] == 2 * port.train_loader_u.batch_size
    assert batch["img2"].shape == batch["img"].shape
    assert set(batch["domain"].tolist()) == {0}  # target rows: domain ids per list
    _same_loader(port.train_loader_x, jax_dm.train_loader_x, OFFICE, epochs=1)


def test_return_img0_matches_jax():
    port = DataManager(_office_cfg(get_cfg_default, OFFICE, **{"DATALOADER.RETURN_IMG0": True}))
    jax_dm = JDataManager(_office_cfg(j_cfg, OFFICE, **{"DATALOADER.RETURN_IMG0": True}))
    _same_loader(port.train_loader_x, jax_dm.train_loader_x, OFFICE)
    batch = next(iter(port.train_loader_x))
    assert batch["img0"].shape == batch["img"].shape and batch["img0"].dtype == np.float32
    # the un-augmented image, resized to SIZE and normalised
    assert not np.array_equal(batch["img0"], batch["img"])
    assert "img0" not in next(iter(port.train_loader_u))


def test_text_only_matches_jax():
    port = DataManager(_office_cfg(get_cfg_default, OFFICE, **{"TEXT_ONLY": True}))
    jax_dm = JDataManager(_office_cfg(j_cfg, OFFICE, **{"TEXT_ONLY": True}))
    assert _same_loader(port.train_loader_x, jax_dm.train_loader_x, OFFICE) == 5
    batch = next(iter(port.train_loader_x))
    assert sorted(batch) == ["_local", "impath", "index", "label"]
    # the eval loaders still decode
    assert "img" in next(iter(port.test_loader))


def test_source_only_trains_on_digit5(tmp_path):
    from PIL import Image

    from ovmr_tpu_torch.engine.trainer import build_trainer

    rng = np.random.RandomState(0)
    for dname in ("mnist", "usps"):
        for split_dir in ("train_images", "test_images"):
            d = tmp_path / "digit5" / dname / split_dir
            d.mkdir(parents=True, exist_ok=True)
            for i in range(8):
                arr = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"im{i}_{i % 4}.png")

    cfg = get_cfg_default()
    cfg.TRAINER.NAME = "SourceOnly"
    cfg.DATASET.NAME = "Digit5"
    cfg.DATASET.ROOT = str(tmp_path)
    cfg.DATASET.SOURCE_DOMAINS = ("mnist",)
    cfg.DATASET.TARGET_DOMAINS = ("usps",)
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 1
    cfg.INPUT.SIZE = (32, 32)
    cfg.MODEL.BACKBONE.NAME = "cnn_digit5_m3sda"
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.01
    cfg.OPTIM.MAX_EPOCH = 1
    cfg.CUDA.DEVICE = "cpu"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = build_trainer(cfg)
        trainer._writer = _NoWriter()
        trainer.train()
    finally:
        torch.set_num_threads(threads)
    assert osp.exists(osp.join(cfg.OUTPUT_DIR, "model", "checkpoint"))
    assert trainer.num_batches == 1 and len(trainer.dm.train_loader_u) == 3
    shutil.rmtree(cfg.OUTPUT_DIR)


class _NoWriter:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass
