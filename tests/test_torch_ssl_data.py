"""The port's SSL data layer against the JAX package's.

- ``SyntheticSSL``: the same ``train_x``, ``train_u`` and ``eval_set`` with
  ``NUM_LABELED`` at -1 (half) and at 4, with and without
  ``ALL_AS_UNLABELED``.
- ``CIFAR10``, ``CIFAR100``, ``SVHN`` and ``STL10`` on trees the test
  writes in the layouts of ``tests/test_dassl_datasets.py:330-390``, with
  Python's ``random`` seeded alike before each build: the same items in the
  same order in every split (the val prefix carved before the shuffle), the
  same ``random`` state after, and the same ``NUM_LABELED``,
  ``ALL_AS_UNLABELED`` and ``STL10_FOLD`` refusals; an STL-10 fold whose
  index above 255 wraps as uint8, as in the reference.
"""

import os
import os.path as osp
import random

import pytest

from ovmr_tpu.data.registry import build_dataset as j_build_dataset
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.data.registry import build_dataset
from ovmr_tpu_torch.utils import get_cfg_default


def _rows(items):
    return [(d.impath, d.label, d.domain, d.classname) for d in items]


def touch(*path):
    p = osp.join(*path)
    os.makedirs(osp.dirname(p), exist_ok=True)
    open(p, "w").close()
    return p


def _cfg(make, root, name, **dataset):
    cfg = make()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = name
    cfg.SEED = 1
    for key, value in dataset.items():
        cfg.DATASET[key] = value
    return cfg


def _both(root, name, **dataset):
    """The port's and JAX's dataset after the same ``random`` seed, and
    each side's next ``random`` draw (the same shuffles leave the same
    state)."""
    random.seed(7)
    port = build_dataset(_cfg(get_cfg_default, root, name, **dataset))
    port_next = random.random()
    random.seed(7)
    jax_ds = j_build_dataset(_cfg(j_cfg, root, name, **dataset))
    assert random.random() == port_next
    return port, jax_ds


def _assert_same(port, jax_ds, splits=("train_x", "train_u", "val", "test")):
    for split in splits:
        assert _rows(getattr(port, split) or []) == _rows(getattr(jax_ds, split) or []), split
    assert port.num_classes == jax_ds.num_classes and port.lab2cname == jax_ds.lab2cname


@pytest.mark.parametrize("num_labeled", [-1, 4])
@pytest.mark.parametrize("all_as_unlabeled", [False, True])
def test_synthetic_ssl_matches_jax(tmp_path, monkeypatch, num_labeled, all_as_unlabeled):
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    port, jax_ds = _both(tmp_path, "SyntheticSSL", NUM_LABELED=num_labeled,
                         ALL_AS_UNLABELED=all_as_unlabeled)
    _assert_same(port, jax_ds)
    assert _rows(port.eval_set) == _rows(jax_ds.eval_set) == _rows(port.train_x)
    n_train = 16  # 4 classes x 4 train images
    n_x = n_train // 2 if num_labeled <= 0 else num_labeled
    assert len(port.train_x) == n_x
    assert len(port.train_u) == (n_train if all_as_unlabeled else n_train - n_x)


def _ssl_folder(root, dsdir, n_classes=3, per_class=10):
    for split in ("train", "test"):
        for c in range(n_classes):
            for i in range(per_class):
                touch(str(root), dsdir, split, f"class{c}", f"im{i:02d}.png")


@pytest.mark.parametrize("name,dsdir", [("CIFAR10", "cifar10"), ("CIFAR100", "cifar100"),
                                        ("SVHN", "svhn")])
def test_cifar_layout_loaders_match_jax(tmp_path, name, dsdir):
    _ssl_folder(tmp_path, dsdir)
    port, jax_ds = _both(tmp_path, name, NUM_LABELED=6, VAL_PERCENT=0.2)
    _assert_same(port, jax_ds)
    # per class: 2 val (floor(10 * 0.2)), 2 labeled (6 / 3), 6 unlabeled
    assert (len(port.val), len(port.train_x), len(port.train_u), len(port.test)) == (6, 6, 18, 30)
    # the val prefix is carved before the shuffle: each class' first two
    # images in directory order
    train_dir = osp.join(str(tmp_path), dsdir, "train")
    assert [d.impath for d in port.val] == [
        osp.join(train_dir, c, n) for c in sorted(os.listdir(train_dir))
        for n in [m for m in os.listdir(osp.join(train_dir, c)) if not m.startswith(".")][:2]]
    port, jax_ds = _both(tmp_path, name, NUM_LABELED=6, VAL_PERCENT=0.0, ALL_AS_UNLABELED=True)
    _assert_same(port, jax_ds)
    assert port.val == [] and len(port.train_u) == 30


def test_cifar_refuses_what_jax_refuses(tmp_path):
    _ssl_folder(tmp_path, "cifar10")
    for make, build in ((get_cfg_default, build_dataset), (j_cfg, j_build_dataset)):
        with pytest.raises(ValueError, match="NUM_LABELED"):
            build(_cfg(make, tmp_path, "CIFAR10", NUM_LABELED=-1))
        with pytest.raises(FileNotFoundError, match="train/<class>"):
            build(_cfg(make, tmp_path, "SVHN", NUM_LABELED=4))


def _stl10(root, n_train=6, fold_lines=("0 2 4", "1 3 5")):
    for i in range(n_train):
        touch(str(root), "stl10", "train", f"im{i:03d}_{i % 2}.png")
    for i in range(6):
        touch(str(root), "stl10", "test", f"im{i:03d}_{i % 2}.png")
    for i in range(4):
        touch(str(root), "stl10", "unlabeled", f"im{i:03d}_none.png")
    with open(touch(str(root), "stl10", "stl10_binary", "fold_indices.txt"), "w") as f:
        f.write("\n".join(fold_lines) + "\n")


@pytest.mark.parametrize("fold", [-1, 0, 1])
@pytest.mark.parametrize("all_as_unlabeled", [False, True])
def test_stl10_matches_jax(tmp_path, fold, all_as_unlabeled):
    _stl10(tmp_path)
    port, jax_ds = _both(tmp_path, "STL10", STL10_FOLD=fold, ALL_AS_UNLABELED=all_as_unlabeled)
    _assert_same(port, jax_ds)
    assert len(port.train_x) == (6 if fold == -1 else 3)
    assert sum(d.label == -1 for d in port.train_u) == 4  # "none" -> -1


def test_stl10_fold_indices_wrap_as_uint8(tmp_path):
    """An index above 255 wraps (260 -> 4), the reference's uint8 read."""
    _stl10(tmp_path, n_train=300, fold_lines=("0 2 260 299",))
    port, jax_ds = _both(tmp_path, "STL10", STL10_FOLD=0)
    _assert_same(port, jax_ds)
    assert [osp.basename(d.impath) for d in port.train_x] == [
        "im000_0.png", "im002_0.png", "im004_0.png", "im043_1.png"]


def test_stl10_refuses_a_fold_out_of_range(tmp_path):
    _stl10(tmp_path)
    for make, build in ((get_cfg_default, build_dataset), (j_cfg, j_build_dataset)):
        with pytest.raises(ValueError, match="STL10_FOLD"):
            build(_cfg(make, tmp_path, "STL10", STL10_FOLD=7))

