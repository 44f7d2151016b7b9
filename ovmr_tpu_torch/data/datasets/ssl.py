"""Semi-supervised dataset loaders (reference
``Dassl.pytorch/dassl/data/datasets/ssl/``).

The port's copy of ``ovmr_tpu/data/datasets/ssl.py``, with the reference's
on-disk contracts:

- CIFAR10/CIFAR100/SVHN (``ssl/cifar.py``, ``ssl/svhn.py``):
  ``{train,test}/<class>/<image files>``; per class, the first
  ``floor(n * VAL_PERCENT)`` images become val (Oliver et al. protocol),
  the rest shuffle with Python's global ``random`` (the same calls in the
  same order, so a seed gives the JAX package's split) and split into
  NUM_LABELED/len(classes) labeled items + the unlabeled pool.
- STL10 (``ssl/stl10.py``): flat ``{train,test,unlabeled}/<name>_<label>.png``
  folders (label "none" -> -1) plus ``stl10_binary/fold_indices.txt``
  selecting the labeled fold (STL10_FOLD in 0..4; -1 = all), its indices
  read as uint8, so that those above 255 wrap as in the reference.
- ALL_AS_UNLABELED folds the labeled split into the unlabeled pool too.
"""

from __future__ import annotations

import math
import os.path as osp
import random

import numpy as np

from ovmr_tpu_torch.utils.tools import listdir_nohidden

from ..datum import DatasetBase, Datum
from ..registry import DATASET_REGISTRY
from .da import _require_dir


@DATASET_REGISTRY.register()
class CIFAR10(DatasetBase):
    """CIFAR-10 for SSL (reference ``ssl/cifar.py:11-102``)."""

    dataset_dir = "cifar10"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        train_dir = osp.join(self.dataset_dir, "train")
        test_dir = osp.join(self.dataset_dir, "test")

        if cfg.DATASET.NUM_LABELED <= 0:
            raise ValueError(f"{type(self).__name__} requires DATASET.NUM_LABELED > 0")

        train_x, train_u, val = self._read_data_train(
            train_dir, cfg.DATASET.NUM_LABELED, cfg.DATASET.VAL_PERCENT)
        test = self._read_data_test(test_dir)

        if cfg.DATASET.ALL_AS_UNLABELED:
            train_u = train_u + train_x
        if len(val) == 0:
            val = None

        super().__init__(train_x=train_x, train_u=train_u, val=val, test=test)

    @staticmethod
    def _read_data_train(data_dir, num_labeled, val_percent):
        _require_dir(data_dir, "train/<class>/<image files>")
        class_names = listdir_nohidden(data_dir, sort=True)
        num_labeled_per_class = num_labeled / len(class_names)
        items_x, items_u, items_v = [], [], []

        for label, class_name in enumerate(class_names):
            class_dir = osp.join(data_dir, class_name)
            imnames = listdir_nohidden(class_dir)

            # val is carved off before the shuffle (reference
            # ssl/cifar.py:53-60), so it is a fixed prefix
            num_val = math.floor(len(imnames) * val_percent)
            imnames_train = imnames[num_val:]
            imnames_val = imnames[:num_val]
            random.shuffle(imnames_train)

            for i, imname in enumerate(imnames_train):
                item = Datum(impath=osp.join(class_dir, imname), label=label)
                if (i + 1) <= num_labeled_per_class:
                    items_x.append(item)
                else:
                    items_u.append(item)

            for imname in imnames_val:
                items_v.append(Datum(impath=osp.join(class_dir, imname), label=label))

        return items_x, items_u, items_v

    @staticmethod
    def _read_data_test(data_dir):
        _require_dir(data_dir, "test/<class>/<image files>")
        items = []
        for label, class_name in enumerate(listdir_nohidden(data_dir, sort=True)):
            class_dir = osp.join(data_dir, class_name)
            for imname in listdir_nohidden(class_dir):
                items.append(Datum(impath=osp.join(class_dir, imname), label=label))
        return items


@DATASET_REGISTRY.register()
class CIFAR100(CIFAR10):
    dataset_dir = "cifar100"


@DATASET_REGISTRY.register()
class SVHN(CIFAR10):
    """SVHN in the SSL folder layout (reference ``ssl/svhn.py``)."""

    dataset_dir = "svhn"


@DATASET_REGISTRY.register()
class STL10(DatasetBase):
    """STL-10 with its predefined labeled folds (reference
    ``ssl/stl10.py``)."""

    dataset_dir = "stl10"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        train_dir = osp.join(self.dataset_dir, "train")
        test_dir = osp.join(self.dataset_dir, "test")
        unlabeled_dir = osp.join(self.dataset_dir, "unlabeled")
        fold_file = osp.join(self.dataset_dir, "stl10_binary", "fold_indices.txt")

        fold = cfg.DATASET.STL10_FOLD
        if not -1 <= fold <= 4:
            raise ValueError(f"STL10_FOLD must be in [-1, 4], got {fold}")

        train_x = self._read_data_train(train_dir, fold, fold_file)
        train_u = self._read_data_all(unlabeled_dir)
        test = self._read_data_all(test_dir)

        if cfg.DATASET.ALL_AS_UNLABELED:
            train_u = train_u + train_x

        super().__init__(train_x=train_x, train_u=train_u, test=test)

    @staticmethod
    def _read_data_train(data_dir, fold, fold_file):
        _require_dir(data_dir, "train/<name>_<label>.png")
        imnames = listdir_nohidden(data_dir, sort=True)
        list_idx = list(range(len(imnames)))
        if fold >= 0:
            with open(fold_file) as f:
                str_idx = f.read().splitlines()[fold]
            # the reference reads the fold as uint8 (ssl/stl10.py:63), so
            # indices above 255 wrap; parsed as int first, since a uint8
            # parse of a real fold file (indices up to 4999) would raise
            list_idx = np.array(str_idx.split(), dtype=np.int64).astype(np.uint8)

        items = []
        for i in list_idx:
            imname = imnames[i]
            label = int(osp.splitext(imname)[0].split("_")[1])
            items.append(Datum(impath=osp.join(data_dir, imname), label=label))
        return items

    @staticmethod
    def _read_data_all(data_dir):
        _require_dir(data_dir, "<dir>/<name>_<label|none>.png")
        items = []
        for imname in listdir_nohidden(data_dir):
            label = osp.splitext(imname)[0].split("_")[1]
            label = -1 if label == "none" else int(label)
            items.append(Datum(impath=osp.join(data_dir, imname), label=label))
        return items
