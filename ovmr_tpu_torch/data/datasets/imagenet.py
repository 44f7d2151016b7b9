"""ImageNet family: ImageNet-1k, the distribution-shift test sets
(V2 / Sketch / A / R), the synthetic ImageNetSD variant, and the
ImageNet21k-OVR pretraining corpus.

The port's copy of ``ovmr_tpu/data/datasets/imagenet.py``, which mirrors the
reference loaders ``datasets/imagenet*.py``: classnames.txt folder->name
mapping, folder-scan data reading, whole-dataset ``preprocessed.pkl`` cache,
few-shot pickle caches, ``eval_set=train``.
"""

from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict

from ovmr_tpu_torch.utils.tools import listdir_nohidden, mkdir_if_missing

from ..datum import (
    DatasetBase,
    Datum,
    generate_fewshot_dataset,
    load_fewshot_pickle,
    save_fewshot_pickle,
    subsample_classes,
)
from ..registry import DATASET_REGISTRY
from .common import fewshot_with_cache


def read_classnames(text_file: str) -> "OrderedDict[str, str]":
    """folder -> classname map from classnames.txt
    (reference ``datasets/imagenet.py:131-144``)."""
    classnames = OrderedDict()
    with open(text_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            classnames[parts[0]] = " ".join(parts[1:])
    return classnames


def _scan(class_dir: str, label: int, classname: str) -> list:
    return [Datum(impath=osp.join(class_dir, imname), label=label, classname=classname)
            for imname in listdir_nohidden(class_dir)]


def _sorted_folders(path: str) -> list:
    return sorted(f.name for f in os.scandir(path) if f.is_dir())


def read_folder_data(image_dir: str, split_dir: str, classnames) -> list:
    """Scan ``{image_dir}/{split_dir}/<folder>/*`` -> Datums with labels in
    sorted-folder order (reference ``datasets/imagenet.py:146-159``)."""
    split_path = osp.join(image_dir, split_dir)
    items = []
    for label, folder in enumerate(_sorted_folders(split_path)):
        items.extend(_scan(osp.join(split_path, folder), label, classnames[folder]))
    return items


@DATASET_REGISTRY.register()
class ImageNet(DatasetBase):
    dataset_dir = "imagenet"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, "images")
        self.preprocessed = osp.join(self.dataset_dir, "preprocessed.pkl")
        self.split_fewshot_dir = osp.join(self.dataset_dir, "split_fewshot")

        if osp.exists(self.preprocessed):
            data = load_fewshot_pickle(self.preprocessed)
            train, test = data["train"], data["test"]
        else:
            classnames = read_classnames(osp.join(self.dataset_dir, "classnames.txt"))
            train = read_folder_data(self.image_dir, "train", classnames)
            test = read_folder_data(self.image_dir, "val", classnames)
            save_fewshot_pickle(self.preprocessed, {"train": train, "test": test})

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            mkdir_if_missing(self.split_fewshot_dir)
            cache = osp.join(self.split_fewshot_dir, f"shot_{num_shots}-seed_{cfg.SEED}.pkl")
            if osp.exists(cache):
                print(f"Loading preprocessed few-shot data from {cache}")
                train = load_fewshot_pickle(cache)["train"]
            else:
                train = generate_fewshot_dataset(train, num_shots=num_shots)
                print(f"Saving preprocessed few-shot data to {cache}")
                save_fewshot_pickle(cache, {"train": train})

        train, test = subsample_classes(train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        super().__init__(train_x=train, val=test, test=test, eval_set=train)


@DATASET_REGISTRY.register()
class ImageNet21kP(DatasetBase):
    """ImageNet21k-OVR pretraining corpus (reference
    ``datasets/imagenet_21k_P.py``): the few-shot split ships as a prebuilt
    pickle; ``test=train`` (generator training never tests)."""

    dataset_dir = "imagenet_21k_P"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.split_fewshot_dir = osp.join(self.dataset_dir, "split_fewshot")

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots < 1:
            raise ValueError("ImageNet21kP requires DATASET.NUM_SHOTS >= 1")
        cache = osp.join(self.split_fewshot_dir, f"shot_{num_shots}-seed_{cfg.SEED}.pkl")
        if not osp.exists(cache):
            raise FileNotFoundError(
                f"ImageNet21kP expects the prebuilt few-shot split at {cache} "
                "(distributed with the reference, README.md:50)")
        print(f"Loading preprocessed few-shot data from {cache}")
        train = load_fewshot_pickle(cache)["train"]
        train, test = subsample_classes(train, train,
                                        subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        super().__init__(train_x=train, val=test, test=test, eval_set=train)


class _ImageNetVariant(DatasetBase):
    """Distribution-shift test sets reusing ImageNet classnames; train_x is
    the test data itself (reference ``datasets/imagenetv2.py`` etc.)."""

    dataset_dir = ""
    image_subdir = ""

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, type(self).image_subdir)
        classnames = read_classnames(osp.join(self.dataset_dir, "classnames.txt"))
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames):
        # labels enumerate the folders PRESENT (dense 0..n-1): ImageNet-A/R
        # ship only 200 of the 1000 classes (reference imagenet_a.py:32-46)
        items = []
        for label, folder in enumerate(_sorted_folders(self.image_dir)):
            items.extend(_scan(osp.join(self.image_dir, folder), label, classnames[folder]))
        return items


@DATASET_REGISTRY.register()
class ImageNetV2(_ImageNetVariant):
    dataset_dir = "imagenetv2"
    image_subdir = "imagenetv2-matched-frequency-format-val"

    def read_data(self, classnames):
        # v2 folders are numeric labels 0..999 (reference imagenetv2.py:32-46)
        folders = list(classnames.keys())
        items = []
        for label in range(1000):
            items.extend(_scan(osp.join(self.image_dir, str(label)), label,
                               classnames[folders[label]]))
        return items


@DATASET_REGISTRY.register()
class ImageNetSketch(_ImageNetVariant):
    dataset_dir = "imagenet-sketch"
    image_subdir = "images"


@DATASET_REGISTRY.register()
class ImageNetA(_ImageNetVariant):
    dataset_dir = "imagenet-adversarial"
    image_subdir = "imagenet-a"


@DATASET_REGISTRY.register()
class ImageNetR(_ImageNetVariant):
    dataset_dir = "imagenet-rendition"
    image_subdir = "imagenet-r"


@DATASET_REGISTRY.register()
class ImageNetSD(DatasetBase):
    """Stable-diffusion synthetic ImageNet (reference
    ``datasets/imagenet_sd.py``): folder scan + few-shot cache."""

    dataset_dir = "imagenet_sd"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, "images")
        self.split_fewshot_dir = osp.join(self.dataset_dir, "split_fewshot")
        classnames = read_classnames(osp.join(self.dataset_dir, "classnames.txt"))
        train = read_folder_data(self.image_dir, "train", classnames)
        test = read_folder_data(self.image_dir, "val", classnames)
        train, _ = fewshot_with_cache(cfg, self.split_fewshot_dir, train)
        train, test = subsample_classes(train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        super().__init__(train_x=train, val=test, test=test, eval_set=train)
