"""Shared dataset-loader machinery.

The port's copy of ``ovmr_tpu/data/datasets/common.py``.

The canonical recipe every fine-grained loader follows (reference
``datasets/oxford_pets.py:16-54``): resolve dirs under ``DATASET.ROOT`` ->
load (or build) the ``split_zhou_*.json`` 3-way split -> few-shot subsample
the train split with a ``split_fewshot/shot_{N}-seed_{S}.pkl`` cache ->
``subsample_classes(base|new|all)`` -> DatasetBase(eval_set=train).
"""

from __future__ import annotations

import os.path as osp
import random
from collections import defaultdict
from typing import Dict, List, Optional

from ovmr_tpu_torch.utils.tools import listdir_nohidden, mkdir_if_missing

from ..datum import (
    DatasetBase,
    Datum,
    generate_fewshot_dataset,
    load_fewshot_pickle,
    read_split,
    save_fewshot_pickle,
    save_split,
    subsample_classes,
)


def fewshot_with_cache(cfg, split_fewshot_dir: str, train, val=None):
    """Apply few-shot sampling with the reference's pickle cache protocol."""
    num_shots = cfg.DATASET.NUM_SHOTS
    if num_shots < 1:
        return train, val
    seed = cfg.SEED
    mkdir_if_missing(split_fewshot_dir)
    cache = osp.join(split_fewshot_dir, f"shot_{num_shots}-seed_{seed}.pkl")
    if osp.exists(cache):
        print(f"Loading preprocessed few-shot data from {cache}")
        data = load_fewshot_pickle(cache)
        return data["train"], data.get("val", val)
    train = generate_fewshot_dataset(train, num_shots=num_shots)
    data = {"train": train}
    if val is not None:
        val = generate_fewshot_dataset(val, num_shots=min(num_shots, 4))
        data["val"] = val
    print(f"Saving preprocessed few-shot data to {cache}")
    save_fewshot_pickle(cache, data)
    return train, val


def read_and_split_folder_data(
    image_dir: str,
    p_trn: float = 0.5,
    p_val: float = 0.2,
    ignored: Optional[List[str]] = None,
    new_cnames: Optional[Dict[str, str]] = None,
):
    """Random 50/20/30 split of an images/<category>/ folder tree
    (reference ``datasets/dtd.py:53-95``; uses python `random.shuffle`, so
    identical only under the same global seed — the json split is the
    reproducibility anchor)."""
    ignored = ignored or []
    categories = [c for c in listdir_nohidden(image_dir) if c not in ignored]
    categories.sort()

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        cdir = osp.join(image_dir, category)
        images = [osp.join(cdir, im) for im in listdir_nohidden(cdir)]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        cname = new_cnames[category] if new_cnames and category in new_cnames else category

        def _collate(ims, y=label, c=cname):
            return [Datum(impath=im, label=y, classname=c) for im in ims]

        train.extend(_collate(images[:n_train]))
        val.extend(_collate(images[n_train : n_train + n_val]))
        test.extend(_collate(images[n_train + n_val :]))
    return train, val, test


def split_trainval(trainval, p_val: float = 0.2):
    """80/20 per-class split (reference ``oxford_pets.py:77-97``)."""
    tracker = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item.label].append(idx)
    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            (val if n < n_val else train).append(trainval[idx])
    return train, val


class StandardDataset(DatasetBase):
    """Base class for json-split datasets: subclasses set ``dataset_dir``,
    ``image_subdir``, ``split_filename`` and optionally override
    ``build_split`` for the raw-data path."""

    dataset_dir = ""
    image_subdir = "images"
    split_filename = ""

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, type(self).image_subdir)
        self.split_path = osp.join(self.dataset_dir, type(self).split_filename)
        self.split_fewshot_dir = osp.join(self.dataset_dir, "split_fewshot")

        if osp.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = self.build_split()
            save_split(train, val, test, self.split_path, self.image_dir)

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test, eval_set=train)

    def build_split(self):
        raise NotImplementedError(
            f"{type(self).__name__}: no split json at {self.split_path} and no "
            "raw-data split reader implemented"
        )
