"""LVIS / COCO exemplar-crop datasets for the open-vocabulary detection
classifier export (reference ``datasets/lvis.py`` / ``datasets/coco.py``).

The port's copy of ``ovmr_tpu/data/datasets/detection.py``. Layout:
``{ROOT}/{exemplar_dir}/{train,val}/{label}/...crops...``. The LVIS
base/new protocol uses the explicit rare-category index list as the novel
split (``oxford_pets.py:202-251``); COCO's base/new subsampling is a stub in
the reference (returns None): 'all' works and the others raise. The split
swap of the OVD export regime is kept: NUM_SHOTS==5 with SUBSAMPLE all
swaps train/test (``lvis.py:70-73``, ``coco.py:70-73``).
"""

from __future__ import annotations

import os
import os.path as osp

from ovmr_tpu_torch.utils.tools import listdir_nohidden

from ..datum import DatasetBase, Datum, generate_fewshot_dataset
from ..registry import DATASET_REGISTRY
from .lvis_coco_classes import COCO_CLASSES, LVIS_CLASSES, LVIS_RARE_INDEX


def subsample_lvis_classes(*splits, subsample="all", novel_index=None):
    """Explicit-index base/new split with relabeling (reference
    ``oxford_pets.py:202-251``)."""
    if subsample not in ("all", "base", "new"):
        raise ValueError(f"subsample {subsample!r}: expected all, base or new")
    if subsample == "all":
        return list(splits)
    if novel_index is None:
        raise ValueError(f"subsample {subsample!r} needs the novel class indices")
    novel = set(novel_index)
    labels = sorted({item.label for item in splits[0]})
    selected = [y for y in labels if (y in novel) == (subsample == "new")]
    relabeler = {y: i for i, y in enumerate(selected)}
    return [[Datum(impath=item.impath, label=relabeler[item.label], classname=item.classname)
             for item in split if item.label in relabeler]
            for split in splits]


class _ExemplarCropDataset(DatasetBase):
    dataset_dir = ""
    class_list: tuple = ()
    novel_index = None

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = self.dataset_dir

        classnames = {str(i): c for i, c in enumerate(type(self).class_list)}
        train = self._read_data(classnames, "train")
        test = self._read_data(classnames, "val")

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            train = generate_fewshot_dataset(train, num_shots=num_shots)

        subsample = cfg.DATASET.SUBSAMPLE_CLASSES
        train, test = self._subsample(train, test, subsample)

        if num_shots == 5 and subsample == "all":
            # the OVD export regime swaps the splits (reference lvis.py:70-73)
            super().__init__(train_x=test, val=test, test=train, eval_set=test)
        else:
            super().__init__(train_x=train, val=test, test=test, eval_set=train)

    def _subsample(self, train, test, subsample):
        return subsample_lvis_classes(train, test, subsample=subsample,
                                      novel_index=type(self).novel_index)

    def _read_data(self, classnames, split_dir):
        split_path = osp.join(self.image_dir, split_dir)
        folders = sorted(f.name for f in os.scandir(split_path) if f.is_dir())
        items = []
        for folder in folders:
            for imname in listdir_nohidden(osp.join(split_path, folder)):
                items.append(Datum(impath=osp.join(split_path, folder, imname),
                                   label=int(folder), classname=classnames[folder]))
        return items


@DATASET_REGISTRY.register()
class LVIS(_ExemplarCropDataset):
    dataset_dir = "lvis_exemplars_mmovod_K30"
    class_list = LVIS_CLASSES
    novel_index = LVIS_RARE_INDEX


@DATASET_REGISTRY.register()
class COCO(_ExemplarCropDataset):
    dataset_dir = "coco_exemplars_mmovod_K30_final"
    class_list = tuple(COCO_CLASSES)

    def _subsample(self, train, test, subsample):
        if subsample != "all":
            # the reference's subsample_COCO_classes is a stub returning None
            # for base/new; surface that as an explicit error
            raise NotImplementedError(
                "COCO base/new subsampling is not defined (reference stub)")
        return train, test
