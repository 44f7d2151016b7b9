"""The 11-dataset CoOp suite loaders (minus ImageNet).

The port's copy of ``ovmr_tpu/data/datasets/fine_grained.py``; ImageNet
and its variants are in :mod:`.imagenet`.

Each mirrors one reference loader under ``datasets/`` — same directory
layout, split json name, classname munging and label conventions — so
datasets prepared for the reference work unchanged.
"""

from __future__ import annotations

import os.path as osp
import re
from collections import defaultdict

from ..datum import DatasetBase, Datum, subsample_classes
from ..registry import DATASET_REGISTRY
from .common import (
    StandardDataset,
    fewshot_with_cache,
    read_and_split_folder_data,
    split_trainval,
)


@DATASET_REGISTRY.register()
class OxfordPets(StandardDataset):
    """reference ``datasets/oxford_pets.py``"""

    dataset_dir = "oxford_pets"
    image_subdir = "images"
    split_filename = "split_zhou_OxfordPets.json"

    def build_split(self):
        trainval = self._read_anno("trainval.txt")
        test = self._read_anno("test.txt")
        train, val = split_trainval(trainval)
        return train, val, test

    def _read_anno(self, split_file):
        filepath = osp.join(self.dataset_dir, "annotations", split_file)
        items = []
        with open(filepath) as f:
            for line in f:
                imname, label, _species, _ = line.strip().split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                items.append(
                    Datum(
                        impath=osp.join(self.image_dir, imname + ".jpg"),
                        label=int(label) - 1,
                        classname=breed,
                    )
                )
        return items


CALTECH_IGNORED = ["BACKGROUND_Google", "Faces_easy"]
CALTECH_RENAME = {
    "airplanes": "airplane",
    "Faces": "face",
    "Leopards": "leopard",
    "Motorbikes": "motorbike",
}


@DATASET_REGISTRY.register()
class Caltech101(StandardDataset):
    """reference ``datasets/caltech101.py``"""

    dataset_dir = "caltech-101"
    image_subdir = "101_ObjectCategories"
    split_filename = "split_zhou_Caltech101.json"

    def build_split(self):
        return read_and_split_folder_data(
            self.image_dir, ignored=CALTECH_IGNORED, new_cnames=CALTECH_RENAME
        )


@DATASET_REGISTRY.register()
class DescribableTextures(StandardDataset):
    """reference ``datasets/dtd.py``"""

    dataset_dir = "dtd"
    image_subdir = "images"
    split_filename = "split_zhou_DescribableTextures.json"

    def build_split(self):
        return read_and_split_folder_data(self.image_dir)


EUROSAT_RENAME = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@DATASET_REGISTRY.register()
class EuroSAT(StandardDataset):
    """reference ``datasets/eurosat.py``"""

    dataset_dir = "eurosat"
    image_subdir = "2750"
    split_filename = "split_zhou_EuroSAT.json"

    def build_split(self):
        return read_and_split_folder_data(self.image_dir, new_cnames=EUROSAT_RENAME)


@DATASET_REGISTRY.register()
class Food101(StandardDataset):
    """reference ``datasets/food101.py``"""

    dataset_dir = "food-101"
    image_subdir = "images"
    split_filename = "split_zhou_Food101.json"

    def build_split(self):
        return read_and_split_folder_data(self.image_dir)


@DATASET_REGISTRY.register()
class SUN397(StandardDataset):
    """reference ``datasets/sun397.py``"""

    dataset_dir = "sun397"
    image_subdir = "SUN397"
    split_filename = "split_zhou_SUN397.json"

    def build_split(self):
        classnames = []
        with open(osp.join(self.dataset_dir, "ClassName.txt")) as f:
            for line in f:
                classnames.append(line.strip()[1:])  # remove leading /
        cname2lab = {c: i for i, c in enumerate(classnames)}
        trainval = self._read_split_file(cname2lab, "Training_01.txt")
        test = self._read_split_file(cname2lab, "Testing_01.txt")
        train, val = split_trainval(trainval)
        return train, val, test

    def _read_split_file(self, cname2lab, text_file):
        items = []
        with open(osp.join(self.dataset_dir, text_file)) as f:
            for line in f:
                imname = line.strip()[1:]
                classname = osp.dirname(imname)
                label = cname2lab[classname]
                names = classname.split("/")[1:][::-1]
                items.append(
                    Datum(
                        impath=osp.join(self.image_dir, imname),
                        label=label,
                        classname=" ".join(names),
                    )
                )
        return items


@DATASET_REGISTRY.register()
class UCF101(StandardDataset):
    """reference ``datasets/ucf101.py`` (mid-frame jpgs of the videos)"""

    dataset_dir = "ucf101"
    image_subdir = "UCF-101-midframes"
    split_filename = "split_zhou_UCF101.json"

    def build_split(self):
        cname2lab = {}
        with open(
            osp.join(self.dataset_dir, "ucfTrainTestlist", "classInd.txt")
        ) as f:
            for line in f:
                label, classname = line.strip().split(" ")
                cname2lab[classname] = int(label) - 1
        trainval = self._read_split_file(cname2lab, "trainlist01.txt")
        test = self._read_split_file(cname2lab, "testlist01.txt")
        train, val = split_trainval(trainval)
        return train, val, test

    def _read_split_file(self, cname2lab, text_file):
        items = []
        with open(osp.join(self.dataset_dir, "ucfTrainTestlist", text_file)) as f:
            for line in f:
                line = line.strip().split(" ")[0]
                action, filename = line.split("/")
                label = cname2lab[action]
                renamed = "_".join(re.findall("[A-Z][^A-Z]*", action))
                items.append(
                    Datum(
                        impath=osp.join(
                            self.image_dir, renamed, filename.replace(".avi", ".jpg")
                        ),
                        label=label,
                        classname=renamed,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class FGVCAircraft(DatasetBase):
    """reference ``datasets/fgvc_aircraft.py`` (txt-file splits, no json)"""

    dataset_dir = "fgvc_aircraft"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, "images")
        self.split_fewshot_dir = osp.join(self.dataset_dir, "split_fewshot")

        classnames = []
        with open(osp.join(self.dataset_dir, "variants.txt")) as f:
            classnames = [line.strip() for line in f]
        cname2lab = {c: i for i, c in enumerate(classnames)}

        train = self._read_split_file(cname2lab, "images_variant_train.txt")
        val = self._read_split_file(cname2lab, "images_variant_val.txt")
        test = self._read_split_file(cname2lab, "images_variant_test.txt")

        train, val = fewshot_with_cache(cfg, self.split_fewshot_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test, eval_set=train)

    def _read_split_file(self, cname2lab, split_file):
        items = []
        with open(osp.join(self.dataset_dir, split_file)) as f:
            for line in f:
                parts = line.strip().split(" ")
                classname = " ".join(parts[1:])
                items.append(
                    Datum(
                        impath=osp.join(self.image_dir, parts[0] + ".jpg"),
                        label=cname2lab[classname],
                        classname=classname,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class OxfordFlowers(StandardDataset):
    """reference ``datasets/oxford_flowers.py`` (imagelabels.mat splits)"""

    dataset_dir = "oxford_flowers"
    image_subdir = "jpg"
    split_filename = "split_zhou_OxfordFlowers.json"

    def build_split(self):
        import json
        import random

        from scipy.io import loadmat

        label_file = osp.join(self.dataset_dir, "imagelabels.mat")
        lab2cname_file = osp.join(self.dataset_dir, "cat_to_name.json")
        with open(lab2cname_file) as f:
            lab2cname = json.load(f)

        tracker = defaultdict(list)
        for i, label in enumerate(loadmat(label_file)["labels"][0]):
            imname = f"image_{str(i + 1).zfill(5)}.jpg"
            tracker[int(label)].append(osp.join(self.image_dir, imname))

        train, val, test = [], [], []
        for label, impaths in tracker.items():
            random.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            cname = lab2cname[str(label)]

            def _collate(ims, y=label - 1, c=cname):
                return [Datum(impath=im, label=y, classname=c) for im in ims]

            train.extend(_collate(impaths[:n_train]))
            val.extend(_collate(impaths[n_train : n_train + n_val]))
            test.extend(_collate(impaths[n_train + n_val :]))
        return train, val, test


@DATASET_REGISTRY.register()
class StanfordCars(StandardDataset):
    """reference ``datasets/stanford_cars.py`` (devkit .mat annotations)"""

    dataset_dir = "stanford_cars"
    image_subdir = ""
    split_filename = "split_zhou_StanfordCars.json"

    def build_split(self):
        trainval = self._read_mat(
            "cars_train", osp.join(self.dataset_dir, "devkit", "cars_train_annos.mat")
        )
        test = self._read_mat(
            "cars_test",
            osp.join(self.dataset_dir, "cars_test_annos_withlabels.mat"),
        )
        train, val = split_trainval(trainval)
        return train, val, test

    def _read_mat(self, image_dir, anno_file):
        from scipy.io import loadmat

        meta_file = osp.join(self.dataset_dir, "devkit", "cars_meta.mat")
        annos = loadmat(anno_file)["annotations"][0]
        meta = loadmat(meta_file)["class_names"][0]
        items = []
        for anno in annos:
            imname = anno["fname"][0]
            label = int(anno["class"][0, 0]) - 1
            names = meta[label][0].split(" ")
            year = names.pop(-1)
            names.insert(0, year)
            items.append(
                Datum(
                    impath=osp.join(self.dataset_dir, image_dir, imname),
                    label=label,
                    classname=" ".join(names),
                )
            )
        return items
