"""Domain-generalization dataset loaders (reference
``Dassl.pytorch/dassl/data/datasets/dg/``).

The port's copy of ``ovmr_tpu/data/datasets/dg.py``: the same ``Datum``
lists from the same trees.

On-disk contracts preserved:

- PACS (``dg/pacs.py``): ``images/`` + ``splits/<domain>_{train,crossval}_kfold.txt``
  of ``relpath label`` lines with 1-based labels; one known-bad sketch image
  is skipped; target split "all" = train+crossval files.
- VLCS (``dg/vlcs.py``): ``<DOMAIN_UPPER>/{train,crossval,test}/<class>/*.jpg``.
- DigitsDG / OfficeHomeDG (``dg/digits_dg.py``, ``dg/office_home_dg.py``):
  ``<domain>/{train,val}/<class>/*.jpg``; target "all" = train+val.
- DigitSingle (``dg/digit_single.py``): digit5 folders, deterministic first
  10k train images (Volpi et al. protocol), full test splits.
- CIFAR10C/CIFAR100C (``dg/cifar_c.py``): clean ``<src>/train/<class>/`` vs
  corrupted ``<tgt>/<c_type>/<level>/<class>/``.
- WILDS trio (``dg/wilds/``): ``zhou_preloaded.pkl`` split cache (primary
  path; loads without the `wilds` package), else defers to `wilds` if
  installed — it is not baked into this image, so the pkl is the contract.
  A cache written by the JAX package or the reference (pickled ``Datum``
  objects) reads through the port's compat unpickler, without importing
  either package; the port writes each item as a plain dict, which both
  packages read.

No auto-download (zero-egress environment); missing dirs raise with the
expected layout.
"""

from __future__ import annotations

import glob
import os.path as osp
import pickle

from ovmr_tpu_torch.utils.tools import listdir_nohidden

from ..datum import DatasetBase, Datum, _CompatUnpickler, generate_fewshot_dataset
from ..registry import DATASET_REGISTRY
from .da import _require_dir, load_digit5_domain


@DATASET_REGISTRY.register()
class PACS(DatasetBase):
    """7 classes x 4 styles (reference ``dg/pacs.py``)."""

    dataset_dir = "pacs"
    domains = ("art_painting", "cartoon", "photo", "sketch")
    # reference skips this known-corrupt image (dg/pacs.py:26)
    _error_paths = ("sketch/dog/n02103406_4068-1.png",)

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, "images")
        self.split_dir = osp.join(self.dataset_dir, "splits")
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "crossval")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "all")
        super().__init__(train_x=train, val=val, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            if split == "all":
                pairs = self._read_split(f"{dname}_train_kfold.txt")
                pairs += self._read_split(f"{dname}_crossval_kfold.txt")
            else:
                pairs = self._read_split(f"{dname}_{split}_kfold.txt")
            for impath, label in pairs:
                items.append(
                    Datum(impath=impath, label=label, domain=domain,
                          classname=impath.split("/")[-2])
                )
        return items

    def _read_split(self, filename):
        split_file = osp.join(self.split_dir, filename)
        if not osp.isfile(split_file):
            raise FileNotFoundError(
                f"{split_file} not found; expected splits/<domain>_"
                "{train,crossval}_kfold.txt"
            )
        pairs = []
        with open(split_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                impath, label = line.split(" ")
                if impath in self._error_paths:
                    continue
                # kfold files use 1-based labels (reference dg/pacs.py:93)
                pairs.append((osp.join(self.image_dir, impath), int(label) - 1))
        return pairs


@DATASET_REGISTRY.register()
class VLCS(DatasetBase):
    """5 classes x 4 photo collections (reference ``dg/vlcs.py``)."""

    dataset_dir = "VLCS"
    domains = ("caltech", "labelme", "pascal", "sun")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "crossval")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train, val=val, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            path = osp.join(self.dataset_dir, dname.upper(), split)
            _require_dir(path, "<DOMAIN>/{train,crossval,test}/<class>/*.jpg")
            for label, folder in enumerate(listdir_nohidden(path, sort=True)):
                for impath in glob.glob(osp.join(path, folder, "*.jpg")):
                    items.append(Datum(impath=impath, label=label,
                                       domain=domain))
        return items


def read_class_folder_split(dataset_dir, input_domains, split):
    """DigitsDG-layout reader: ``<domain>/{train,val}/<class>/*.jpg``,
    labels by sorted class-folder order; "all" concatenates train+val
    (reference ``dg/digits_dg.py:60-97``, reused by OfficeHomeDG)."""

    def _load_dir(directory):
        _require_dir(directory, "<domain>/{train,val}/<class>/*.jpg")
        pairs = []
        for label, folder in enumerate(listdir_nohidden(directory, sort=True)):
            for impath in glob.glob(osp.join(directory, folder, "*.jpg")):
                pairs.append((impath, label))
        return pairs

    items = []
    for domain, dname in enumerate(input_domains):
        if split == "all":
            pairs = _load_dir(osp.join(dataset_dir, dname, "train"))
            pairs += _load_dir(osp.join(dataset_dir, dname, "val"))
        else:
            pairs = _load_dir(osp.join(dataset_dir, dname, split))
        for impath, label in pairs:
            items.append(
                Datum(impath=impath, label=label, domain=domain,
                      classname=impath.split("/")[-2].lower())
            )
    return items


@DATASET_REGISTRY.register()
class DigitsDG(DatasetBase):
    """4 digit domains for DG (reference ``dg/digits_dg.py``)."""

    dataset_dir = "digits_dg"
    domains = ("mnist", "mnist_m", "svhn", "syn")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train = read_class_folder_split(
            self.dataset_dir, cfg.DATASET.SOURCE_DOMAINS, "train"
        )
        val = read_class_folder_split(
            self.dataset_dir, cfg.DATASET.SOURCE_DOMAINS, "val"
        )
        test = read_class_folder_split(
            self.dataset_dir, cfg.DATASET.TARGET_DOMAINS, "all"
        )
        super().__init__(train_x=train, val=val, test=test)


@DATASET_REGISTRY.register()
class OfficeHomeDG(DigitsDG):
    """Office-Home in the DG split layout (reference
    ``dg/office_home_dg.py``; shares DigitsDG's reader)."""

    dataset_dir = "office_home_dg"
    domains = ("art", "clipart", "product", "real_world")


@DATASET_REGISTRY.register()
class DigitSingle(DatasetBase):
    """Single-source DG over the digit5 folders (reference
    ``dg/digit_single.py``): deterministic first-10k train subsample,
    val = source test, test = target test."""

    dataset_dir = "digit5"
    domains = ("mnist", "mnist_m", "svhn", "syn", "usps")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "test")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train, val=val, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            for impath, label in load_digit5_domain(
                self.dataset_dir, dname, split, da_caps=False
            ):
                items.append(Datum(impath=impath, label=label, domain=domain))
        return items


# corruption types shipped by CIFAR-10-C/-100-C (reference dg/cifar_c.py:8-28)
AVAI_C_TYPES = [
    "brightness", "contrast", "defocus_blur", "elastic_transform", "fog",
    "frost", "gaussian_blur", "gaussian_noise", "glass_blur", "impulse_noise",
    "jpeg_compression", "motion_blur", "pixelate", "saturate", "shot_noise",
    "snow", "spatter", "speckle_noise", "zoom_blur",
]


@DATASET_REGISTRY.register()
class CIFAR10C(DatasetBase):
    """Clean CIFAR -> corrupted CIFAR-C (reference ``dg/cifar_c.py``).
    Source/target domain order is fixed; the corruption type/level select
    the test directory."""

    dataset_dir = ""
    domains = ("cifar10", "cifar10_c")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = root
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        source = cfg.DATASET.SOURCE_DOMAINS[0]
        target = cfg.DATASET.TARGET_DOMAINS[0]
        if source != self.domains[0] or target != self.domains[1]:
            raise ValueError(
                f"{type(self).__name__} requires SOURCE_DOMAINS="
                f"['{self.domains[0]}'] and TARGET_DOMAINS=['{self.domains[1]}']"
            )

        c_type = cfg.DATASET.CIFAR_C_TYPE
        c_level = cfg.DATASET.CIFAR_C_LEVEL
        if not c_type:
            raise ValueError("Please specify DATASET.CIFAR_C_TYPE in the config")
        if c_type not in AVAI_C_TYPES:
            raise ValueError(
                f"C_TYPE is expected to belong to {AVAI_C_TYPES}, "
                f'but got "{c_type}"'
            )
        if not 1 <= int(c_level) <= 5:
            raise ValueError(f"CIFAR_C_LEVEL must be in [1, 5], got {c_level}")

        train_dir = osp.join(self.dataset_dir, source, "train")
        test_dir = osp.join(self.dataset_dir, target, c_type, str(c_level))
        train = self._read_data(train_dir)
        test = self._read_data(test_dir)
        super().__init__(train_x=train, test=test)

    @staticmethod
    def _read_data(data_dir):
        _require_dir(data_dir, "<dir>/<class>/<image files>")
        items = []
        for label, class_name in enumerate(listdir_nohidden(data_dir, sort=True)):
            class_dir = osp.join(data_dir, class_name)
            for imname in listdir_nohidden(class_dir):
                items.append(
                    Datum(impath=osp.join(class_dir, imname), label=label,
                          domain=0)
                )
        return items


@DATASET_REGISTRY.register()
class CIFAR100C(CIFAR10C):
    dataset_dir = ""
    domains = ("cifar100", "cifar100_c")


# --------------------------------------------------------------------------
# WILDS benchmarks (reference ``dg/wilds/``)
# --------------------------------------------------------------------------

class WILDSBase(DatasetBase):
    """Shared WILDS plumbing (reference ``dg/wilds/wilds_base.py``).

    Primary path: a ``zhou_preloaded.pkl`` cache of {train,val,test} Datum
    lists inside the dataset dir — this requires no external packages. If
    absent, the `wilds` package (not baked into this image) is imported
    lazily to build and cache the splits. Few-shot: per-domain groups,
    NUM_SHOTS items per class per domain."""

    dataset_dir = ""
    relabel_domain = True

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        name = type(self).dataset_dir.split("_")[0]
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.preloaded = osp.join(self.dataset_dir, "zhou_preloaded.pkl")

        self.label_to_name = self.load_classnames()
        assert isinstance(self.label_to_name, dict)

        if osp.exists(self.preloaded):
            with open(self.preloaded, "rb") as f:
                dataset = _CompatUnpickler(f).load()
            train = self._normalize(dataset["train"])
            val = self._normalize(dataset["val"])
            test = self._normalize(dataset["test"])
        else:
            train, val, test = self._build_from_wilds(name, root)
            with open(self.preloaded, "wb") as f:
                pickle.dump({k: [vars(it).copy() for it in v]
                             for k, v in (("train", train), ("val", val), ("test", test))},
                            f, protocol=pickle.HIGHEST_PROTOCOL)

        k = cfg.DATASET.NUM_SHOTS
        if k > 0:
            groups = list(self.split_dataset_by_domain(train).values())
            groups = generate_fewshot_dataset(*groups, num_shots=k)
            if len(groups) and isinstance(groups[0], Datum):
                groups = [groups]  # single domain: one flat split came back
            train = [item for group in groups for item in group]

        super().__init__(train_x=train, val=val, test=test)

    @staticmethod
    def _normalize(items):
        """Accept Datum lists pickled by either package or by the reference
        (dassl Datum pickles as a dict of underscore-prefixed attributes),
        or plain dicts."""
        out = []
        for it in items:
            if isinstance(it, Datum):
                out.append(it)
            else:
                d = it if isinstance(it, dict) else vars(it)
                out.append(
                    Datum(
                        impath=d.get("_impath", d.get("impath", "")),
                        label=int(d.get("_label", d.get("label", 0))),
                        domain=int(d.get("_domain", d.get("domain", 0)) or 0),
                        classname=d.get("_classname", d.get("classname", "")),
                    )
                )
        return out

    def _build_from_wilds(self, name, root):
        try:
            from wilds import get_dataset as wilds_get_dataset
        except ImportError:
            raise FileNotFoundError(
                f"{self.preloaded} not found and the `wilds` package is not "
                "installed (zero-egress image). Provide the preloaded split "
                "pickle (keys train/val/test of Datum lists) or install wilds."
            ) from None
        dataset = wilds_get_dataset(dataset=name, root_dir=root, download=True)
        return (
            self.read_data(dataset.get_subset("train")),
            self.read_data(dataset.get_subset("val")),
            self.read_data(dataset.get_subset("test")),
        )

    def load_classnames(self):
        raise NotImplementedError

    def get_image_path(self, dataset, idx):
        return osp.join(self.dataset_dir, dataset._input_array[idx])

    def get_label(self, dataset, idx):
        return int(dataset.y_array[idx])

    def get_domain(self, dataset, idx):
        return int(dataset.metadata_array[idx][0])

    def read_data(self, subset):
        items = []
        dataset = subset.dataset
        for idx in subset.indices:
            label = self.get_label(dataset, idx)
            items.append(
                Datum(
                    impath=self.get_image_path(dataset, idx),
                    label=label,
                    domain=self.get_domain(dataset, idx),
                    classname=self.label_to_name[label],
                )
            )
        if self.relabel_domain:
            mapping = {d: i for i, d in enumerate({it.domain for it in items})}
            items = [
                Datum(impath=it.impath, label=it.label,
                      domain=mapping[it.domain], classname=it.classname)
                for it in items
            ]
        return items


@DATASET_REGISTRY.register()
class Camelyon17(WILDSBase):
    """Tumor-tissue recognition, 2 classes (reference
    ``dg/wilds/camelyon17.py``)."""

    dataset_dir = "camelyon17_v1.0"

    def load_classnames(self):
        return {0: "healthy tissue", 1: "tumor tissue"}


# FMoW's 62 building/land-use categories (reference dg/wilds/fmow.py:7-25)
FMOW_CATEGORIES = [
    "airport", "airport_hangar", "airport_terminal", "amusement_park",
    "aquaculture", "archaeological_site", "barn", "border_checkpoint",
    "burial_site", "car_dealership", "construction_site", "crop_field", "dam",
    "debris_or_rubble", "educational_institution", "electric_substation",
    "factory_or_powerplant", "fire_station", "flooded_road", "fountain",
    "gas_station", "golf_course", "ground_transportation_station", "helipad",
    "hospital", "impoverished_settlement", "interchange", "lake_or_pond",
    "lighthouse", "military_facility", "multi-unit_residential",
    "nuclear_powerplant", "office_building", "oil_or_gas_facility", "park",
    "parking_lot_or_garage", "place_of_worship", "police_station", "port",
    "prison", "race_track", "railway_bridge", "recreational_facility",
    "road_bridge", "runway", "shipyard", "shopping_mall",
    "single-unit_residential", "smokestack", "solar_farm", "space_facility",
    "stadium", "storage_tank", "surface_mine", "swimming_pool", "toll_booth",
    "tower", "tunnel_opening", "waste_disposal", "water_treatment_facility",
    "wind_farm", "zoo",
]


@DATASET_REGISTRY.register()
class FMoW(WILDSBase):
    """Satellite imagery, 62 classes; domain = region*16 + year
    (reference ``dg/wilds/fmow.py``)."""

    dataset_dir = "fmow_v1.1"

    def get_image_path(self, dataset, idx):
        idx = dataset.full_idxs[idx]
        return osp.join(self.dataset_dir, "images", f"rgb_img_{idx}.png")

    def get_domain(self, dataset, idx):
        region_id = int(dataset.metadata_array[idx][0])
        year_id = int(dataset.metadata_array[idx][1])
        return region_id * 16 + year_id

    def load_classnames(self):
        return dict(enumerate(FMOW_CATEGORIES))


@DATASET_REGISTRY.register()
class IWildCam(WILDSBase):
    """Animal species recognition, 182 classes (reference
    ``dg/wilds/iwildcam.py``; classnames from categories.csv)."""

    dataset_dir = "iwildcam_v2.0"

    def get_image_path(self, dataset, idx):
        return osp.join(self.dataset_dir, "train", dataset._input_array[idx])

    def load_classnames(self):
        import csv

        path = osp.join(self.dataset_dir, "categories.csv")
        if not osp.isfile(path):
            raise FileNotFoundError(
                f"{path} not found; IWildCam needs categories.csv with a "
                "'name' column (row order = label order)"
            )
        with open(path, newline="") as f:
            return {i: row["name"] for i, row in enumerate(csv.DictReader(f))}
