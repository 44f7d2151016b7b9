"""Domain-adaptation dataset loaders (reference
``Dassl.pytorch/dassl/data/datasets/da/``).

The port's copy of ``ovmr_tpu/data/datasets/da.py``, with the same on-disk
contracts as the reference so its prepared dataset directories load
unchanged:

- Digit5 (``da/digit5.py``): per-domain ``{train,test}_images/`` folders of
  ``*_<label>.<ext>`` files; 25k/9k random subsample (USPS train x3).
- VisDA17 (``da/visda17.py``): ``{train,validation}/image_list.txt`` lines
  of ``relpath label``.
- CIFARSTL (``da/cifarstl.py``): ``<domain>/<split>/<label>_<name>/`` class
  folders where the label is the leading integer of the folder name.
- Office31 / OfficeHome (``da/office31.py``, ``da/office_home.py``):
  ``<domain>/<class_name>/`` folder trees, labels by sorted folder order.
- DomainNet / miniDomainNet (``da/domainnet.py``, ``da/mini_domainnet.py``):
  ``splits{,_mini}/<domain>_{train,test}.txt`` lines of ``relpath label``.

Every loader fills ``train_x`` from SOURCE_DOMAINS and ``train_u``/``test``
from TARGET_DOMAINS with 0-based per-list domain ids, as the reference's
trainers expect. ``_require_dir`` and ``load_digit5_domain`` also serve the
DG loaders of :mod:`ovmr_tpu_torch.data.datasets.dg`.

No auto-download: a missing directory raises with the expected layout.
"""

from __future__ import annotations

import os.path as osp
import random

from ovmr_tpu_torch.utils.tools import listdir_nohidden

from ..datum import DatasetBase, Datum
from ..registry import DATASET_REGISTRY


def _require_dir(path: str, hint: str):
    if not osp.isdir(path):
        raise FileNotFoundError(
            f"Dataset directory {path} not found; expected layout: {hint} "
            "(no auto-download in this zero-egress environment)"
        )


def _read_folder_tree(domain_dir: str, domain: int, lower: bool = False):
    """images grouped as <domain_dir>/<class_name>/*; labels by sorted
    class-folder order (reference ``da/office31.py:42-63``)."""
    _require_dir(domain_dir, "<domain>/<class_name>/<image files>")
    items = []
    class_names = listdir_nohidden(domain_dir, sort=True)
    for label, class_name in enumerate(class_names):
        class_path = osp.join(domain_dir, class_name)
        for imname in listdir_nohidden(class_path):
            items.append(
                Datum(
                    impath=osp.join(class_path, imname),
                    label=label,
                    domain=domain,
                    classname=class_name.lower() if lower else class_name,
                )
            )
    return items


def _read_image_list(im_dir: str, n_max=None, n_repeat=None, sample=True):
    """Flat folder of ``<anything>_<label>.<ext>`` files (reference
    ``da/digit5.py:17-32``; DG's digit_single truncates instead of
    sampling, hence ``sample``)."""
    _require_dir(im_dir, "flat folder of <name>_<label>.<ext> images")
    items = []
    for imname in listdir_nohidden(im_dir):
        label = int(osp.splitext(imname)[0].split("_")[1])
        items.append((osp.join(im_dir, imname), label))
    if n_max is not None and len(items) > n_max:
        items = random.sample(items, n_max) if sample else items[:n_max]
    if n_repeat is not None:
        items *= n_repeat
    return items


# digit-5 per-domain sampling policy (reference ``da/digit5.py:35-60``):
# 25k train / 9k test for all but USPS, whose train set repeats 3x.
_DIGIT5_DIRS = {"train": "train_images", "test": "test_images"}


def load_digit5_domain(dataset_dir: str, dname: str, split: str, sample=True,
                       da_caps=True):
    im_dir = osp.join(dataset_dir, dname, _DIGIT5_DIRS[split])
    if not da_caps:
        # DG protocol (reference ``dg/digit_single.py:36-61``): first 10k
        # train images (not random), full test; USPS never repeats.
        n_max = 10000 if (split == "train" and dname != "usps") else None
        return _read_image_list(im_dir, n_max=n_max, sample=False)
    if dname == "usps":
        return _read_image_list(im_dir, n_repeat=3 if split == "train" else None)
    return _read_image_list(
        im_dir, n_max=25000 if split == "train" else 9000, sample=sample
    )


@DATASET_REGISTRY.register()
class Digit5(DatasetBase):
    """Five digit domains (reference ``da/digit5.py:63-124``)."""

    dataset_dir = "digit5"
    domains = ("mnist", "mnist_m", "svhn", "syn", "usps")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS, "train")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            for impath, label in load_digit5_domain(
                self.dataset_dir, dname, split
            ):
                items.append(
                    Datum(impath=impath, label=label, domain=domain,
                          classname=str(label))
                )
        return items


@DATASET_REGISTRY.register()
class VisDA17(DatasetBase):
    """Synthetic-to-real shift (reference ``da/visda17.py``)."""

    dataset_dir = "visda17"
    domains = ("synthetic", "real")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train_x = self._read_data("synthetic")
        train_u = self._read_data("real")
        test = self._read_data("real")
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, dname):
        filedir = "train" if dname == "synthetic" else "validation"
        image_list = osp.join(self.dataset_dir, filedir, "image_list.txt")
        if not osp.isfile(image_list):
            raise FileNotFoundError(
                f"{image_list} not found; expected {filedir}/image_list.txt "
                "with 'relpath label' lines"
            )
        items = []
        with open(image_list) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                impath, label = line.split(" ")
                items.append(
                    Datum(
                        impath=osp.join(self.dataset_dir, filedir, impath),
                        label=int(label),
                        domain=0,  # single source domain, reference behavior
                        classname=impath.split("/")[0],
                    )
                )
        return items


@DATASET_REGISTRY.register()
class CIFARSTL(DatasetBase):
    """CIFAR-10 <-> STL-10 9-class overlap (reference ``da/cifarstl.py``).

    Class folders are named ``<label>_<classname>``."""

    dataset_dir = "cifar_stl"
    domains = ("cifar", "stl")

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS, "train")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            data_dir = osp.join(self.dataset_dir, dname, split)
            _require_dir(data_dir, "<domain>/<split>/<label>_<name>/")
            for class_name in listdir_nohidden(data_dir):
                class_dir = osp.join(data_dir, class_name)
                label = int(class_name.split("_")[0])
                for imname in listdir_nohidden(class_dir):
                    items.append(
                        Datum(impath=osp.join(class_dir, imname),
                              label=label, domain=domain)
                    )
        return items


@DATASET_REGISTRY.register()
class Office31(DatasetBase):
    """31 office-object classes, 3 domains (reference ``da/office31.py``)."""

    dataset_dir = "office31"
    domains = ("amazon", "webcam", "dslr")
    _lower_classnames = False

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS)
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS)
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS)
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, input_domains):
        items = []
        for domain, dname in enumerate(input_domains):
            items += _read_folder_tree(
                osp.join(self.dataset_dir, dname), domain,
                lower=self._lower_classnames,
            )
        return items


@DATASET_REGISTRY.register()
class OfficeHome(Office31):
    """65 office/home classes, 4 domains (reference ``da/office_home.py``;
    classnames lowercased there, unlike Office31)."""

    dataset_dir = "office_home"
    domains = ("art", "clipart", "product", "real_world")
    _lower_classnames = True


class _SplitFileDataset(DatasetBase):
    """Shared recipe for DomainNet-style datasets: per-domain split files of
    ``relpath label`` lines, classname = 2nd path component."""

    split_dirname = "splits"
    splits = ("train", "test")
    has_val = False

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self.split_dir = osp.join(self.dataset_dir, self.split_dirname)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS
        )
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS, "train")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        kwargs = {}
        if self.has_val:
            kwargs["val"] = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "test")
        super().__init__(train_x=train_x, train_u=train_u, test=test, **kwargs)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            split_file = osp.join(self.split_dir, f"{dname}_{split}.txt")
            if not osp.isfile(split_file):
                raise FileNotFoundError(
                    f"{split_file} not found; expected "
                    f"{self.split_dirname}/<domain>_<split>.txt"
                )
            with open(split_file) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    impath, label = line.split(" ")
                    items.append(
                        Datum(
                            impath=osp.join(self.dataset_dir, impath),
                            label=int(label),
                            domain=domain,
                            classname=impath.split("/")[1],
                        )
                    )
        return items


@DATASET_REGISTRY.register()
class DomainNet(_SplitFileDataset):
    """345 classes, 6 domains (reference ``da/domainnet.py``; val = the
    source domains' test files, reference line 42)."""

    dataset_dir = "domainnet"
    domains = ("clipart", "infograph", "painting", "quickdraw", "real",
               "sketch")
    split_dirname = "splits"
    has_val = True


@DATASET_REGISTRY.register()
class miniDomainNet(_SplitFileDataset):
    """126-class 4-domain subset (reference ``da/mini_domainnet.py``;
    splits_mini/, no val)."""

    dataset_dir = "domainnet"
    domains = ("clipart", "painting", "real", "sketch")
    split_dirname = "splits_mini"
    has_val = False
