"""Domain-adaptation dataset helpers (reference
``Dassl.pytorch/dassl/data/datasets/da/``).

The start of the port's ``ovmr_tpu/data/datasets/da.py``: the directory
check and the Digit-5 folder reader (``_require_dir`` :37,
``load_digit5_domain`` :86), which the DG loaders of
:mod:`ovmr_tpu_torch.data.datasets.dg` read with. The DA loaders
themselves (Digit5, VisDA17, Office31, DomainNet...) come with the DA
trainers.

No auto-download: a missing directory raises with the expected layout.
"""

from __future__ import annotations

import os.path as osp
import random

from ovmr_tpu_torch.utils.tools import listdir_nohidden


def _require_dir(path: str, hint: str):
    if not osp.isdir(path):
        raise FileNotFoundError(
            f"Dataset directory {path} not found; expected layout: {hint} "
            "(no auto-download in this zero-egress environment)"
        )


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
