"""Misc utilities: seeding, filesystem helpers, image reading.

The port's copy of ``ovmr_tpu/utils/tools.py`` (reference
``dassl/utils/tools.py``): seeding covers python, numpy and torch, and the
environment report names torch, CUDA and the card. PIL is imported only
where an image is read.
"""

from __future__ import annotations

import errno
import os
import os.path as osp
import random
from typing import List

import numpy as np


def set_random_seed(seed: int) -> None:
    """Seed python, numpy and torch (every device)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_if_missing(dirname: str) -> None:
    if not osp.exists(dirname):
        try:
            os.makedirs(dirname)
        except OSError as e:  # pragma: no cover - race with other process
            if e.errno != errno.EEXIST:
                raise


def check_isfile(fpath: str) -> bool:
    """True iff `fpath` is an existing file; warns when a non-empty path
    is not (reference ``dassl/utils/tools.py::check_isfile``)."""
    isfile = osp.isfile(fpath)
    if not isfile and fpath:
        print(f'No file found at "{fpath}"')
    return isfile


def listdir_nohidden(path: str, sort: bool = False) -> List[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


def read_image(path: str):
    """Read an image as PIL RGB, retrying on transient filesystem errors
    (reference keeps retrying forever, ``dassl/utils/tools.py:113-122``;
    this caps at a few attempts and surfaces the error)."""
    from PIL import Image

    if not osp.exists(path):
        raise IOError(f"No file exists at {path}")

    last_err = None
    for _ in range(3):
        try:
            return Image.open(path).convert("RGB")
        except OSError as e:  # pragma: no cover - IO flake
            last_err = e
    raise IOError(f"Cannot read image from {path}: {last_err}")


def collect_env_info() -> str:
    import platform

    import torch

    lines = [
        f"python: {platform.python_version()}",
        f"torch: {torch.__version__}",
        f"CUDA (torch build): {torch.version.cuda}",
        f"CUDA available: {torch.cuda.is_available()}",
    ]
    if torch.cuda.is_available():
        lines.append(
            f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}"
        )
    return "\n".join(lines)
