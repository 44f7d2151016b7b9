"""Decode-once uint8 image cache.

The port's copy of ``ovmr_tpu/data/cache.py``. The cache decodes and
geometry-normalises every training image ONCE into a uint8 memmap
(``[N, S, S, 3]``: smaller-edge resize and centre crop at a cache side larger
than the train crop, so the random-resized crop keeps its room), and epochs
stream batches at memcpy speed into the augmentation on the card
(:mod:`ovmr_tpu_torch.ops.augment`).

The file name, its fingerprint, the ``OVMR_CACHE_DIR`` variable and the
atomic build are the JAX package's, so either package reads a cache the
other wrote.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import tempfile
from typing import Sequence

import numpy as np

from ovmr_tpu_torch.utils.tools import mkdir_if_missing, read_image

from .transforms import center_crop, resize_smaller_edge


def _fingerprint(data_source, side: int) -> str:
    h = hashlib.sha1()
    h.update(str(side).encode())
    h.update(str(len(data_source)).encode())
    for item in data_source[:: max(1, len(data_source) // 64)]:
        h.update(item.impath.encode())
    return h.hexdigest()[:16]


class ImageArrayCache:
    """uint8 [N, side, side, 3] memmap over a Datum list, at
    ``{cache_dir}/imgs_{fingerprint}.npy``; ``cache_dir`` defaults to
    ``$OVMR_CACHE_DIR``, else ``ovmr_image_cache`` in the temp directory."""

    def __init__(self, data_source: Sequence, side: int = 256, cache_dir: str = None):
        self.data_source = list(data_source)
        self.side = side
        cache_dir = cache_dir or os.environ.get(
            "OVMR_CACHE_DIR", osp.join(tempfile.gettempdir(), "ovmr_image_cache"))
        mkdir_if_missing(cache_dir)
        tag = _fingerprint(self.data_source, side)
        self.path = osp.join(cache_dir, f"imgs_{tag}.npy")
        self.labels = np.asarray([d.label for d in self.data_source], np.int32)
        if not osp.exists(self.path):
            self._build()
        self.images = np.load(self.path, mmap_mode="r")

    def _build(self) -> None:
        n, s = len(self.data_source), self.side
        print(f"Building image cache {self.path}: {n} images @ {s}x{s}")
        # written under a temporary name and renamed when complete, so a
        # build cut short never leaves a file that reads as a cache
        arr = np.lib.format.open_memmap(
            self.path + ".tmp.npy", mode="w+", dtype=np.uint8, shape=(n, s, s, 3))
        for i, item in enumerate(self.data_source):
            img = center_crop(resize_smaller_edge(read_image(item.impath), s), (s, s))
            a = np.asarray(img, np.uint8)
            if a.ndim == 2:
                a = np.stack([a] * 3, -1)
            arr[i] = a
        arr.flush()
        del arr
        os.replace(self.path + ".tmp.npy", self.path)

    def batch(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(self.images[np.asarray(indices)])


class CachedClassBatchLoader:
    """Class-grouped uint8 batches from the cache (RandomClassSampler
    semantics), for the device-augmented training path: epoch ``e`` draws
    its indices from ``np.random.default_rng(seed + e)``, as the JAX
    loader does."""

    def __init__(self, cache: ImageArrayCache, sampler, batch_size: int, seed: int = 0):
        self.cache = cache
        self.sampler = sampler
        self.batch_size = batch_size
        self._seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        rng = np.random.default_rng(self._seed)
        return len(self.sampler.epoch_indices(rng)) // self.batch_size

    def __iter__(self):
        rng = np.random.default_rng(self._seed + self._epoch)
        indices = self.sampler.epoch_indices(rng)
        self._epoch += 1
        for start in range(0, len(indices) - self.batch_size + 1, self.batch_size):
            sel = indices[start: start + self.batch_size]
            yield {
                "img_u8": self.cache.batch(sel),
                "label": self.cache.labels[sel],
                "index": sel,
            }
