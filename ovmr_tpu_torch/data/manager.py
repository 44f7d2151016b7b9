"""DataManager + host data loader.

The port's copy of ``ovmr_tpu/data/manager.py`` (``HostDataLoader`` :32,
``DataManager`` :269) for one process. The reference wires torch
DataLoaders in ``dassl/data/data_manager.py``; here a loader is a
seed-stable python iterator producing numpy batches ``{"img": [B,3,H,W]
float32 (or [B,H,W,3] uint8), "label": [B] int32, "impath": list}`` with a
thread pool overlapping image decode + augmentation with device compute.
The batches are the JAX package's, item for item and pixel for pixel.

Loader lineup matches the reference (``data_manager.py:116-246``):
- ``train_loader_x``: TRAIN_X sampler/batch (OVMR: RandomClassSampler 1536/8)
- ``val_loader`` / ``test_loader``: sequential, test transform
- ``eval_set_loader``: RandomClassSampler over the exemplar split with
  n_ins = DATASET.NUM_SHOTS and the TEST transform — the source of
  classifier-generation exemplars (``data_manager.py:156-170``).

Not ported yet, and refused by :class:`DataManager`: the multi-resolution
collate (``DATALOADER.MULTI_RES_COLLATE``), ``RETURN_IMG0`` and
``TEXT_ONLY`` batches, which the Dassl families use, and the unlabeled
loader ``train_loader_u``. The JAX package's per-host sliced decode
(``:283-330``) is a no-op in one process.
"""

from __future__ import annotations

import concurrent.futures as cf
import random
from typing import Dict, Iterator, Optional

import numpy as np

from ovmr_tpu_torch.utils.tools import read_image

from .datum import DatasetBase
from .registry import build_dataset
from .samplers import build_sampler
from .transforms import build_transform


class HostDataLoader:
    """Iterates epochs of transformed image batches."""

    def __init__(
        self,
        data_source,
        sampler,
        transform,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 8,
        drop_last: bool = False,
        k_transforms: int = 1,
    ):
        self.data_source = data_source
        self.sampler = sampler
        self.transform = transform
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        # K>1 applies the (stochastic) transform K times per image and emits
        # the variants adjacently: img [B*K, ...], label repeated K times
        # (reference K_TRANSFORMS, ``data_manager.py:334-344``)
        self.k_transforms = max(1, k_transforms)
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        rng = np.random.default_rng(self._seed)
        n = len(self.sampler.epoch_indices(rng))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_one(self, idx: int, epoch: int = 0, position: int = 0):
        item = self.data_source[idx]
        img = read_image(item.impath)
        if self.transform is None:
            arrs = [np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0]
        elif getattr(self.transform, "stochastic", False):
            # rng derives from the POSITION in the epoch index stream (not
            # the dataset index): thread-order independent, deterministic
            # per seed/epoch, and duplicate indices (few-shot classes
            # resampled with replacement) still get fresh draws
            arrs = [
                self.transform(
                    img,
                    # tuple-of-ints hash is deterministic across processes
                    rng=random.Random(
                        hash((self._seed, epoch, int(position), k)) & 0xFFFFFFFF
                    ),
                )
                for k in range(self.k_transforms)
            ]
        else:
            arrs = [self.transform(img) for _ in range(self.k_transforms)]
        return arrs, item.label, item.impath, item.domain

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self._seed + self._epoch)
        indices = self.sampler.epoch_indices(rng)
        self._epoch += 1
        epoch = self._epoch - 1

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(indices), self.batch_size):
                batch_idx = indices[start : start + self.batch_size]
                if self.drop_last and len(batch_idx) < self.batch_size:
                    break
                results = list(
                    pool.map(
                        lambda args: self._load_one(args[1], epoch, start + args[0]),
                        enumerate(batch_idx),
                    )
                )
                k = len(results[0][0])
                imgs = np.stack([arr for r in results for arr in r[0]])
                if imgs.dtype != np.uint8:  # uint8 ships as-is (normalised on the device)
                    imgs = imgs.astype(np.float32, copy=False)
                yield {
                    "img": imgs,
                    "label": np.repeat(np.asarray([r[1] for r in results], np.int32), k),
                    "impath": [r[2] for r in results for _ in range(k)],
                    "index": np.repeat(np.asarray(batch_idx, np.int64), k),
                    # source-domain index (0 for the OVMR datasets)
                    "domain": np.repeat(np.asarray([r[3] for r in results], np.int32), k),
                }


class DataManager:
    def __init__(self, cfg, dataset: Optional[DatasetBase] = None):
        self.cfg = cfg
        for key, value in (
            ("DATALOADER.MULTI_RES_COLLATE", cfg.DATALOADER.get("MULTI_RES_COLLATE", False)),
            ("DATALOADER.RETURN_IMG0", cfg.DATALOADER.RETURN_IMG0),
            ("TEXT_ONLY", cfg.TEXT_ONLY),
        ):
            if value:
                raise NotImplementedError(
                    f"{key} True is not ported yet (ROADMAP Queue 1: "
                    "data/multires.py in item 1b', the Dassl loaders in item 7)"
                )
        self.dataset = dataset if dataset is not None else build_dataset(cfg)

        tfm_train = build_transform(cfg, is_train=True)
        # eval transfers ship uint8 by default; the device normalises them
        # to the same numbers as the host path (ops/preprocess.normalize_u8)
        eval_u8 = bool(cfg.CUDA.EVAL_UINT8_TRANSFER)
        tfm_test = build_transform(cfg, is_train=False, uint8=eval_u8)
        self.tfm_train, self.tfm_test = tfm_train, tfm_test
        self.eval_uint8 = eval_u8
        nw = cfg.DATALOADER.NUM_WORKERS
        seed = max(cfg.SEED, 0)

        ds = self.dataset
        self.train_loader_x = HostDataLoader(
            ds.train_x,
            build_sampler(
                cfg.DATALOADER.TRAIN_X.SAMPLER,
                ds.train_x,
                cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                cfg.DATALOADER.TRAIN_X.N_INS,
                cfg.DATALOADER.TRAIN_X.N_DOMAIN,
            ),
            tfm_train,
            cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
            seed=seed,
            num_workers=nw,
            k_transforms=cfg.DATALOADER.K_TRANSFORMS,
            # reference: drop_last = is_train and len >= batch_size
            # (data_manager.py:107) — the ragged tail batch is dropped,
            # keeping step shapes static and the epoch counts and
            # iteration-annealed schedules reference-exact
            drop_last=len(ds.train_x) >= cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
        ) if ds.train_x else None

        self.val_loader = HostDataLoader(
            ds.val,
            build_sampler("SequentialSampler", ds.val, cfg.DATALOADER.TEST.BATCH_SIZE),
            tfm_test,
            cfg.DATALOADER.TEST.BATCH_SIZE,
            seed=seed,
            num_workers=nw,
        ) if ds.val else None

        self.test_loader = HostDataLoader(
            ds.test,
            build_sampler("SequentialSampler", ds.test, cfg.DATALOADER.TEST.BATCH_SIZE),
            tfm_test,
            cfg.DATALOADER.TEST.BATCH_SIZE,
            seed=seed,
            num_workers=nw,
        ) if ds.test else None

        # exemplar loader: class-grouped, NUM_SHOTS instances per class,
        # test-time transform (is_train=False contract of the reference).
        # Batch size rounds DOWN to a whole number of per-class groups so a
        # batch never splits a class's exemplars (the consumers reshape by
        # `shots`; a ragged batch would silently mix classes)
        shots = max(cfg.DATASET.NUM_SHOTS, 1)
        eval_bs = max(cfg.DATALOADER.TEST.BATCH_SIZE, shots)
        eval_bs -= eval_bs % shots
        self.eval_set_loader = HostDataLoader(
            ds.eval_set,
            build_sampler("RandomClassSampler", ds.eval_set, eval_bs, shots),
            tfm_test,
            eval_bs,
            seed=seed,
            num_workers=nw,
        ) if ds.eval_set else None

        self.num_classes = ds.num_classes
        self.lab2cname = ds.lab2cname

    def show_dataset_summary(self):
        cfg = self.cfg
        ds = self.dataset
        rows = [
            ("Dataset", cfg.DATASET.NAME),
            ("# classes", f"{self.num_classes:,}"),
            ("# train_x", f"{len(ds.train_x):,}"),
            ("# val", f"{len(ds.val):,}" if ds.val else "0"),
            ("# test", f"{len(ds.test):,}"),
        ]
        width = max(len(r[0]) for r in rows) + 2
        print("***** Dataset statistics *****")
        for k, v in rows:
            print(f"  {k:<{width}} {v}")
