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

``DATALOADER.MULTI_RES_COLLATE`` gives the train loader the batch-level
multi-resolution collate of :mod:`ovmr_tpu_torch.data.multires` (raw
decode, one drawn shape a batch). A trainer that passes
``tfm_train_strong`` (DAELDG) gets the strong view of every training image
as ``img2``, drawn as the JAX loader draws it. ``train_loader_u`` is the
unlabeled loader of the DA/SSL trainers (the target domain or the
unlabeled pool: ``DATALOADER.TRAIN_U``, or TRAIN_X's settings with
``TRAIN_U.SAME_AS_X``, seeded one past the labeled stream).
``DATALOADER.RETURN_IMG0`` adds the un-augmented image (resized to SIZE,
normalised where configured) as ``img0``; ``TEXT_ONLY`` train batches carry
labels and paths and decode no image.

The sliced decode (JAX ``:50-58``, ``:159-172``, ``:275-330``): under a
process group whose mesh has a data axis > 1, a trainer that opts in
(``allow_local_batches``) has each rank decode only its data shard's
contiguous block of every training batch (``_local`` True in the batch).
The block is taken by the rank's data coordinate, not its rank, so the
model shards of one data row decode the same rows; the augmentation's
position offset and the multi-res batch rng keyed on the global start
keep the sliced rows pixel-identical to a full decode.
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
        multi_res=None,
        local_block=None,
        local_multiple: int = 1,
        transform2=None,
        text_only: bool = False,
        return_img0: bool = False,
        img0_transform=None,
    ):
        # (data shard, data axis size) of the sliced decode, None: every
        # process decodes the whole batch. local_multiple: the row multiple
        # a whole batch needs for a slice to be taken (the data axis, times
        # the class group size under RandomClassSampler)
        self.local_block = local_block
        self.local_multiple = max(local_multiple, 1)
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
        # batch-level multi-resolution collate (data/multires.py): decodes
        # raw images and crops/resizes the whole batch to one drawn shape,
        # in place of the per-image transform
        self.multi_res = multi_res
        # second (strong) transform -> "img2" in every batch (DAEL's weak +
        # strong pairs); it follows K_TRANSFORMS as the primary one does
        self.transform2 = transform2
        # TEXT_ONLY (reference DatasetWrapper, ``data_manager.py:311-312``):
        # batches of labels and paths, no image read
        self.text_only = text_only
        # RETURN_IMG0 (reference ``data_manager.py:330-331``): the
        # un-augmented image too, under "img0"
        self.return_img0 = return_img0
        self.img0_transform = img0_transform
        if multi_res is not None and (self.k_transforms > 1 or transform2 is not None
                                      or return_img0 or text_only):
            raise ValueError(_MULTI_RES_EXCLUSIVE)
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
        img2 = None
        if self.transform2 is not None:
            if getattr(self.transform2, "stochastic", False):
                # an int tag (1) keeps the strong stream apart from the
                # primary one, as the JAX loader keys it
                img2 = [
                    self.transform2(
                        img,
                        rng=random.Random(
                            hash((self._seed, epoch, int(position), 1, k)) & 0xFFFFFFFF),
                    )
                    for k in range(self.k_transforms)
                ]
            else:
                img2 = [self.transform2(img) for _ in range(self.k_transforms)]
        img0 = None
        if self.return_img0:
            tfm0 = self.img0_transform
            img0 = (tfm0(img) if tfm0 is not None
                    else np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)
        return arrs, item.label, item.impath, item.domain, img2, img0

    def _local_view(self, batch_idx):
        """This shard's contiguous block of a batch's indices:
        ``(sub_idx, position_offset, is_local)``; a batch that does not
        split (a ragged tail) is decoded whole (JAX ``_local_view`` :159)."""
        if self.local_block is None:
            return batch_idx, 0, False
        shard, shards = self.local_block
        if len(batch_idx) % max(self.local_multiple, shards):
            return batch_idx, 0, False
        loc = len(batch_idx) // shards
        return batch_idx[shard * loc:(shard + 1) * loc], shard * loc, True

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self._seed + self._epoch)
        indices = self.sampler.epoch_indices(rng)
        self._epoch += 1
        epoch = self._epoch - 1

        if self.text_only:
            for start in range(0, len(indices), self.batch_size):
                batch_idx = indices[start : start + self.batch_size]
                if self.drop_last and len(batch_idx) < self.batch_size:
                    break
                sub_idx, _, is_local = self._local_view(batch_idx)
                items = [self.data_source[i] for i in sub_idx]
                yield {
                    "label": np.asarray([it.label for it in items], np.int32),
                    "impath": [it.impath for it in items],
                    "index": np.asarray(sub_idx, np.int64),
                    "_local": is_local,
                }
            return

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(indices), self.batch_size):
                batch_idx = indices[start : start + self.batch_size]
                if self.drop_last and len(batch_idx) < self.batch_size:
                    break
                sub_idx, pos_off, is_local = self._local_view(batch_idx)
                if self.multi_res is not None:
                    # one rng a batch, keyed on the whole batch's start in
                    # the epoch's index stream (JAX ``manager.py:202-216``)
                    items = [self.data_source[i] for i in sub_idx]
                    pils = list(pool.map(lambda it: read_image(it.impath), items))
                    brng = random.Random(hash((self._seed, epoch, int(start), 11)) & 0xFFFFFFFF)
                    yield {
                        "img": self.multi_res(pils, brng),
                        "label": np.asarray([it.label for it in items], np.int32),
                        "impath": [it.impath for it in items],
                        "index": np.asarray(sub_idx, np.int64),
                        "_local": is_local,
                        "domain": np.asarray([it.domain for it in items], np.int32),
                    }
                    continue
                results = list(
                    pool.map(
                        lambda args: self._load_one(args[1], epoch, start + pos_off + args[0]),
                        enumerate(sub_idx),
                    )
                )
                k = len(results[0][0])
                imgs = np.stack([arr for r in results for arr in r[0]])
                if imgs.dtype != np.uint8:  # uint8 ships as-is (normalised on the device)
                    imgs = imgs.astype(np.float32, copy=False)
                out = {
                    "img": imgs,
                    "label": np.repeat(np.asarray([r[1] for r in results], np.int32), k),
                    "impath": [r[2] for r in results for _ in range(k)],
                    "index": np.repeat(np.asarray(sub_idx, np.int64), k),
                    "_local": is_local,
                    # source-domain index (0 for the OVMR datasets)
                    "domain": np.repeat(np.asarray([r[3] for r in results], np.int32), k),
                }
                if self.return_img0:
                    out["img0"] = np.repeat(
                        np.stack([r[5] for r in results]).astype(np.float32, copy=False), k, axis=0)
                if self.transform2 is not None:
                    out["img2"] = np.stack([a for r in results for a in r[4]]).astype(
                        np.float32, copy=False)
                yield out


_MULTI_RES_EXCLUSIVE = (
    "MULTI_RES_COLLATE replaces the per-image transform pipeline; it cannot combine with "
    "K_TRANSFORMS>1, strong transforms, RETURN_IMG0 or TEXT_ONLY"
)


def build_multi_res(cfg):
    """The train loaders' :class:`MultiResCollate` when
    ``DATALOADER.MULTI_RES_COLLATE`` is set, else None. Its dims floor to
    the backbone's patch size where the backbone is a known ViT (no pixel
    column is cropped by the stride-p patchify), else to the reference's
    14 (JAX ``manager.py:337-349``)."""
    if not cfg.DATALOADER.get("MULTI_RES_COLLATE", False):
        return None
    if cfg.DATALOADER.RETURN_IMG0 or cfg.TEXT_ONLY:
        raise ValueError(_MULTI_RES_EXCLUSIVE)
    from ovmr_tpu_torch.models.clip import CONFIGS

    from .multires import MultiResCollate

    patch = 14
    backbone = CONFIGS.get(cfg.MODEL.BACKBONE.NAME)
    if backbone is not None and not backbone.is_resnet:
        patch = backbone.vision_patch_size
    return MultiResCollate(patch_size=patch)


def local_block_of(cfg, allow_local_batches=False, local_model_axis: int = 1):
    """``(local_block, local_multiple)`` of the sliced decode for this
    rank (JAX ``DataManager`` :283-330): with ``allow_local_batches``,
    ``CUDA.MULTIHOST_SLICED_LOADER`` and a process group whose data axis
    (``CUDA.MESH.DATA``, -1 resolved as the trainers' mesh resolves it:
    the ranks over ``local_model_axis``) is > 1, the block of the rank's
    data coordinate ``rank // model``. JAX slices by process with the model
    axis inside a process; here a card is a rank, so the ranks of one data
    row decode the same block. Else ``(None, 1)``."""
    from ovmr_tpu_torch.parallel.multihost import rank, world

    n = world()
    if (not allow_local_batches or n == 1 or not cfg.CUDA.MULTIHOST_SLICED_LOADER
            or cfg.DATALOADER.RETURN_IMG0 or cfg.TEXT_ONLY):
        return None, 1
    model = max(int(local_model_axis), 1)
    data = int(cfg.CUDA.MESH.DATA)
    if data == -1:
        data = n // model
    if data <= 1 or data * model != n:
        return None, 1
    mult = data
    if cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomClassSampler":
        mult *= max(cfg.DATALOADER.TRAIN_X.N_INS, 1)
    return (rank() // model, data), mult


class DataManager:
    def __init__(self, cfg, dataset: Optional[DatasetBase] = None,
                 allow_local_batches=False, local_model_axis: int = 1, tfm_train_strong=None):
        self.cfg = cfg
        self._local_block, self._local_multiple = local_block_of(
            cfg, allow_local_batches, local_model_axis)
        multi_res = build_multi_res(cfg)
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
        img0_tfm = None
        if cfg.DATALOADER.RETURN_IMG0:
            from .transforms import to_tensor_transform

            img0_tfm = to_tensor_transform(cfg)
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
            multi_res=multi_res,
            local_block=self._local_block,
            local_multiple=self._local_multiple,
            transform2=tfm_train_strong,
            text_only=bool(cfg.TEXT_ONLY),
            return_img0=bool(cfg.DATALOADER.RETURN_IMG0),
            img0_transform=img0_tfm,
            # reference: drop_last = is_train and len >= batch_size
            # (data_manager.py:107) — the ragged tail batch is dropped,
            # keeping step shapes static and the epoch counts and
            # iteration-annealed schedules reference-exact
            drop_last=len(ds.train_x) >= cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
        ) if ds.train_x else None

        # unlabeled loader (DA target domain / SSL unlabeled pool); the
        # reference clones the TRAIN_X settings when SAME_AS_X (JAX
        # ``manager.py:395-423``); drop_last keeps the step shapes static
        loaders = cfg.DATALOADER
        u_cfg = loaders.TRAIN_X if loaders.TRAIN_U.SAME_AS_X else loaders.TRAIN_U
        self.train_loader_u = HostDataLoader(
            ds.train_u,
            build_sampler(u_cfg.SAMPLER, ds.train_u, u_cfg.BATCH_SIZE, u_cfg.N_INS,
                          u_cfg.N_DOMAIN),
            tfm_train,
            u_cfg.BATCH_SIZE,
            seed=seed + 1,  # decorrelated from the labeled stream
            num_workers=nw,
            drop_last=len(ds.train_u) >= u_cfg.BATCH_SIZE,
            k_transforms=cfg.DATALOADER.K_TRANSFORMS,
            transform2=tfm_train_strong,
            local_block=self._local_block,
            local_multiple=self._local_multiple,
            multi_res=multi_res,
        ) if getattr(ds, "train_u", None) else None

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
        # reference dm.num_source_domains (dassl data_manager.py); without
        # SOURCE_DOMAINS (synthetic and OVMR datasets) the count of train_x's
        # domain ids, so domain classifiers and experts fit their labels
        n_src = len(cfg.DATASET.SOURCE_DOMAINS)
        if n_src == 0:
            n_src = max((d.domain for d in ds.train_x), default=0) + 1
        self.num_source_domains = max(n_src, 1)

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
