"""CLIP feature extractor for the linear-probe baseline.

Counterpart of the repo's ``lpclip/feat_extractor.py`` (reference
``lpclip/feat_extractor.py:105-167``): dump the raw (not unit-norm) CLIP
image features of a dataset split to ``{OUTPUT_DIR}/{DATASET}/{split}.npz``
with keys ``feature_list`` and ``label_list``, which the unchanged
``lpclip/linear_probe.py`` reads. The image tower runs on ``CUDA.DEVICE``
(the card, K1/K2 a block; ``CUDA.DEVICE cpu`` runs their plain twins), on a
mesh where ``CUDA.MESH`` asks for one (the trainers' policy,
:func:`ovmr_tpu_torch.engine.trainer.setup_trainer_mesh`).

Usage::

    python -m ovmr_tpu_torch.lpclip --root ./data --dataset-config-file \\
        configs/datasets/eurosat.yaml --split train --output-dir ./lpclip_feats
    python lpclip/linear_probe.py --dataset EuroSAT --feature_dir ./lpclip_feats
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def setup_cfg(args):
    """The trainer yaml (which names the backbone), the dataset yaml, the
    reference script's overrides, then the trailing ``KEY VALUE`` opts."""
    from ovmr_tpu_torch.utils import get_cfg_default

    cfg = get_cfg_default()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
        args.backbone = cfg.MODEL.BACKBONE.NAME or args.backbone
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    cfg.DATASET.ROOT = args.root
    cfg.OUTPUT_DIR = args.output_dir
    cfg.SEED = args.seed
    cfg.DATASET.NUM_SHOTS = -1
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    cfg.INPUT.TRANSFORMS = ["normalize"]
    cfg.MODEL.BACKBONE.NAME = args.backbone
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    return cfg


def main(args) -> str:
    """Write the split's npz; returns its path."""
    return dump(*build(args))


def build(args):
    """``(cfg, split, loader, encode, clip_params)`` of a dump: the split's
    sequential loader and the image tower on ``CUDA.DEVICE`` in
    ``CUDA.DTYPE``, placed for ``CUDA.MESH``."""
    from ovmr_tpu_torch.api import resolve_device
    from ovmr_tpu_torch.data import DataManager
    from ovmr_tpu_torch.data.manager import HostDataLoader
    from ovmr_tpu_torch.data.samplers import build_sampler
    from ovmr_tpu_torch.engine.trainer import (
        _DTYPES,
        load_or_init_clip,
        make_feature_extractor,
        setup_trainer_mesh,
    )
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.utils import set_random_seed

    cfg = setup_cfg(args)
    set_random_seed(max(cfg.SEED, 0))
    device = resolve_device(cfg.CUDA.DEVICE)

    dm = DataManager(cfg)
    loader = {"train": dm.train_loader_x, "val": dm.val_loader,
              "test": dm.test_loader}[args.split]
    if args.split == "train":  # the dump reads the train split in order
        loader = HostDataLoader(
            dm.dataset.train_x, build_sampler("SequentialSampler", dm.dataset.train_x, 0),
            dm.tfm_test, cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
            num_workers=cfg.DATALOADER.NUM_WORKERS)

    clip_params, clip_cfg = load_or_init_clip(cfg)
    dtype = _DTYPES[cfg.CUDA.DTYPE]
    clip_params = tclip.cast_params(tclip.tree_to(clip_params, device=device), dtype)
    mesh, _, clip_params, block_fn = setup_trainer_mesh(cfg, clip_params, clip_cfg=clip_cfg,
                                                        label="lpclip")
    encode = make_feature_extractor(
        clip_cfg, dtype, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD, loader.batch_size,
        device=device, u8_normalize="normalize" in cfg.INPUT.TRANSFORMS, tp_block_fn=block_fn,
        mesh=mesh, unit_norm=False)  # the reference dumps raw visual features
    return cfg, args.split, loader, encode, clip_params


def dump(cfg, split, loader, encode, clip_params) -> str:
    """Encode the split and write ``{OUTPUT_DIR}/{DATASET.NAME}/{split}.npz``
    (``feature_list``, ``label_list``); returns its path."""
    import torch

    from ovmr_tpu_torch.data.prefetch import prefetch_batches

    feats, labels = [], []
    with torch.inference_mode():
        for batch in prefetch_batches(loader):
            feats.append(encode(clip_params, batch["img"]))
            labels.extend(np.asarray(batch["label"]).tolist())

    save_dir = os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.NAME)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{split}.npz")
    np.savez(path, feature_list=np.concatenate(feats, 0), label_list=np.asarray(labels))
    print(f"saved {sum(f.shape[0] for f in feats)} features to {save_dir}/{split}.npz")
    return path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ovmr_tpu_torch.lpclip")
    parser.add_argument("--root", default="./data")
    parser.add_argument("--dataset-config-file", default="")
    parser.add_argument("--split", choices=["train", "val", "test"], default="train")
    parser.add_argument("--output-dir", default="./lpclip_feats")
    parser.add_argument("--backbone", default="ViT-B/16")
    parser.add_argument("--seed", type=int, default=1)
    # the reference shell script's arguments (lpclip/feat_extractor.sh)
    parser.add_argument("--config-file", default="")
    parser.add_argument("--eval-only", action="store_true")  # accepted, implied
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser
