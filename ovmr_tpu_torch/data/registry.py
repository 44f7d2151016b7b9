"""Dataset registry (reference ``dassl/data/datasets/build.py``); the
port's copy of ``ovmr_tpu/data/registry.py``."""

from __future__ import annotations

from ovmr_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(cfg):
    name = cfg.DATASET.NAME
    # importing the package registers all bundled loaders
    from ovmr_tpu_torch.data import datasets as _  # noqa: F401

    return DATASET_REGISTRY.get(name)(cfg)
