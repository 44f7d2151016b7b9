"""The host data layer of the port: the JAX package's ``ovmr_tpu/data`` for
the MM_CLS_OP path. Importing it loads neither PIL nor yaml."""

from .datum import (
    DatasetBase,
    Datum,
    generate_fewshot_dataset,
    load_fewshot_pickle,
    read_split,
    save_fewshot_pickle,
    save_split,
    subsample_classes,
)
from .manager import DataManager, HostDataLoader
from .registry import DATASET_REGISTRY, build_dataset
from .samplers import build_sampler
from .transforms import build_transform

__all__ = [
    "DatasetBase",
    "Datum",
    "generate_fewshot_dataset",
    "load_fewshot_pickle",
    "read_split",
    "save_fewshot_pickle",
    "save_split",
    "subsample_classes",
    "DataManager",
    "HostDataLoader",
    "DATASET_REGISTRY",
    "build_dataset",
    "build_sampler",
    "build_transform",
]
