from .config import CfgNode
from .defaults import extend_cfg, get_cfg_default
from .logger import setup_logger
from .meters import AverageMeter, MetricMeter
from .registry import Registry, check_availability
from .tools import (
    collect_env_info,
    listdir_nohidden,
    mkdir_if_missing,
    read_image,
    set_random_seed,
)

__all__ = [
    "CfgNode",
    "get_cfg_default",
    "extend_cfg",
    "setup_logger",
    "AverageMeter",
    "MetricMeter",
    "Registry",
    "check_availability",
    "collect_env_info",
    "listdir_nohidden",
    "mkdir_if_missing",
    "read_image",
    "set_random_seed",
]
