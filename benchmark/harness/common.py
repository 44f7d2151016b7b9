"""What the drivers share: the cell being run, its window's record, the
weights, the name list."""

from __future__ import annotations

import dataclasses
import statistics
from pathlib import Path

import torch

from benchmark import work
from benchmark.harness import weights as weights_mod

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

CLIP_KEYS = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
             "vision_patch_size", "context_length", "vocab_size", "transformer_width",
             "transformer_heads", "transformer_layers")


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device


class Window:
    """What the measured window did: its length, the requests or steps it
    attempted, their latencies, counts, and the work they needed."""

    def __init__(self):
        self.seconds = 0.0
        self.attempted = 0
        self.failed = 0
        self.latencies = []
        self.counts = {}
        self.work = work.Work()

    def count(self, key, n):
        self.counts[key] = self.counts.get(key, 0) + n

    def latency_ms(self, q: float) -> float:
        """The ``q`` quantile (a multiple of 0.001) of the latencies, in ms."""
        if len(self.latencies) == 1:
            return 1e3 * self.latencies[0]
        cut = round(q * 1000)
        return 1e3 * statistics.quantiles(self.latencies, n=1000, method="inclusive")[cut - 1]


def clip_config(cfg: dict):
    from ovmr_tpu_torch.models.clip import CLIPConfig

    return CLIPConfig(**{k: cfg[k] for k in CLIP_KEYS})


def make_weights(cfg: dict, generator: torch.Generator, device) -> dict:
    return {
        "clip": weights_mod.make_clip(cfg, generator, DTYPES[cfg["dtype"]], device),
        "agg": weights_mod.make_generator(cfg, generator, device),
    }


def reference_weights(w: dict) -> dict:
    """The reference's float32 copy: the towers' dicts, ``agg`` and the
    logit scale's value."""
    clip = weights_mod.to_float(w["clip"])
    return {"visual": clip["visual"], "text": clip["text"],
            "agg": weights_mod.to_float(w["agg"]),
            "logit_scale": float(clip["logit_scale"].exp())}


def lvis_names(root: Path) -> list:
    return (Path(root) / "benchmark" / "data" / "lvis_v1_names.txt").read_text().split("\n")[:-1]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
