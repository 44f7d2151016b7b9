"""Running-statistic meters for training logs.

The port's copy of ``ovmr_tpu/utils/meters.py``.

Same contract as the reference meters (``dassl/utils/meters.py``): an
:class:`AverageMeter` tracks val/avg (optionally exponential-moving), a
:class:`MetricMeter` formats a dict of them for the per-iteration log line.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping, Union

Number = Union[int, float]


class AverageMeter:
    def __init__(self, ema: bool = False):
        self.ema = ema
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: Number, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        if self.ema:
            self.avg = self.avg * 0.9 + self.val * 0.1
        else:
            self.avg = self.sum / self.count


class MetricMeter:
    def __init__(self, delimiter: str = " "):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, input_dict: Mapping[str, Number]) -> None:
        if input_dict is None:
            return
        for k, v in input_dict.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        out = []
        for name, meter in self.meters.items():
            out.append(f"{name} {meter.val:.4f} ({meter.avg:.4f})")
        return self.delimiter.join(out)
