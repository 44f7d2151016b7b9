"""Classification heads (reference ``dassl/modeling/head/mlp.py``).

Counterpart of ``ovmr_tpu/modeling/heads.py``."""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ovmr_tpu_torch.utils.registry import Registry

from . import ops
from .backbones import init_weights
from .layers import TorchBatchNorm

HEAD_REGISTRY = Registry("HEAD")


@HEAD_REGISTRY.register()
class mlp(nn.Module):
    """Linear(+BN)(+act)(+dropout) stack; features out = the last hidden
    width. Layers are named ``fc{i}`` and ``bn{i}``, as the JAX head's."""

    def __init__(self, in_features: int = 2048, hidden_layers: Union[int, Sequence[int]] = (),
                 activation: str = "relu", bn: bool = True, dropout: float = 0.0):
        super().__init__()
        dims = (hidden_layers,) if isinstance(hidden_layers, int) else tuple(hidden_layers)
        assert len(dims) > 0
        if activation not in ("relu", "leaky_relu"):
            raise NotImplementedError(activation)
        self.activation, self.dropout, self.n = activation, dropout, len(dims)
        self.out_features = dims[-1]
        for i, dim in enumerate(dims):
            self.add_module(f"fc{i}", nn.Linear(in_features, dim))
            if bn:
                self.add_module(f"bn{i}", TorchBatchNorm(dim))
            in_features = dim
        self.bn = bn
        init_weights(self)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if self.bn:
                x = getattr(self, f"bn{i}")(x)
            x = torch.relu(x) if self.activation == "relu" else F.leaky_relu(x, 0.01)
            x = ops.dropout(x, self.dropout, self.training)
        return x


def build_head(name: str, verbose: bool = False, **kwargs) -> nn.Module:
    if verbose:
        print(f"Head: {name}")
    kwargs.pop("pretrained", None)
    return HEAD_REGISTRY.get(name)(**kwargs)
