"""Modeling zoo (reference vendored ``dassl/modeling/``): CNN backbones,
heads, DDAIG's generator networks and the functional op library.

Counterpart of ``ovmr_tpu/modeling``: ``nn.Module``s over NCHW batches,
registered under the JAX package's names and driven by the Dassl trainers
of :mod:`ovmr_tpu_torch.engine.dg`. None of it reaches a hand-written
kernel: the convolutions, BatchNorm and pooling are cuDNN's, as XLA
computes them outside any Pallas kernel in the JAX package.
"""

from .backbones import BACKBONE_REGISTRY, build_backbone
from .heads import HEAD_REGISTRY, build_head
from .networks import NETWORK_REGISTRY, build_network

__all__ = [
    "BACKBONE_REGISTRY",
    "build_backbone",
    "HEAD_REGISTRY",
    "build_head",
    "NETWORK_REGISTRY",
    "build_network",
]
