"""Perturbation-generator networks for DDAIG (reference
``dassl/modeling/network/ddaig_fcn.py``, a CycleGAN-style FCN).

Counterpart of ``ovmr_tpu/modeling/networks.py``, NCHW. The ``fcn_*_gctx``
variants fuse a global-context vector; the ``*_stn`` variants put a spatial
transformer first, its localisation head initialised to the
(tanh-squashed) identity, as the reference's ``init_loc_layer``. The
generator returns ``x + lmda * p`` with ``p`` in [-1, 1] (tanh).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ovmr_tpu_torch.utils.registry import Registry

from .backbones import flatten_nhwc
from .layers import TorchBatchNorm

NETWORK_REGISTRY = Registry("NETWORK")


def _gauss02(module: nn.Module) -> nn.Module:
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.normal_(m.weight, std=0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def _instance_norm(x):
    """InstanceNorm2d(affine=False): per-sample, per-channel spatial norm."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-5)


def affine_grid_sample(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NCHW ``x`` on the affine grid ``theta`` [B,2,3]:
    torch's ``affine_grid`` + ``grid_sample`` (align_corners=False, zero
    padding), what the JAX function reimplements."""
    grid = F.affine_grid(theta.to(x.dtype), list(x.shape), align_corners=False)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


class _ResnetBlock(nn.Module):
    def __init__(self, dim: int, use_batch_norm: bool = False, padding_type: str = "reflect"):
        super().__init__()
        self.use_batch_norm, self.padding_type = use_batch_norm, padding_type
        pad = 0 if padding_type == "reflect" else 1
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=pad, bias=False)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=pad, bias=False)
        if use_batch_norm:
            self.norm1, self.norm2 = TorchBatchNorm(dim), TorchBatchNorm(dim)

    def _conv(self, conv, v):
        if self.padding_type == "reflect":
            v = F.pad(v, (1, 1, 1, 1), mode="reflect")
        return conv(v)

    def _norm(self, name, v):
        return getattr(self, name)(v) if self.use_batch_norm else _instance_norm(v)

    def forward(self, x):
        h = torch.relu(self._norm("norm1", self._conv(self.conv1, x)))
        return x + self._norm("norm2", self._conv(self.conv2, h))


class LocNet(nn.Module):
    """Localisation network of the STN variants (reference
    ``ddaig_fcn.py::LocNet``; zero-padded convolutions + BN blocks)."""

    def __init__(self, nc: int = 32, n_blocks: int = 3, image_size: int = 32):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv0 = nn.Conv2d(3, nc, 3, stride=2, padding=1, bias=False)
        self.bn0 = TorchBatchNorm(nc)
        side = (image_size - 1) // 2 + 1
        for i in range(n_blocks):
            self.add_module(f"block{i}", _ResnetBlock(nc, use_batch_norm=True,
                                                      padding_type="zero"))
            side //= 2
        self.fc_loc = nn.Linear(nc * side * side, 4)
        _gauss02(self)
        # identity init (the reference's init_loc_layer): zero weights,
        # bias [1, 0, 0, 1], then tanh
        nn.init.zeros_(self.fc_loc.weight)
        with torch.no_grad():
            self.fc_loc.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]))

    def forward(self, x):
        b = x.shape[0]
        x = torch.relu(self.bn0(self.conv0(x)))
        for i in range(self.n_blocks):
            x = F.max_pool2d(getattr(self, f"block{i}")(x), 2, 2)
        x = torch.tanh(self.fc_loc(flatten_nhwc(x))).reshape(b, 2, 2)
        return torch.cat([x, x.new_zeros(b, 2, 1)], dim=-1)


class FCN(nn.Module):
    """Fully convolutional perturbation generator (reference
    ``ddaig_fcn.py::FCN``): reflect-conv trunk, optional global-context
    fusion, tanh regression head; the output is ``input + lmda * p``."""

    def __init__(self, nc: int = 32, n_blocks: int = 3, gctx: bool = True, stn: bool = False,
                 image_size: int = 32):
        super().__init__()
        self.n_blocks, self.gctx, self.stn = n_blocks, gctx, stn
        if stn:
            self.locnet = LocNet(nc, n_blocks, image_size)
        self.conv0 = nn.Conv2d(3, nc, 3, bias=False)
        for i in range(n_blocks):
            self.add_module(f"block{i}", _ResnetBlock(nc))
        if gctx:
            self.gctx_fusion = nn.Conv2d(2 * nc, nc, 1, bias=False)
        self.regress = nn.Conv2d(nc, 3, 1, bias=True)
        for name, child in self.named_children():
            if name != "locnet":
                _gauss02(child)

    def forward(self, x, lmda: float = 1.0, return_p: bool = False,
                return_stn_output: bool = False):
        if self.stn:
            x = affine_grid_sample(x, self.locnet(x))
        inp = x
        h = torch.relu(_instance_norm(self.conv0(F.pad(x, (1, 1, 1, 1), mode="reflect"))))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h)
        if self.gctx:
            c = h.mean(dim=(2, 3), keepdim=True).expand_as(h)
            h = torch.relu(_instance_norm(self.gctx_fusion(torch.cat([h, c], dim=1))))
        p = torch.tanh(self.regress(h))
        x_p = inp + lmda * p
        if return_stn_output:
            return x_p, p, inp
        if return_p:
            return x_p, p
        return x_p


@NETWORK_REGISTRY.register()
def fcn_3x32_gctx(**kwargs):
    return FCN(nc=32, n_blocks=3)


@NETWORK_REGISTRY.register()
def fcn_3x64_gctx(**kwargs):
    return FCN(nc=64, n_blocks=3)


@NETWORK_REGISTRY.register()
def fcn_3x32_gctx_stn(image_size=32, **kwargs):
    return FCN(nc=32, n_blocks=3, stn=True, image_size=image_size)


@NETWORK_REGISTRY.register()
def fcn_3x64_gctx_stn(image_size=224, **kwargs):
    return FCN(nc=64, n_blocks=3, stn=True, image_size=image_size)


def build_network(name: str, verbose: bool = False, **kwargs) -> nn.Module:
    if verbose:
        print(f"Network: {name}")
    return NETWORK_REGISTRY.get(name)(**kwargs)
