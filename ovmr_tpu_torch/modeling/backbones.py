"""CNN backbone zoo (reference ``dassl/modeling/backbone/``).

Counterpart of ``ovmr_tpu/modeling/backbones.py``: every name of its
``BACKBONE_REGISTRY``, as ``nn.Module``s over NCHW batches whose
``forward(x)`` gives ``[B, out_features]`` features; train and eval mode
are torch's (``module.train()``/``eval()``). Submodules carry the JAX
modules' names (``conv1``, ``layer1_0``, ``block1_0_bn1``...), so
:mod:`ovmr_tpu_torch.convert` carries a flax state across leaf by leaf.

Layout choices that keep the numbers the JAX package's:

- a convolution pads ``k // 2`` on both sides (``_conv``), as torch's
  ``padding=k//2``; EfficientNet's ``"SAME"`` convolutions pad as XLA does,
  the odd pixel at the bottom and right (:func:`_same_pad`);
- pooling is torch's (``-inf`` padding, floor sizes, the adaptive pool's
  bin edges ``floor(i*H/oh) .. ceil((i+1)*H/oh)``), which is what the JAX
  helpers reimplement;
- a feature map is flattened in NHWC order before a linear layer
  (PreActResNet, VGG16, AlexNet, the digit CNNs), so a linear weight is the
  JAX kernel transposed and nothing else.

Dropout, drop-connect and MixStyle/EFDMix draw from the generator of
:func:`ovmr_tpu_torch.modeling.ops.rng_scope`. ``pretrained=True`` prints
the JAX package's notice and keeps the random init: no ImageNet weights
ship with the repository.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ovmr_tpu_torch.utils.registry import Registry

from . import ops
from .layers import Conv2dDynamic, TorchBatchNorm

BACKBONE_REGISTRY = Registry("BACKBONE")


def init_weights(module: nn.Module) -> nn.Module:
    """The JAX zoo's initialisers: convolutions ``variance_scaling(2,
    fan_out, normal)``, linear layers LeCun normal with zero bias."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            nn.init.normal_(m.weight, std=1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def _conv(cin, cout, kernel, stride=1, bias=False, groups=1, padding=None):
    if padding is None:
        padding = kernel // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, groups=groups,
                     bias=bias)


def _bn(c, momentum=0.1, eps=1e-5):
    return TorchBatchNorm(c, momentum=momentum, eps=eps)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW map in the JAX package's NHWC order."""
    return x.permute(0, 2, 3, 1).flatten(1)


def _same_pad(x, kernel: int, stride: int):
    """XLA's ``"SAME"`` padding: output ``ceil(in / stride)``, the total pad
    split with the odd pixel after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _notice_pretrained(name: str, pretrained: bool):
    if pretrained:
        print(
            f"backbone '{name}': pretrained weights are asset-gated in this "
            "environment (zero egress); using random init"
        )


# ---------------------------------------------------------------------------
# ResNet family (reference backbone/resnet.py + resnet_dynamic.py)
# ---------------------------------------------------------------------------

class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dynamic: bool = False):
        super().__init__()
        if dynamic:
            self.conv1 = Conv2dDynamic(in_ch, planes, 3, stride, use_bias=False,
                                       attention_in_channels=in_ch)
            self.conv2 = Conv2dDynamic(planes, planes, 3, 1, use_bias=False,
                                       attention_in_channels=in_ch)
        else:
            self.conv1 = _conv(in_ch, planes, 3, stride)
            self.conv2 = _conv(planes, planes, 3, 1)
        self.dynamic = dynamic
        self.bn1, self.bn2 = _bn(planes), _bn(planes)
        if stride != 1 or in_ch != planes:
            self.downsample = _conv(in_ch, planes, 1, stride)
            self.downsample_bn = _bn(planes)
        else:
            self.downsample = None

    def forward(self, x):
        extra = {"attention_x": x} if self.dynamic else {}
        out = torch.relu(self.bn1(self.conv1(x, **extra)))
        out = self.bn2(self.conv2(out, **extra))
        residual = x if self.downsample is None else self.downsample_bn(self.downsample(x))
        return torch.relu(out + residual)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dynamic: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(in_ch, planes, 1)
        # torchvision-style (v1.5): the stride on the 3x3
        self.conv2 = (Conv2dDynamic(planes, planes, 3, stride, use_bias=False,
                                    attention_in_channels=in_ch)
                      if dynamic else _conv(planes, planes, 3, stride))
        self.conv3 = _conv(planes, out_ch, 1)
        self.dynamic = dynamic
        self.bn1, self.bn2, self.bn3 = _bn(planes), _bn(planes), _bn(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.downsample = _conv(in_ch, out_ch, 1, stride)
            self.downsample_bn = _bn(out_ch)
        else:
            self.downsample = None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        extra = {"attention_x": x} if self.dynamic else {}
        out = torch.relu(self.bn2(self.conv2(out, **extra)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample_bn(self.downsample(x))
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """ImageNet-style ResNet trunk -> global-average-pooled features.
    ``ms_class`` in {'mixstyle', 'efdmix', None} mixes feature statistics
    after the layer groups named in ``ms_layers`` (train mode only);
    ``dynamic`` swaps the 3x3 convolutions for :class:`Conv2dDynamic`."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
                 ms_class: Optional[str] = None, ms_layers: Sequence[str] = (),
                 ms_p: float = 0.5, ms_a: float = 0.1, dynamic: bool = False):
        super().__init__()
        block = _Bottleneck if bottleneck else _BasicBlock
        self.out_features = 512 * block.expansion
        self.ms_class, self.ms_layers = ms_class, tuple(ms_layers)
        self.ms_p, self.ms_a = ms_p, ms_a
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        self.block_names = []
        in_ch = 64
        for gi, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            names = []
            for bi in range(n_blocks):
                stride = (1 if gi == 0 else 2) if bi == 0 else 1
                self.add_module(f"layer{gi + 1}_{bi}", block(in_ch, planes, stride, dynamic))
                in_ch = planes * block.expansion
                names.append(f"layer{gi + 1}_{bi}")
            self.block_names.append(names)
        init_weights(self)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for gi, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if self.ms_class is not None and f"layer{gi + 1}" in self.ms_layers:
                fn = ops.mixstyle if self.ms_class == "mixstyle" else ops.efdmix
                x = fn(x, ops.current_generator(), p=self.ms_p, alpha=self.ms_a,
                       train=self.training)
        return x.mean(dim=(2, 3))


class PreActResNet18(nn.Module):
    """CIFAR-style pre-activation ResNet-18 (reference
    ``backbone/preact_resnet18.py``; 32x32 inputs, avg_pool2d(4))."""

    out_features = 512

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 3)
        self.blocks = []
        in_ch = 64
        for gi, planes in enumerate((64, 128, 256, 512)):
            for bi in range(2):
                stride = (1 if gi == 0 else 2) if bi == 0 else 1
                name = f"layer{gi + 1}_{bi}"
                self.add_module(f"{name}_bn1", _bn(in_ch))
                if stride != 1 or in_ch != planes:
                    self.add_module(f"{name}_shortcut", _conv(in_ch, planes, 1, stride))
                self.add_module(f"{name}_conv1", _conv(in_ch, planes, 3, stride))
                self.add_module(f"{name}_bn2", _bn(planes))
                self.add_module(f"{name}_conv2", _conv(planes, planes, 3, 1))
                self.blocks.append(name)
                in_ch = planes
        init_weights(self)

    def forward(self, x):
        x = self.conv1(x)
        for name in self.blocks:
            out = torch.relu(getattr(self, f"{name}_bn1")(x))
            shortcut = getattr(self, f"{name}_shortcut", None)
            shortcut = x if shortcut is None else shortcut(out)
            h = getattr(self, f"{name}_conv1")(out)
            h = getattr(self, f"{name}_conv2")(torch.relu(getattr(self, f"{name}_bn2")(h)))
            x = h + shortcut
        x = F.avg_pool2d(x, 4)
        return flatten_nhwc(x)


class WideResNet(nn.Module):
    """WRN-d-k with LeakyReLU(0.01) (reference ``backbone/wide_resnet.py``,
    the xternalz variant Dassl modified for SSL)."""

    def __init__(self, depth: int = 28, widen_factor: int = 2, drop_rate: float = 0.0):
        super().__init__()
        assert (depth - 4) % 6 == 0
        n = (depth - 4) // 6
        self.out_features = 64 * widen_factor
        self.drop_rate = drop_rate
        self.conv1 = _conv(3, 16, 3)
        self.blocks = []
        in_ch = 16
        for gi, w in enumerate((16 * widen_factor, 32 * widen_factor, 64 * widen_factor)):
            for bi in range(n):
                stride = (1 if gi == 0 else 2) if bi == 0 else 1
                name = f"block{gi + 1}_{bi}"
                self.add_module(f"{name}_bn1", _bn(in_ch))
                self.add_module(f"{name}_conv1", _conv(in_ch, w, 3, stride))
                self.add_module(f"{name}_bn2", _bn(w))
                self.add_module(f"{name}_conv2", _conv(w, w, 3, 1))
                if in_ch != w:
                    self.add_module(f"{name}_shortcut", _conv(in_ch, w, 1, stride, padding=0))
                self.blocks.append(name)
                in_ch = w
        self.bn1 = _bn(in_ch)
        init_weights(self)

    def forward(self, x):
        act = lambda v: F.leaky_relu(v, 0.01)  # noqa: E731
        x = self.conv1(x)
        for name in self.blocks:
            out = act(getattr(self, f"{name}_bn1")(x))
            shortcut = getattr(self, f"{name}_shortcut", None)
            # conv1 takes the activated input in both branches; only the
            # equal-width shortcut sees the raw one (reference BasicBlock)
            h = getattr(self, f"{name}_conv1")(out)
            h = act(getattr(self, f"{name}_bn2")(h))
            h = ops.dropout(h, self.drop_rate, self.training)
            h = getattr(self, f"{name}_conv2")(h)
            x = (x if shortcut is None else shortcut(out)) + h
        x = act(self.bn1(x))
        return x.mean(dim=(2, 3))


class VGG16(nn.Module):
    """VGG-16 trunk + the two 4096-d FC layers as features (the reference
    drops only the logits layer)."""

    out_features = 4096
    CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M")

    def __init__(self):
        super().__init__()
        in_ch, i = 3, 0
        for v in self.CFG:
            if v != "M":
                self.add_module(f"conv{i}", _conv(in_ch, v, 3, bias=True))
                in_ch, i = v, i + 1
        self.fc1 = nn.Linear(512 * 7 * 7, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        init_weights(self)

    def forward(self, x):
        i = 0
        for v in self.CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = torch.relu(getattr(self, f"conv{i}")(x))
                i += 1
        x = flatten_nhwc(F.adaptive_avg_pool2d(x, (7, 7)))
        x = ops.dropout(torch.relu(self.fc1(x)), 0.5, self.training)
        return ops.dropout(torch.relu(self.fc2(x)), 0.5, self.training)


class AlexNet(nn.Module):
    """AlexNet trunk + 4096-d FC features (reference
    ``backbone/alexnet.py``; torchvision one-weird-trick layout)."""

    out_features = 4096

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 11, 4, bias=True, padding=2)
        self.conv2 = _conv(64, 192, 5, bias=True)
        self.conv3 = _conv(192, 384, 3, bias=True)
        self.conv4 = _conv(384, 256, 3, bias=True)
        self.conv5 = _conv(256, 256, 3, bias=True)
        self.fc1 = nn.Linear(256 * 6 * 6, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        init_weights(self)

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.conv1(x)), 3, 2)
        x = F.max_pool2d(torch.relu(self.conv2(x)), 3, 2)
        x = torch.relu(self.conv3(x))
        x = torch.relu(self.conv4(x))
        x = F.max_pool2d(torch.relu(self.conv5(x)), 3, 2)
        x = flatten_nhwc(F.adaptive_avg_pool2d(x, (6, 6)))
        x = ops.dropout(x, 0.5, self.training)
        x = ops.dropout(torch.relu(self.fc1(x)), 0.5, self.training)
        return torch.relu(self.fc2(x))


# ---------------------------------------------------------------------------
# 32x32 digit CNNs
# ---------------------------------------------------------------------------

def _check_32(x):
    assert x.shape[2] == 32 and x.shape[3] == 32, (
        f"Input to network must be 32x32, got {x.shape[2]}x{x.shape[3]}"
    )


class CNNDigit5M3SDA(nn.Module):
    """The Digit-5 feature extractor of M3SDA (reference
    ``backbone/cnn_digit5_m3sda.py``; 32x32 inputs)."""

    out_features = 2048

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 5, bias=True), _bn(64)
        self.conv2, self.bn2 = _conv(64, 64, 5, bias=True), _bn(64)
        self.conv3, self.bn3 = _conv(64, 128, 5, bias=True), _bn(128)
        self.fc1, self.bn1_fc = nn.Linear(8 * 8 * 128, 3072), _bn(3072)
        self.fc2, self.bn2_fc = nn.Linear(3072, 2048), _bn(2048)
        init_weights(self)

    def forward(self, x):
        _check_32(x)
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        x = F.max_pool2d(torch.relu(self.bn2(self.conv2(x))), 3, 2, padding=1)
        x = flatten_nhwc(torch.relu(self.bn3(self.conv3(x))))
        x = ops.dropout(torch.relu(self.bn1_fc(self.fc1(x))), 0.5, self.training)
        return torch.relu(self.bn2_fc(self.fc2(x)))


class CNNDigitsDG(nn.Module):
    """4x [conv-relu-maxpool] ConvNet of DDAIG (reference
    ``backbone/cnn_digitsdg.py``; 32x32 inputs -> 2*2*64 features)."""

    def __init__(self, c_hidden: int = 64):
        super().__init__()
        self.out_features = 4 * c_hidden
        in_ch = 3
        for i in range(4):
            self.add_module(f"conv{i + 1}", _conv(in_ch, c_hidden, 3, bias=True))
            in_ch = c_hidden
        init_weights(self)

    def forward(self, x):
        _check_32(x)
        for i in range(4):
            x = F.max_pool2d(torch.relu(getattr(self, f"conv{i + 1}")(x)), 2, 2)
        return flatten_nhwc(x)


class CNNDigitSingle(nn.Module):
    """Single-domain-generalization digit CNN (reference
    ``backbone/cnn_digitsingle.py``; valid-padded 5x5 convolutions)."""

    out_features = 1024

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 5, bias=True, padding=0)
        self.conv2 = _conv(64, 128, 5, bias=True, padding=0)
        self.fc3 = nn.Linear(5 * 5 * 128, 1024)
        self.fc4 = nn.Linear(1024, 1024)
        init_weights(self)

    def forward(self, x):
        _check_32(x)
        x = F.max_pool2d(torch.relu(self.conv1(x)), 2, 2)
        x = flatten_nhwc(F.max_pool2d(torch.relu(self.conv2(x)), 2, 2))
        return torch.relu(self.fc4(torch.relu(self.fc3(x))))


# ---------------------------------------------------------------------------
# EfficientNet b0-b7 (reference backbone/efficientnet/)
# ---------------------------------------------------------------------------

# (width_mult, depth_mult, resolution, dropout_rate)
_EFFICIENTNET_PARAMS = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

# (kernel, repeats, in, out, expand, stride); se_ratio fixed at 0.25
_MBCONV_ARGS = (
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
)


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _ebn(c):
    # the JAX zoo's momentum 0.99 on the running statistic, eps 1e-3
    return _bn(c, momentum=0.01, eps=1e-3)


class _MBConv(nn.Module):
    def __init__(self, kernel, in_ch, out_ch, expand, stride, drop_connect):
        super().__init__()
        self.kernel, self.stride, self.drop_connect = kernel, stride, drop_connect
        self.residual = stride == 1 and in_ch == out_ch
        oup = in_ch * expand
        if expand != 1:
            self.expand_conv, self.bn0 = _conv(in_ch, oup, 1), _ebn(oup)
        else:
            self.expand_conv = None
        self.depthwise_conv = _conv(oup, oup, kernel, stride, groups=oup, padding=0)
        self.bn1 = _ebn(oup)
        se_ch = max(1, int(in_ch * 0.25))
        self.se_reduce = nn.Conv2d(oup, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, oup, 1)
        self.project_conv, self.bn2 = _conv(oup, out_ch, 1), _ebn(out_ch)

    def forward(self, x):
        inputs = x
        if self.expand_conv is not None:
            x = F.silu(self.bn0(self.expand_conv(x)))
        x = self.depthwise_conv(_same_pad(x, self.kernel, self.stride))
        x = F.silu(self.bn1(x))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.se_expand(F.silu(self.se_reduce(s)))
        x = torch.sigmoid(s) * x
        x = self.bn2(self.project_conv(x))
        if self.residual:
            if self.drop_connect and self.training:
                keep = 1.0 - self.drop_connect
                gen = ops.current_generator()
                gdev = gen.device if gen is not None else x.device
                u = ops.rand_rows((x.shape[0], 1, 1, 1), gen, gdev).to(x.device)
                x = x / keep * torch.floor(keep + u).to(x.dtype)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """EfficientNet trunk -> pooled + dropout features (the reference keeps
    the 1280-d conv head and removes the logits layer)."""

    def __init__(self, variant: str = "b0"):
        super().__init__()
        w_mult, d_mult, _, self.dropout_rate = _EFFICIENTNET_PARAMS[variant]
        self.out_features = _round_filters(1280, w_mult)
        stem = _round_filters(32, w_mult)
        self.conv_stem, self.bn0 = _conv(3, stem, 3, 2, padding=0), _ebn(stem)
        blocks = []
        for kernel, repeats, in_ch, out_ch, expand, stride in _MBCONV_ARGS:
            in_ch, out_ch = _round_filters(in_ch, w_mult), _round_filters(out_ch, w_mult)
            for r in range(_round_repeats(repeats, d_mult)):
                blocks.append((kernel, in_ch if r == 0 else out_ch, out_ch, expand,
                               stride if r == 0 else 1))
        self.n_blocks = len(blocks)
        for i, (kernel, in_ch, out_ch, expand, stride) in enumerate(blocks):
            # linear drop-connect ramp over depth (reference model.py:248-252)
            self.add_module(f"block{i}", _MBConv(kernel, in_ch, out_ch, expand, stride,
                                                 0.2 * i / len(blocks)))
        self.conv_head = _conv(blocks[-1][2], self.out_features, 1)
        self.bn1 = _ebn(self.out_features)
        init_weights(self)

    def forward(self, x):
        x = F.silu(self.bn0(self.conv_stem(_same_pad(x, 3, 2))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.bn1(self.conv_head(x)))
        return ops.dropout(x.mean(dim=(2, 3)), self.dropout_rate, self.training)


# ---------------------------------------------------------------------------
# registrations (names match the reference BACKBONE_REGISTRY)
# ---------------------------------------------------------------------------

def _register(name: str, factory: Callable[..., nn.Module]):
    def build(pretrained: bool = True, verbose: bool = False, **kwargs):
        _notice_pretrained(name, pretrained)
        return factory(**kwargs)

    build.__name__ = name
    BACKBONE_REGISTRY.register(build)
    return build


_RESNET_LAYERS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}

for _name, (_layers, _bneck) in _RESNET_LAYERS.items():
    _register(_name, lambda layers=_layers, bneck=_bneck, **kw: ResNet(
        layers=layers, bottleneck=bneck, **kw))

_MS_SETS = {"l123": ("layer1", "layer2", "layer3"),
            "l12": ("layer1", "layer2"),
            "l1": ("layer1",)}

for _depth in ("18", "50", "101"):
    _layers, _bneck = _RESNET_LAYERS[f"resnet{_depth}"]
    for _suffix, _ms_layers in _MS_SETS.items():
        for _kind, _tag in (("mixstyle", "ms"), ("efdmix", "efdmix")):
            _register(
                f"resnet{_depth}_{_tag}_{_suffix}",
                lambda layers=_layers, bneck=_bneck, kind=_kind, ms_layers=_ms_layers, **kw:
                ResNet(layers=layers, bottleneck=bneck, ms_class=kind, ms_layers=ms_layers,
                       **kw),
            )
    _register(f"resnet{_depth}_dynamic", lambda layers=_layers, bneck=_bneck, **kw: ResNet(
        layers=layers, bottleneck=bneck, dynamic=True, **kw))
    for _suffix, _ms_layers in _MS_SETS.items():
        _register(
            f"resnet{_depth}_dynamic_ms_{_suffix}",
            lambda layers=_layers, bneck=_bneck, ms_layers=_ms_layers, **kw: ResNet(
                layers=layers, bottleneck=bneck, dynamic=True, ms_class="mixstyle",
                ms_layers=ms_layers, **kw),
        )

_register("preact_resnet18", lambda **kw: PreActResNet18(**kw))
_register("wide_resnet_28_2", lambda **kw: WideResNet(28, 2, **kw))
_register("wide_resnet_16_4", lambda **kw: WideResNet(16, 4, **kw))
_register("vgg16", lambda **kw: VGG16(**kw))
_register("alexnet", lambda **kw: AlexNet(**kw))
_register("cnn_digit5_m3sda", lambda **kw: CNNDigit5M3SDA(**kw))
_register("cnn_digitsdg", lambda **kw: CNNDigitsDG(**kw))
_register("cnn_digitsingle", lambda **kw: CNNDigitSingle(**kw))
for _v in _EFFICIENTNET_PARAMS:
    _register(f"efficientnet_{_v}", lambda v=_v, **kw: EfficientNet(variant=v, **kw))


def build_backbone(name: str, verbose: bool = False, pretrained: bool = True,
                   **kwargs) -> nn.Module:
    """Instantiate a registered backbone (reference
    ``dassl/modeling/backbone/build.py``)."""
    if verbose:
        print(f"Backbone: {name}")
    return BACKBONE_REGISTRY.get(name)(pretrained=pretrained, **kwargs)
