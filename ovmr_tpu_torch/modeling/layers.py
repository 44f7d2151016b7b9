"""Shared layers of the modeling zoo (reference
``dassl/modeling/ops/{attention,conv,dsbn,transnorm}.py``).

Counterpart of ``ovmr_tpu/modeling/layers.py``. Feature maps are NCHW.
Submodule and parameter names follow the JAX modules' (``attention``,
``conv_nn``, ``bn_0``, ``Dense_0``...), so :mod:`ovmr_tpu_torch.convert`
maps one state onto the other leaf by leaf.

:class:`TorchBatchNorm` is ``nn.BatchNorm2d/1d``'s arithmetic (the JAX
class's name says it copies torch: the running variance from the unbiased
batch variance, momentum 0.1 on the batch statistic, which is flax's 0.9
on the running one). Inside :func:`data_axis_scope` its batch statistics
are those of the global batch: on local data shards the sum and the
centred sum of squares of each shard's block of rows are added in shard
order; under a process group each rank's count, mean and centred sum of
squares are all-gathered and combined; Bessel's correction is taken over
the global count (the GSPMD program of the JAX package computes the same
global statistics). Its gradient flows through those reductions.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops

_DATA_AXIS: contextvars.ContextVar = contextvars.ContextVar("dassl_data_axis", default=None)


@contextlib.contextmanager
def data_axis_scope(axis):
    """Within the block, train-mode BatchNorm reduces its statistics over
    ``axis`` (a :class:`ovmr_tpu_torch.parallel.mesh.DataAxis`): the rows it
    is given are this process's, one equal block a local shard; under a
    process group the ranks' row counts may differ (none included)."""
    token = _DATA_AXIS.set(axis)
    try:
        yield axis
    finally:
        _DATA_AXIS.reset(token)


def current_data_axis():
    return _DATA_AXIS.get()


def shard_sum(parts) -> torch.Tensor:
    """The sum of one partial a local data shard, added in shard order."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


class TorchBatchNorm(nn.Module):
    """BatchNorm over dim 1 of a ``[B, C]`` or ``[B, C, H, W]`` input with
    torch's semantics: train mode normalises with the biased batch variance
    and updates the running variance with the unbiased one; eval mode
    normalises with the running statistics. ``momentum`` is torch's (the
    weight of the batch statistic): the JAX package's 0.9 and 0.99 are 0.1
    and 0.01 here."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        axis = current_data_axis()
        if axis is None:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                True, self.momentum, self.eps)
        return self._global_batch_norm(x, axis)

    def _global_batch_norm(self, x, axis):
        dims = (0,) if x.ndim == 2 else (0, 2, 3)
        shape = (1, -1) if x.ndim == 2 else (1, -1, 1, 1)
        if axis.group is not None:
            mean, var, n = self._rank_statistics(x, axis, dims, shape)
            centred = [x - mean.reshape(shape)]
            bessel = (n.double() / (n.double() - 1).clamp_min(1)).to(mean.dtype)
        else:
            blocks = axis.split(x)
            n = x.numel() // x.shape[1]
            mean = shard_sum([b.sum(dims) for b in blocks]) / n
            centred = [b - mean.reshape(shape) for b in blocks]
            var = shard_sum([(c * c).sum(dims) for c in centred]) / n
            bessel = n / max(n - 1, 1)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(m * var.detach() * bessel)
        inv = torch.rsqrt(var + self.eps)
        y = torch.cat(centred) * inv.reshape(shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)

    @staticmethod
    def _rank_statistics(x, axis, dims, shape):
        """The whole batch's mean, biased variance and count from every
        rank's rows, in one collective each way: each rank's
        :func:`_local_moments`, all-gathered (its backward all-reduces the
        cotangent) and combined in rank order (:func:`_combined_moments`),
        so every rank computes the same statistics. The ranks may hold
        unequal rows (a domain group's, or none)."""
        per_row = math.prod(x.shape[2:])
        stats = axis.gather([_local_moments(x, dims, shape)[None]])  # [ranks, 2C + 1]
        mean, m2, n = _combined_moments(stats, per_row)
        return mean, m2 / n, n


def _local_moments(x, dims, shape) -> torch.Tensor:
    """``[mean (C), centred sum of squares (C), rows (1)]`` of this rank's
    rows of ``x`` (zeros for none)."""
    per_row = math.prod(x.shape[2:])
    local_mean = x.sum(dims) / max(x.shape[0] * per_row, 1)
    local_m2 = ((x - local_mean.reshape(shape)) ** 2).sum(dims)
    # the rows, not the elements, travel: a row count stays exact in fp32
    return torch.cat([local_mean, local_m2, local_mean.new_full((1,), x.shape[0])])


def _combined_moments(stats, per_row: int):
    """The mean, centred sum of squares and element count of all the rows
    from every rank's :func:`_local_moments` (``[ranks, 2C + 1]``),
    combined in rank order (Chan et al.'s pairwise update)."""
    c = (stats.shape[1] - 1) // 2
    counts = stats[:, -1:] * per_row
    n = counts.sum()
    mean = (counts * stats[:, :c]).sum(0) / n
    m2 = stats[:, c:2 * c].sum(0) + (counts * (stats[:, :c] - mean) ** 2).sum(0)
    return mean, m2, n


class Attention(nn.Module):
    """Squeeze-excitation-style kernel attention of Dynamic Domain
    Generalization (reference ops/attention.py): GAP -> fc -> relu -> fc ->
    softmax over ``out_features`` template weights."""

    def __init__(self, in_channels: int, out_features: int, squeeze: Optional[int] = None,
                 use_bias: bool = True):
        super().__init__()
        squeeze = squeeze if squeeze else in_channels // 16
        assert squeeze > 0
        self.Dense_0 = nn.Linear(in_channels, squeeze, bias=use_bias)
        self.Dense_1 = nn.Linear(squeeze, out_features, bias=use_bias)

    def forward(self, x):
        v = x.mean(dim=(2, 3))
        return torch.softmax(self.Dense_1(torch.relu(self.Dense_0(v))), dim=-1)


class Conv2dDynamic(nn.Module):
    """Dynamic convolution (reference ops/conv.py): a base KxK conv plus four
    kernel templates (grouped KxK, 1x1, Kx1, 1xK) blended by per-sample
    attention weights."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 use_bias: bool = True, squeeze: Optional[int] = None,
                 attention_in_channels: Optional[int] = None):
        super().__init__()
        k = kernel_size
        if k % 2 == 0:
            raise ValueError("kernel_size must be odd")
        pad = k // 2
        self.attention = Attention(attention_in_channels or in_channels, 4, squeeze, use_bias)

        def conv(ksz, padding, groups=1):
            return nn.Conv2d(in_channels, out_channels, ksz, stride=stride, padding=padding,
                             groups=groups, bias=use_bias)

        self.conv = conv((k, k), (pad, pad))
        self.conv_nn = conv((k, k), (pad, pad), groups=min(in_channels, out_channels))
        self.conv_11 = conv((1, 1), (0, 0))
        self.conv_n1 = conv((k, 1), (pad, 0))
        self.conv_1n = conv((1, k), (0, pad))

    def forward(self, x, attention_x=None):
        y = self.attention(x if attention_x is None else attention_x)
        out = self.conv(x)
        for i, template in enumerate((self.conv_nn, self.conv_11, self.conv_n1, self.conv_1n)):
            out = out + template(x) * y[:, i].reshape(-1, 1, 1, 1)
        return out


class DSBN(nn.Module):
    """Domain-specific batch normalization (reference ops/dsbn.py): one
    BatchNorm a domain, ``domain_idx`` selecting it."""

    def __init__(self, num_features: int, n_domain: int):
        super().__init__()
        self.n_domain = n_domain
        for i in range(n_domain):
            self.add_module(f"bn_{i}", TorchBatchNorm(num_features))

    def forward(self, x, domain_idx: int = 0):
        assert 0 <= domain_idx < self.n_domain
        return getattr(self, f"bn_{domain_idx}")(x)


class TransNorm(nn.Module):
    """Transferable normalization (reference ops/transnorm.py; Wang et al.
    NeurIPS'19). A training batch stacks [source; target] halves; each half
    normalises with its own statistics and the channel attention
    ``1 + alpha`` (detached) rescales the output. The running statistics
    keep the reference's inverted momentum ``running = m*running +
    (1-m)*batch`` at m=0.1, as the JAX class does. Under a process group's
    data axis (the step's :func:`ops.row_window`) the halves are those of
    the whole batch, their statistics over every rank's rows
    (:meth:`_rank_halves`)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 adaptive_alpha: bool = True):
        super().__init__()
        c = num_features
        self.num_features, self.eps, self.momentum = c, eps, momentum
        self.adaptive_alpha = adaptive_alpha
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        for name, init in (("running_mean_s", torch.zeros), ("running_var_s", torch.ones),
                           ("running_mean_t", torch.zeros), ("running_var_t", torch.ones)):
            self.register_buffer(name, init(c))

    def _alpha(self, ms, vs, mt, vt):
        ratio_s = ms / torch.sqrt(vs + self.eps)
        ratio_t = mt / torch.sqrt(vt + self.eps)
        dist_inv = 1.0 / (1.0 + (ratio_s - ratio_t).abs())
        return self.num_features * dist_inv / dist_inv.sum()

    def forward(self, x):
        shape = (1, -1) if x.ndim == 2 else (1, -1, 1, 1)
        w, b = self.weight.reshape(shape), self.bias.reshape(shape)
        if not self.training:
            out = (x - self.running_mean_t.reshape(shape)) / torch.sqrt(
                self.running_var_t.reshape(shape) + self.eps)
            out = out * w + b
            if self.adaptive_alpha:
                alpha = self._alpha(self.running_mean_s, self.running_var_s,
                                    self.running_mean_t, self.running_var_t)
                out = (1.0 + alpha.reshape(shape)) * out
            return out
        dims = (0,) if x.ndim == 2 else (0, 2, 3)
        axis, window = current_data_axis(), ops.current_window()
        if axis is not None and axis.group is not None and window is not None:
            (x_s, m_s, v_s), (x_t, m_t, v_t) = self._rank_halves(x, axis, window, dims, shape)
        else:
            half = x.shape[0] // 2
            x_s, x_t = x[:half], x[half:]
            m_s, v_s = x_s.mean(dims), x_s.var(dims, unbiased=True)
            m_t, v_t = x_t.mean(dims), x_t.var(dims, unbiased=True)
        with torch.no_grad():
            mom = self.momentum
            for buf, new in ((self.running_mean_s, m_s), (self.running_var_s, v_s),
                             (self.running_mean_t, m_t), (self.running_var_t, v_t)):
                buf.mul_(mom).add_((1 - mom) * new.detach())
        out_s = (x_s - m_s.reshape(shape)) / torch.sqrt(v_s.reshape(shape) + self.eps)
        out_t = (x_t - m_t.reshape(shape)) / torch.sqrt(v_t.reshape(shape) + self.eps)
        out = torch.cat([out_s * w + b, out_t * w + b], dim=0)
        if self.adaptive_alpha:
            alpha = self._alpha(m_s, v_s, m_t, v_t).detach()
            out = (1.0 + alpha.reshape(shape)) * out
        return out

    @staticmethod
    def _rank_halves(x, axis, window, dims, shape):
        """Under a process group: this rank's rows cut at the whole batch's
        half boundary (``window``'s ``total // 2``), and each half's mean and
        unbiased variance over every rank's rows of it, from one all-gather
        of each rank's :func:`_local_moments` of both halves, combined in
        rank order, so every rank computes the same statistics."""
        offset, total = window(x.shape[0])
        cut = min(max(total // 2 - offset, 0), x.shape[0])
        halves = x[:cut], x[cut:]
        per_row = math.prod(x.shape[2:])
        stats = axis.gather([torch.cat([_local_moments(h, dims, shape) for h in halves])[None]])
        out = []
        for h, part in zip(halves, stats.chunk(2, dim=1)):
            mean, m2, n = _combined_moments(part, per_row)
            out.append((h, mean, m2 / (n - 1)))
        return out
