"""Functional modeling ops (reference ``dassl/modeling/ops/``).

Counterpart of ``ovmr_tpu/modeling/ops.py``. Feature maps are NCHW, torch's
layout (the JAX package's are NHWC; statistics are over the spatial axes in
both). Where the JAX ops take a PRNG key, these take an explicit
``torch.Generator`` (``None``: torch's default generator), or the draws
themselves (``lmda``, ``perm``, ``apply``), which is how the parity tests
hold them against the JAX functions: torch cannot reproduce JAX's streams.
Beta draws come from a numpy generator seeded by one draw of the torch
generator (torch's Beta sampler takes no generator).

Op -> reference file map:

- ``reverse_grad``            ops/reverse_grad.py (autograd Function)
- ``cross_entropy``           ops/cross_entropy.py
- ``mixup``                   ops/mixup.py
- ``mixstyle``                ops/mixstyle.py (MixStyle, ICLR'21)
- ``efdmix``                  ops/efdmix.py (EFDMix, CVPR'22)
- ``mmd``                     ops/mmd.py (MaximumMeanDiscrepancy)
- ``sinkhorn_divergence`` / ``minibatch_energy_distance``
                              ops/optimal_transport.py
- ``sharpen_prob``/``create_onehot``/``*_rampup``/``ema_update``
                              ops/utils.py

:func:`rng_scope` makes a generator the one that dropout and the
feature-statistics mixing inside the modules draw from (the JAX modules'
``'dropout'`` and ``'mixstyle'`` streams).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "reverse_grad",
    "cross_entropy",
    "mixup",
    "mixstyle",
    "efdmix",
    "mmd",
    "sinkhorn_divergence",
    "minibatch_energy_distance",
    "sharpen_prob",
    "create_onehot",
    "sigmoid_rampup",
    "linear_rampup",
    "ema_update",
    "rng_scope",
    "current_generator",
    "row_window",
    "current_window",
    "rank_local_mixing",
    "rand_rows",
    "dropout",
]

_GENERATOR: contextvars.ContextVar = contextvars.ContextVar("dassl_generator", default=None)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("dassl_row_window", default=None)
_LOCAL_MIX: contextvars.ContextVar = contextvars.ContextVar("dassl_local_mix", default=False)


@contextlib.contextmanager
def rng_scope(generator: Optional[torch.Generator]):
    """Within the block, dropout, drop-connect and MixStyle/EFDMix inside the
    modules draw from ``generator``."""
    token = _GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _GENERATOR.reset(token)


def current_generator() -> Optional[torch.Generator]:
    return _GENERATOR.get()


@contextlib.contextmanager
def row_window(window):
    """Within the block, ``window(n)`` is ``(offset, total)``: the ``n``
    rows a module is given are rows ``[offset, offset + n)`` of a batch of
    ``total`` rows that other processes hold the rest of, and the per-row
    draws (:func:`rand_rows`: dropout's mask, drop-connect's) are the whole
    batch's, of which the module keeps those rows (so each process draws
    what one process would for the whole batch). MixStyle and EFDMix draw
    the whole batch's weights and permutation and, under a process group's
    data axis, mix each row with its partner on whichever rank holds it.
    None draws for the rows given."""
    token = _ROWS.set(window)
    try:
        yield window
    finally:
        _ROWS.reset(token)


def current_window():
    """The window of the :func:`row_window` block in force (None outside one)."""
    return _ROWS.get()


@contextlib.contextmanager
def rank_local_mixing():
    """Within the block, MixStyle and EFDMix draw for and mix only the rows
    they are given, whatever the window: under a process group each rank's
    block on its own. The control of the process-group checks, which must
    fail them."""
    token = _LOCAL_MIX.set(True)
    try:
        yield
    finally:
        _LOCAL_MIX.reset(token)


def rand_rows(shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Uniform draws of ``shape`` (rows first) from ``generator`` on
    ``device`` (the generator's by default); within :func:`row_window`, the
    given rows of the whole batch's draw."""
    device = device if device is not None else _gen_device(generator, "cpu")
    window = _ROWS.get()
    if window is None:
        return torch.rand(shape, generator=generator, device=device)
    offset, total = window(shape[0])
    return torch.rand((total,) + tuple(shape[1:]), generator=generator,
                      device=device)[offset:offset + shape[0]]


def _gen_device(generator: Optional[torch.Generator], fallback) -> torch.device:
    return generator.device if generator is not None else torch.device(fallback)


def _np_rng(generator: Optional[torch.Generator]) -> np.random.Generator:
    """A numpy generator seeded by one draw of ``generator``."""
    seed = torch.randint(0, 2**62, (1,), generator=generator,
                         device=_gen_device(generator, "cpu"))
    return np.random.default_rng(int(seed))


def dropout(x: torch.Tensor, p: float, train: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (else the scope's,
    else torch's default)."""
    if not train or p <= 0:
        return x
    generator = generator if generator is not None else current_generator()
    if generator is None:
        return F.dropout(x, p, training=True)
    keep = rand_rows(x.shape, generator).to(x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


# ---------------------------------------------------------------------------
# gradient reversal (reference ops/reverse_grad.py)
# ---------------------------------------------------------------------------

class _ReverseGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_scaling):
        ctx.grad_scaling = grad_scaling
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.grad_scaling * g, None


def reverse_grad(x: torch.Tensor, grad_scaling=1.0) -> torch.Tensor:
    """Identity in the forward; scales the gradient by ``-grad_scaling`` in
    the backward (the GRL of DANN/MME)."""
    if float(grad_scaling) < 0:
        raise ValueError(f"grad_scaling must be non-negative, but got {grad_scaling}")
    return _ReverseGrad.apply(x, float(grad_scaling))


# ---------------------------------------------------------------------------
# losses / label utilities
# ---------------------------------------------------------------------------

def cross_entropy(logits, label, label_smooth: float = 0.0, reduction="mean"):
    """Label-smoothed cross entropy over ``[B, C]`` logits and int labels
    (reference ops/cross_entropy.py)."""
    num_classes = logits.shape[1]
    log_prob = torch.log_softmax(logits, dim=1)
    target = F.one_hot(label.long(), num_classes).to(logits.dtype)
    target = (1.0 - label_smooth) * target + label_smooth / num_classes
    loss = -(target * log_prob).sum(dim=1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(reduction)


def create_onehot(label, num_classes: int) -> torch.Tensor:
    return F.one_hot(torch.as_tensor(label).long(), num_classes).float()


def sharpen_prob(p, temperature: float = 2.0):
    """Temperature sharpening of a ``[B, C]`` probability matrix."""
    p = p ** temperature
    return p / p.sum(dim=1, keepdim=True)


def sigmoid_rampup(current, rampup_length: int) -> float:
    """exp(-5(1-t)^2) ramp (a host-side schedule scalar)."""
    assert rampup_length > 0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current, rampup_length: int) -> float:
    assert rampup_length > 0
    return float(np.clip(current / rampup_length, 0.0, 1.0))


@torch.no_grad()
def ema_update(ema_tree, tree, alpha: float):
    """``ema = alpha * ema + (1-alpha) * new`` over matching nested dicts or
    modules (reference ops/utils.py::ema_model_update); in place for
    modules, a new dict otherwise."""
    if isinstance(ema_tree, torch.nn.Module):
        for e, p in zip(ema_tree.parameters(), tree.parameters()):
            e.mul_(alpha).add_(p, alpha=1.0 - alpha)
        return ema_tree
    if isinstance(ema_tree, dict):
        return {k: ema_update(ema_tree[k], tree[k], alpha) for k in ema_tree}
    return alpha * ema_tree + (1.0 - alpha) * tree


def mixup(x1, x2, y1, y2, beta: float, generator=None, preserve_order: bool = False,
          lam=None):
    """Beta-interpolated inputs and one-hot labels. ``x*`` are batch-leading
    image batches, ``y*`` ``[B, C]`` one-hots; ``lam`` ([B], preserve_order
    already applied) injects externally drawn coefficients."""
    b = x1.shape[0]
    if lam is None:
        lmda = _np_rng(generator).beta(beta, beta, (b,)).astype(np.float32)
        if preserve_order:
            lmda = np.maximum(lmda, 1.0 - lmda)
        lam = lmda
    lmda = torch.as_tensor(np.array(lam, np.float32), device=x1.device).to(x1.dtype)
    lx = lmda.reshape((b,) + (1,) * (x1.ndim - 1))
    xmix = x1 * lx + x2 * (1.0 - lx)
    ly = lmda.reshape(b, 1)
    ymix = y1 * ly + y2 * (1.0 - ly)
    return xmix, ymix


# ---------------------------------------------------------------------------
# feature-statistics mixing (MixStyle / EFDMix) — NCHW
# ---------------------------------------------------------------------------

def mix_permutation(generator, batch: int, mix: str, device="cpu") -> torch.Tensor:
    """The batch permutation of MixStyle and EFDMix: ``random`` a full
    shuffle; ``crossdomain`` reverses the batch (the two domain halves swap)
    and shuffles within each half."""
    gdev = _gen_device(generator, device)
    if mix == "random":
        return torch.randperm(batch, generator=generator, device=gdev).to(device)
    if mix == "crossdomain":
        perm = torch.arange(batch - 1, -1, -1, device=gdev)
        half = batch // 2
        perm_b = perm[:half][torch.randperm(half, generator=generator, device=gdev)]
        perm_a = perm[half:][torch.randperm(batch - half, generator=generator, device=gdev)]
        return torch.cat([perm_b, perm_a]).to(device)
    raise NotImplementedError(mix)


def _mix_draws(x, generator, p, alpha, mix, lmda, perm, apply):
    """The three draws of one MixStyle/EFDMix call, each injectable: the
    batch coin, the Beta weights and the permutation of the rows the call
    spans, which are the batch of :func:`row_window` (every process draws
    what one process draws for it, an injected draw is the whole batch's),
    else the rows given. Returns the coin, the given rows' weights and
    partners (indices into the spanned rows), and ``span``: a per-row tensor
    of the given rows -> the spanned rows' (under a process group's data
    axis every rank's, :func:`_window_rows`)."""
    b = x.shape[0]
    window = None if _LOCAL_MIX.get() else _ROWS.get()
    offset, total = (0, b) if window is None else window(b)
    if apply is None:
        u = torch.rand((), generator=generator, device=_gen_device(generator, "cpu"))
        apply = bool(u < p)
    if lmda is None:
        lmda = _np_rng(generator).beta(alpha, alpha, (total,)).astype(np.float32)
    if perm is None:
        perm = mix_permutation(generator, total, mix, device=x.device)
    lmda = torch.as_tensor(np.array(lmda, np.float32), device=x.device).to(x.dtype)
    perm = torch.as_tensor(np.array(perm) if isinstance(perm, np.ndarray) else perm,
                           device=x.device).long()
    span = _same_rows
    if window is not None:
        from ovmr_tpu_torch.modeling.layers import current_data_axis  # layers imports ops

        axis = current_data_axis()
        if axis is not None and axis.group is not None:
            span = functools.partial(_window_rows, axis=axis)
    return bool(apply), lmda[offset:offset + b], perm[offset:offset + b], span


def _same_rows(t):
    return t


def _window_rows(t, axis):
    """Every rank's rows of a per-row tensor in row order, from this rank's:
    the ranks' row counts all-gathered first (a domain group's pieces may be
    unequal or empty), then each rank's rows padded to the largest count and
    all-gathered through the data axis, whose backward returns each rank
    its own rows' cotangent summed over the ranks."""
    # a row count stays exact in the rows' floating type
    counts = [int(n) for n in axis.gather([t.new_full((1,), t.shape[0])]).tolist()]
    most = max(counts)
    if t.shape[0] < most:
        t = torch.cat([t, t.new_zeros((most - t.shape[0],) + tuple(t.shape[1:]))])
    rows = axis.gather([t])
    return torch.cat([rows[r * most:r * most + n] for r, n in enumerate(counts)])


def mixstyle(x, generator=None, p: float = 0.5, alpha: float = 0.1, eps: float = 1e-6,
             mix: str = "random", train: bool = True, lmda=None, perm=None, apply=None):
    """MixStyle on an NCHW feature map: each sample's channel statistics
    renormalised to a Beta mix of its own and a permuted partner's
    (statistics detached, as in the reference). One coin a call skips the
    whole batch with probability ``1 - p``."""
    if not train or p <= 0:
        return x
    apply, lmda, perm, span = _mix_draws(x, generator, p, alpha, mix, lmda, perm, apply)
    if not apply:
        return x
    mu = x.mean(dim=(2, 3), keepdim=True).detach()
    var = x.var(dim=(2, 3), keepdim=True, unbiased=True)
    sig = (var + eps).sqrt().detach()
    x_normed = (x - mu) / sig
    lm = lmda.reshape(-1, 1, 1, 1)
    mu_all, sig_all = span(torch.cat([mu, sig], dim=1)).chunk(2, dim=1)
    mu_mix = mu * lm + mu_all[perm] * (1.0 - lm)
    sig_mix = sig * lm + sig_all[perm] * (1.0 - lm)
    return x_normed * sig_mix + mu_mix


def efdmix(x, generator=None, p: float = 0.5, alpha: float = 0.1, mix: str = "random",
           train: bool = True, lmda=None, perm=None, apply=None):
    """EFDMix on an NCHW feature map: exact (sorted) feature distribution
    matching between each sample and a permuted partner, interpolated by a
    Beta draw; gradients reach both samples, as the reference's
    ``x + (x_copy - x.detach()) * (1-lmda)`` (across the ranks under a
    process group)."""
    if not train or p <= 0:
        return x
    apply, lmda, perm, span = _mix_draws(x, generator, p, alpha, mix, lmda, perm, apply)
    if not apply:
        return x
    b, c, h, w = x.shape
    x_view = x.reshape(b, c, h * w)
    value_x, order = torch.sort(x_view, dim=-1, stable=True)
    inverse = torch.argsort(order, dim=-1)
    x_copy = torch.gather(span(value_x)[perm], -1, inverse)
    new_x = x_view + (x_copy - x_view.detach()) * (1.0 - lmda.reshape(-1, 1, 1))
    return new_x.reshape(b, c, h, w)


# ---------------------------------------------------------------------------
# distribution distances
# ---------------------------------------------------------------------------

def _offdiag_mean(k):
    n = k.shape[0]
    return (k.sum() - torch.trace(k)) / (n * (n - 1))


def _sq_euclidean(x, y):
    return (x ** 2).sum(dim=1, keepdim=True) + (y ** 2).sum(dim=1)[None, :] - 2.0 * x @ y.T


def _rbf_mixture(d, sigmas=(1.0, 5.0, 10.0)):
    k = 0.0
    for sigma in sigmas:
        k = k + torch.exp(-(1.0 / (2.0 * sigma ** 2)) * d)
    return k


def mmd(x, y, kernel_type: str = "rbf", normalize: bool = False):
    """Maximum mean discrepancy between two ``[B, D]`` batches (reference
    ops/mmd.py; self-distances excluded from k_xx and k_yy)."""
    if normalize:
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        y = y / torch.linalg.norm(y, dim=1, keepdim=True)
    if kernel_type == "linear":
        return _offdiag_mean(x @ x.T) + _offdiag_mean(y @ y.T) - 2 * (x @ y.T).mean()
    if kernel_type == "poly":
        alpha, c, d = 1.0, 2.0, 2
        return (_offdiag_mean((alpha * (x @ x.T) + c) ** d)
                + _offdiag_mean((alpha * (y @ y.T) + c) ** d)
                - 2 * ((alpha * (x @ y.T) + c) ** d).mean())
    if kernel_type == "rbf":
        return (_offdiag_mean(_rbf_mixture(_sq_euclidean(x, x)))
                + _offdiag_mean(_rbf_mixture(_sq_euclidean(y, y)))
                - 2 * _rbf_mixture(_sq_euclidean(x, y)).mean())
    raise NotImplementedError(kernel_type)


def _ot_distance(x, y, dist_metric: str):
    if dist_metric == "cosine":
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        y = y / torch.linalg.norm(y, dim=1, keepdim=True)
        return 1.0 - x @ y.T
    if dist_metric in ("euclidean", "fast_euclidean"):
        return _sq_euclidean(x, y)
    raise ValueError(f"Unknown cost function: {dist_metric}")


def _sinkhorn_plan(c, eps: float, max_iter: int, thre: float = 1e-3):
    """Log-domain Sinkhorn iterations, stopping early on the |u - u0|
    residual (the reference's real_iter loop)."""
    nx, ny = c.shape
    log_mu = torch.log(torch.full((nx,), 1.0 / nx, dtype=c.dtype, device=c.device) + 1e-8)
    log_nu = torch.log(torch.full((ny,), 1.0 / ny, dtype=c.dtype, device=c.device) + 1e-8)

    def m(u, v):
        return (-c + u[:, None] + v[None, :]) / eps

    u = torch.zeros(nx, dtype=c.dtype, device=c.device)
    v = torch.zeros(ny, dtype=c.dtype, device=c.device)
    for _ in range(max_iter):
        u_new = eps * (log_mu - torch.logsumexp(m(u, v), dim=1)) + u
        v_new = eps * (log_nu - torch.logsumexp(m(u_new, v).T, dim=1)) + v
        err = float((u_new - u).detach().abs().sum())
        u, v = u_new, v_new
        if err < thre:
            break
    return torch.exp(m(u, v))


def _transport_cost(x, y, dist_metric, eps, max_iter, bp_to_sinkhorn):
    c = _ot_distance(x, y, dist_metric)
    pi = _sinkhorn_plan(c, eps, max_iter)
    if not bp_to_sinkhorn:
        pi = pi.detach()
    return (pi * c).sum()


def sinkhorn_divergence(x, y, dist_metric: str = "cosine", eps: float = 0.01,
                        max_iter: int = 5, bp_to_sinkhorn: bool = False):
    """Sinkhorn divergence ``2 W(x,y) - W(x,x) - W(y,y)`` between two
    ``[B, D]`` batches (reference ops/optimal_transport.py)."""
    def cost(a, b):
        return _transport_cost(a, b, dist_metric, eps, max_iter, bp_to_sinkhorn)

    return 2.0 * cost(x, y) - cost(x, x) - cost(y, y)


def minibatch_energy_distance(x, y, dist_metric: str = "cosine", eps: float = 0.01,
                              max_iter: int = 5, bp_to_sinkhorn: bool = False):
    """Minibatch energy distance over split halves (reference
    ops/optimal_transport.py::MinibatchEnergyDistance)."""
    def cost(a, b):
        return _transport_cost(a, b, dist_metric, eps, max_iter, bp_to_sinkhorn)

    x1, x2 = torch.chunk(x, 2, dim=0)
    y1, y2 = torch.chunk(y, 2, dim=0)
    return (cost(x1, y1) + cost(x1, y2) + cost(x2, y1) + cost(x2, y2)
            - 2.0 * cost(x1, x2) - 2.0 * cost(y1, y2))
