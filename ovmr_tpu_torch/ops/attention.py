"""Standalone fused attention over [B, H, L, Dh] as a hand-written Hopper kernel.

PyTorch counterpart of ``ovmr_tpu/ops/attention.py``: **K6**
:func:`fused_attention` (TPU: ``_attn_kernel`` :28, ``_attn_kernel_masked``
:43) computes ``softmax(q k^T * scale + mask) v`` with Q and K upcast to
fp32 before the score product, an fp32 softmax, the probabilities cast to
v's dtype and the p.v product accumulated in fp32. On the serving path it
runs the aggregator's attention (``models/aggregator.py``).

The raw wrapper :func:`fused_attention_kernel` takes the plain version for
a tensor on the CPU and launches ``csrc/attention.cu`` for a tensor on a
CUDA card; it never falls back. It records no autograd graph, so on the
card it raises for a tensor that requires grad. :func:`fused_attention`,
the entry the models call, is differentiable (TPU: ``pallas_attention`` /
``pallas_attention_masked`` :114-154): K6 forward, and for dq, dk, dv torch
autograd over :func:`ovmr_tpu_torch.ops.layers.attention_plain` on the
saved q, k, v. The JAX package has no backward kernel for K6, so neither
has the port. Where no gradient is wanted (serving runs under
``torch.no_grad()``) it calls the raw wrapper without the autograd
Function: at the aggregator's shapes the host's time to issue a call, not
the card, bounds K6, so the wrapper keeps its checks to one pass over the
tensors' attributes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.layers import attention_plain, matmul_f32


def fused_attention_plain(q, k, v, mask: Optional[torch.Tensor] = None):
    """K6's arithmetic in PyTorch: q and k upcast, q scaled in fp32."""
    scale = q.shape[-1] ** -0.5
    scores = matmul_f32(q.float() * scale, k.transpose(-1, -2))
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return matmul_f32(probs.to(v.dtype), v).to(q.dtype)


# csrc/attention.cu: at most K6_MAX_KEYS keys, and one warp's fp32 Q, K and
# V within a block's 227 KB of shared memory
K6_MAX_KEYS = 256
_SMEM_BYTES = 227 * 1024


def k6_smem_bytes(l: int, dh: int) -> int:
    """Bytes of one warp's fp32 Q, K and V in ``csrc/attention.cu``: Q and V
    rows ``dh`` floats apart, K rows ``k6_ldk(dh)`` apart (a stride that
    keeps the lanes' reads on distinct banks)."""
    ldk = (dh | 1) if dh % 4 else dh + (0 if (dh // 4) % 2 else 4)
    return 4 * l * (2 * dh + ldk)


def fused_attention_kernel(q, k, v, mask: Optional[torch.Tensor] = None):
    """K6 forward over [B, H, L, Dh]; ``mask`` is additive [L, L]. No
    autograd graph is recorded."""
    dev = q.device
    if dev.type == "cpu":
        return fused_attention_plain(q, k, v, mask)
    if dev.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {dev}")
    what = "fused_attention"
    cuda_lib.require_no_grad(what, q, k, v)
    shape, dtype = q.shape, q.dtype
    if len(shape) != 4 or k.shape != shape or v.shape != shape:
        raise ValueError(f"{what}: q, k, v must share one [B, H, L, Dh] shape")
    b, h, l, dh = shape
    code = cuda_lib.dtype_code(dtype)
    cuda_lib.require_cuda_args(what, dtype, dev, q=q, k=k, v=v)
    if mask is not None:
        if mask.shape != (l, l) or mask.dtype != torch.float32:
            raise ValueError(f"{what}: mask must be fp32 [{l}, {l}]")
        if mask.device != dev or not mask.is_contiguous():
            raise ValueError(f"{what}: mask must be contiguous on {dev}")
    if l > K6_MAX_KEYS or k6_smem_bytes(l, dh) > _SMEM_BYTES:
        raise ValueError(f"{what}: L={l}, Dh={dh} exceeds one warp's shared memory "
                         f"(at most {K6_MAX_KEYS} keys)")
    lib = cuda_lib.library("attention")
    out = torch.empty_like(q)
    with cuda_lib.on_device(dev):
        status = lib.ovmr_fused_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            out.data_ptr(), b * h, l, dh, cuda_lib.stream_of(q),
        )
    cuda_lib.check(lib, status, what)
    cuda_lib.count_launch("fused_attention", q)
    return out


class _FusedAttention(torch.autograd.Function):
    """K6 forward; dq, dk, dv by torch autograd over ``attention_plain`` on
    the saved q, k, v (``_pa_bwd`` :123-128, ``_pam_bwd`` :143-151)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return fused_attention_kernel(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_plain(*leaves, mask)
            dq, dk, dv = torch.autograd.grad(out, leaves, g.to(out.dtype))
        return dq, dk, dv, None


def fused_attention(q, k, v, mask: Optional[torch.Tensor] = None):
    """K6, differentiable: fused attention over [B, H, L, Dh]; ``mask`` is
    additive [L, L] and gets no gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedAttention.apply(q, k, v, mask)
    return fused_attention_kernel(q, k, v, mask)
