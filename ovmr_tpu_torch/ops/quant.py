"""int8 serving: quantized block matmuls of the frozen towers.

Counterpart of ``ovmr_tpu/ops/quant.py``:

- weights: per-output-channel symmetric int8, quantized once at load
  (:func:`quantize_params`, in numpy, so the int8 weights and their fp32
  scales are the JAX package's bit for bit);
- activations: dynamic per-row symmetric int8, computed on the fly;
- an int8 x int8 product accumulated in int32 (``torch._int_mm``), then
  dequantized in fp32 by the two scales, the bias added in one fused
  multiply-add.

Only the transformer block matmuls (qkv, out, c_fc, c_proj) quantize:
LayerNorm, softmax, attention, the aggregator and the small projections
keep their float types. ``CUDA.INT8`` turns it on for serving; training
never quantizes. The JAX package's int8 product is XLA's ``dot_general``,
not a Pallas kernel, so the library's integer GEMM is this port's too.
Its int32 sums are exact, so the card and the CPU agree bit for bit on
the same int8 operands.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

QUANT_KEYS = ("w_qkv", "w_out", "c_fc_w", "c_proj_w")

# what the card's integer GEMM (cuBLASLt) takes: torch asks for more than
# 16 rows and a depth and width that are multiples of 8; cuBLASLt itself
# refuses (CUBLAS_STATUS_NOT_SUPPORTED) a depth below 128 with a width of 32
# or more unless the rows are a multiple of 32 (tools/probe_torch_int_mm.py
# on an H100 with torch 2.11 / CUDA 12.8: rows 17-308, depths 8-768, widths
# 8-2304)
_INT_MM_ROW_MULTIPLE = 32
_INT_MM_MULTIPLE = 8


def quantize_weight(w) -> tuple:
    """[in, out] float -> (int8 [in, out], fp32 scale [out]), numpy."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_blocks(blocks: dict) -> dict:
    """Quantize the stacked block weights ``[L, in, out]``; the other leaves
    stay as they are. Adds ``{key}_scale`` ``[L, out]`` beside each int8
    weight."""
    out = dict(blocks)
    for key in QUANT_KEYS:
        w = blocks[key]
        w = w.detach().to("cpu", torch.float32).numpy() if torch.is_tensor(w) else np.asarray(w)
        qs, scales = zip(*(quantize_weight(w[i]) for i in range(w.shape[0])))
        out[key] = torch.from_numpy(np.stack(qs))
        out[key + "_scale"] = torch.from_numpy(np.stack(scales))
    return out


def quantize_params(params: dict) -> dict:
    """Quantize the transformer blocks of both towers (a ModifiedResNet
    image tower has none and stays float)."""
    out = dict(params)
    for tower in ("visual", "text"):
        if tower in out and "blocks" in out[tower]:
            t = dict(out[tower])
            t["blocks"] = quantize_blocks(t["blocks"])
            out[tower] = t
    return out


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a [M, K] @ b [K, N]`` -> int32 ``[M, N]`` by ``torch._int_mm``.
    Zero rows pad M to a multiple of 32 and zero columns K and N to
    multiples of 8, as the card's integer GEMM asks, on every device; zeros
    add nothing to an integer sum, so the result is exact."""
    m, k = a.shape
    n = b.shape[1]
    pm = -m % _INT_MM_ROW_MULTIPLE
    pk = -k % _INT_MM_MULTIPLE
    pn = -n % _INT_MM_MULTIPLE
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def quantize_rows(x: torch.Tensor, amax=None) -> tuple:
    """Dynamic per-row symmetric quantization of ``x [M, K]`` (fp32): the
    int8 rows and their fp32 scales ``[M, 1]``, as the compiled JAX
    function computes them: XLA turns ``max|x| / 127`` into a product with
    the float32 reciprocal of 127 and keeps ``x / x_scale`` a division. The
    division is by a tensor, a true division on every device (on a CUDA
    tensor a division by a Python scalar multiplies by its reciprocal), so
    ``round`` at .5 sees the same quotient everywhere. ``amax`` ``[M, 1]``
    is the rows' ``max|x|`` when ``x`` is one shard of longer rows."""
    if amax is None:
        amax = x.abs().amax(dim=1, keepdim=True)
    x_scale = amax * torch.full((1,), 1 / 127, device=x.device)
    x_scale = torch.where(x_scale == 0, torch.ones_like(x_scale), x_scale)
    xq = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    return xq, x_scale


def _dequantize(acc: torch.Tensor, x_scale, w_scale, b, lead, dtype) -> torch.Tensor:
    y = acc.float() * x_scale
    if b is None:
        y = y * w_scale.float()[None, :]
    else:
        # one fused multiply-add, as XLA contracts the compiled JAX function
        y = torch.addcmul(b.float(), y, w_scale.float()[None, :])
    return y.reshape(*lead, -1).to(dtype)


def dense_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               b=None) -> torch.Tensor:
    """``x [..., in]`` float @ int8 weight ``[in, out]`` with per-row
    activation quantization, int32 accumulation and fp32 dequantization by
    ``x_scale * w_scale`` (+ b); returns x's dtype."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"dense_int8: the weight must be int8, got {w_q.dtype}")
    xq, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).float())
    return _dequantize(int_mm(xq, w_q), x_scale, w_scale, b, x.shape[:-1], x.dtype)


def dense_int8_row_parallel(xs, w_qs, w_scale: torch.Tensor, b, axis) -> torch.Tensor:
    """:func:`dense_int8` of rows split over a model axis: ``xs`` are this
    process's column shards of ``x`` and ``w_qs`` the matching row shards
    of the int8 weight. Each row's scale is taken over the whole row (its
    ``max|x|`` reduced over the axis with MAX, as the global view of the
    JAX package's GSPMD product takes it), each shard's int32 product is
    summed over the axis, then dequantized once: exact int32 sums, so the
    result is :func:`dense_int8` of the unsplit row bit for bit."""
    lead = xs[0].shape[:-1]
    flat = [x.reshape(-1, x.shape[-1]).float() for x in xs]
    amax = None
    for x in flat:
        m = x.abs().amax(dim=1, keepdim=True)
        amax = m if amax is None else torch.maximum(amax, m)
    if axis.group is not None:
        import torch.distributed as dist

        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=axis.group)
    x_scale = None
    parts = []
    for x, w in zip(flat, w_qs):
        xq, x_scale = quantize_rows(x, amax)
        parts.append(int_mm(xq, w))
    return _dequantize(axis.reduce(parts), x_scale, w_scale, b, lead, xs[0].dtype)
