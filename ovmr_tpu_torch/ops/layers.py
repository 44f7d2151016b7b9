"""Core numerics shared by all towers: the torch-math layer.

PyTorch counterpart of ``ovmr_tpu/ops/layers.py``, with the same contract
(reference CLIP ``clip/model.py``):

- LayerNorm always computes in float32 and casts back to the input dtype.
- QuickGELU is ``x * sigmoid(1.702 x)``.
- Multi-head attention follows ``nn.MultiheadAttention``: packed QKV
  projection, per-head scaling by ``head_dim**-0.5``, additive mask,
  output projection; the softmax runs in float32.
- Every matrix product accumulates in float32: the operands are rounded to
  the activation dtype and multiplied as float32 tensors. On a CUDA card
  this relies on ``torch.backends.cuda.matmul.allow_tf32`` being False
  (PyTorch's default); TF32 would keep only about three decimal digits.

Weights are stored ``[in, out]`` (right-multiplied, ``x @ W``), as in the
JAX package. A block whose weights are int8 (``CUDA.INT8`` serving,
:mod:`ovmr_tpu_torch.ops.quant`) runs its four products through
``dense_int8``. The plain version of every hand-written kernel in
:mod:`ovmr_tpu_torch.ops.block_fused` and :mod:`ovmr_tpu_torch.ops.attention`
is built from these functions.
"""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 accumulation, float32 result."""
    return torch.matmul(a.float(), b.float())


def dense(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x @ w (+ b) with fp32 accumulation; w stored [in, out]. An int8
    weight raises: cast, it would be read as unscaled integers (int8 block
    weights go through :func:`_block_dense`)."""
    if w.dtype == torch.int8:
        raise TypeError("dense: an int8 weight needs its scale; use ops.quant.dense_int8")
    y = matmul_f32(x, w.to(x.dtype))
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


_BLOCK_BIAS = {"w_qkv": "b_qkv", "w_out": "b_out", "c_fc_w": "c_fc_b", "c_proj_w": "c_proj_b"}


def _block_dense(x: torch.Tensor, p: dict, key: str) -> torch.Tensor:
    """A block's matmul, by its weight's dtype (``ovmr_tpu/ops/layers.py:47-58``):
    an int8 weight (serving quantization) takes
    :func:`ovmr_tpu_torch.ops.quant.dense_int8` with its ``{key}_scale``, a
    float one :func:`dense`."""
    w = p[key]
    if w.dtype == torch.int8:
        from ovmr_tpu_torch.ops.quant import dense_int8

        return dense_int8(x, w, p[key + "_scale"], p[_BLOCK_BIAS[key]])
    return dense(x, w, p[_BLOCK_BIAS[key]])


def mlp_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """c_fc -> QuickGELU -> c_proj (reference ResidualAttentionBlock.mlp)."""
    h = quick_gelu(_block_dense(x, p, "c_fc_w"))
    return _block_dense(h, p, "c_proj_w")


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, Dh], contiguous."""
    b, l, d = x.shape
    return x.reshape(b, l, n_head, d // n_head).permute(0, 2, 1, 3).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, D]"""
    b, h, l, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, h * dh)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference-path attention (``attention_xla``): [B, H, L, Dh] inputs,
    additive mask [L, L]. ``q`` is scaled in its own dtype before the
    product; scores and softmax in float32; output in q.dtype."""
    scale = q.shape[-1] ** -0.5
    scores = matmul_f32(q * scale, k.transpose(-1, -2))
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return matmul_f32(probs.to(q.dtype), v).to(q.dtype)


def multi_head_attention(
    x: torch.Tensor,
    p: dict,
    n_head: int,
    mask: Optional[torch.Tensor] = None,
    attn_fn=attention_plain,
) -> torch.Tensor:
    """``nn.MultiheadAttention`` over batch-major [B, L, D]. Params:
    ``w_qkv`` [D, 3D], ``b_qkv`` [3D], ``w_out`` [D, D], ``b_out`` [D]."""
    qkv = _block_dense(x, p, "w_qkv")
    q, k, v = (split_heads(t, n_head) for t in qkv.chunk(3, dim=-1))
    out = merge_heads(attn_fn(q, k, v, mask))
    return _block_dense(out, p, "w_out")


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: 0 on/below the diagonal, -inf above
    (reference ``clip/model.py:802-808``)."""
    neg = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(neg, diagonal=1)


def residual_attention_block(
    x: torch.Tensor,
    p: dict,
    n_head: int,
    mask: Optional[torch.Tensor] = None,
    attn_fn=attention_plain,
) -> torch.Tensor:
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x))
    (reference ``clip/model.py:191-194``)."""
    x = x + multi_head_attention(
        layer_norm(x, p["ln_1_scale"], p["ln_1_bias"]), p, n_head, mask, attn_fn
    )
    return x + mlp_block(layer_norm(x, p["ln_2_scale"], p["ln_2_bias"]), p)


def residual_block_remat(
    x: torch.Tensor,
    p: dict,
    n_head: int,
    mask: Optional[torch.Tensor] = None,
    attn_fn=attention_plain,
) -> torch.Tensor:
    """The torch-math block with per-layer rematerialisation
    (``residual_block_remat``): identical values, but the backward recomputes
    the layer instead of keeping its intermediates. For a differentiated
    tower whose caller passes the torch-math block explicitly; the kernel
    block :func:`ovmr_tpu_torch.ops.block_fused.fused_residual_block`
    rematerialises by construction."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(
        lambda x_: residual_attention_block(x_, p, n_head, mask, attn_fn),
        x, use_reentrant=False,
    )


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Unit-normalize along ``dim`` in float32, cast back to x.dtype."""
    xf = x.float()
    return (xf / (torch.linalg.vector_norm(xf, dim=dim, keepdim=True) + eps)).to(
        x.dtype
    )
