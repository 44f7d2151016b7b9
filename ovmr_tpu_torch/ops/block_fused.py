"""The two halves of the CLIP residual block, as hand-written Hopper kernels.

PyTorch counterpart of ``ovmr_tpu/ops/block_fused.py``:

- **K1** :func:`fused_attn_half` (TPU: ``_attn_half_kernel`` :58 and
  ``_masked_attn_half_kernel`` :113): ``x + out_proj(MHA(LN1(x)))`` with a
  packed ``[D, 3D]`` QKV weight and an optional additive fp32 ``[L, L]``
  mask (causal in the text tower).
- **K2** :func:`fused_mlp_half` (TPU: ``_mlp_half_kernel`` :123):
  ``x + c_proj(QuickGELU(c_fc(LN2(x))))``.

- :func:`fused_residual_block`, the differentiable block (TPU:
  ``_fused_block`` :483-558): K1 then K2 forward; the backward runs the dx
  kernels K4 then K3 of :mod:`ovmr_tpu_torch.ops.block_fused_bwd` on the
  saved block input and attention-half output.

Each wrapper takes its plain PyTorch version (``*_plain``, built from
:mod:`ovmr_tpu_torch.ops.layers`) for a tensor on the CPU and launches the
CUDA kernels of ``csrc/block_fused.cu`` for a tensor on a CUDA card; it
never falls back from one to the other. A raw wrapper (``fused_attn_half``,
``fused_mlp_half``) records no autograd graph, so on the card it raises for
a tensor that requires grad; gradients go through
:func:`fused_residual_block`. The plain versions round where
the kernels round (``block_fused.py:68-149``): LN output cast before the
product, qkv cast after its bias, scores scaled after the fp32 product,
probs and each head's output cast, the projection cast before the residual
add, QuickGELU in fp32 then cast.

Unlike the TPU module there is no VMEM residency routing
(``_block_flavor``/``_g_limits``): on CUDA every dtype (fp32, bf16, fp16)
and every width that is a multiple of 8 runs the kernels. The source note
in ``csrc/block_fused.cu`` says what bounds them and how they are built.
"""

from __future__ import annotations

from typing import Optional

import torch

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.layers import (
    dense,
    layer_norm,
    matmul_f32,
    merge_heads,
    residual_attention_block,
    split_heads,
)

# epilogue codes of csrc/block_fused.cu ovmr_gemm
_EPI_BIAS, _EPI_BIAS_GELU, _EPI_BIAS_RESIDUAL = 0, 1, 2


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def fused_attn_half_plain(
    x, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 12,
):
    """x + proj(attention(LN1(x))) for x [B, L, D], K1's rounding."""
    dtype = x.dtype
    dh = x.shape[-1] // n_head
    qkv = dense(layer_norm(x, ln_s, ln_b), w_qkv, b_qkv)
    q, k, v = (split_heads(t, n_head) for t in qkv.chunk(3, dim=-1))
    scores = matmul_f32(q, k.transpose(-1, -2)) * dh ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    heads = matmul_f32(probs.to(dtype), v).to(dtype)
    return x + dense(merge_heads(heads), w_out, b_out)


def fused_mlp_half_plain(x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b):
    """x + c_proj(QuickGELU(c_fc(LN2(x)))) for x [B, L, D], K2's rounding
    (QuickGELU in fp32, then cast)."""
    h = matmul_f32(layer_norm(x, ln_s, ln_b), c_fc_w) + c_fc_b.float()
    h = (h * torch.sigmoid(1.702 * h)).to(x.dtype)
    return x + dense(h, c_proj_w, c_proj_b)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check_block_args(what, x, weights, mask=None, n_head=None):
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be [B, L, D], got {tuple(x.shape)}")
    b, l, d = x.shape
    if d % 8:
        raise ValueError(f"{what}: width {d} must be a multiple of 8")
    if b * l > 65535 * 64:  # the GEMM grid's y limit at 64-row tiles
        raise ValueError(f"{what}: {b} x {l} tokens is too many for one launch")
    cuda_lib.dtype_code(x.dtype)
    cuda_lib.require_cuda_args(what, x.dtype, x.device, x=x, **weights)
    if n_head is not None:
        if d % n_head or (d // n_head) % 8:
            raise ValueError(
                f"{what}: head width {d}/{n_head} must be a whole multiple of 8"
            )
    if mask is not None:
        if mask.shape != (l, l) or mask.dtype != torch.float32:
            raise ValueError(f"{what}: mask must be fp32 [{l}, {l}]")
        if mask.device != x.device or not mask.is_contiguous():
            raise ValueError(f"{what}: mask must be contiguous on {x.device}")


def _shapes_ok(what, **pairs):
    for name, (t, shape) in pairs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")


def _layer_norm(lib, code, x, ln_s, ln_b, stream):
    """LayerNorm of x [..., D] in fp32, cast to x's dtype."""
    y = torch.empty_like(x)
    cuda_lib.check(
        lib,
        lib.ovmr_layer_norm(code, x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                            y.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], stream),
        "ovmr_layer_norm",
    )
    return y


def _gemm(lib, code, a, w, bias, out, epilogue, stream, resid=None):
    """out = epilogue(a @ w + bias) for a [..., K], w [K, N]."""
    cuda_lib.check(
        lib,
        lib.ovmr_gemm(
            code, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            resid.data_ptr() if resid is not None else None, out.data_ptr(),
            a.numel() // a.shape[-1], w.shape[-1], a.shape[-1], epilogue, stream,
        ),
        "ovmr_gemm",
    )


def fused_attn_half(
    x, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 12,
):
    """K1: x + proj(attention(LN1(x))) for x [B, L, D]."""
    if x.device.type == "cpu":
        return fused_attn_half_plain(
            x, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b, mask=mask, n_head=n_head
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_half: no kernel for device {x.device}")
    what = "fused_attn_half"
    cuda_lib.require_no_grad(what, x, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b)
    b, l, d = x.shape
    _check_block_args(
        what, x,
        dict(w_qkv=w_qkv, b_qkv=b_qkv, w_out=w_out, b_out=b_out, ln_s=ln_s, ln_b=ln_b),
        mask=mask, n_head=n_head,
    )
    _shapes_ok(
        what, w_qkv=(w_qkv, (d, 3 * d)), b_qkv=(b_qkv, (3 * d,)),
        w_out=(w_out, (d, d)), b_out=(b_out, (d,)), ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )
    dh = d // n_head
    if x.dtype == torch.float32:
        # fp32 attention core: Q tile of 64 rows, K, V and scores in shared memory
        if ((64 + 2 * l) * (dh + 1) + 64 * (l + 1)) * 4 > 227 * 1024:
            raise ValueError(f"{what}: fp32 L={l}, head width {dh} exceed shared memory")
    elif -(-l // 16) * 16 > 320 or -(-dh // 16) * 16 > 128:
        raise ValueError(f"{what}: the attention core takes L <= 320 and head width <= 128")
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
        _gemm(lib, code, xln, w_qkv, b_qkv, qkv, _EPI_BIAS, stream)
        heads = torch.empty_like(x)
        cuda_lib.check(
            lib,
            lib.ovmr_attn_core(
                code, qkv.data_ptr(), mask.data_ptr() if mask is not None else None,
                heads.data_ptr(), b, l, d, n_head, stream,
            ),
            "ovmr_attn_core",
        )
        out = torch.empty_like(x)
        _gemm(lib, code, heads, w_out, b_out, out, _EPI_BIAS_RESIDUAL, stream, resid=x)
    cuda_lib.count_launch("fused_attn_half_masked" if mask is not None else "fused_attn_half", x)
    return out


def fused_mlp_half(x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b):
    """K2: x + c_proj(QuickGELU(c_fc(LN2(x)))) for x [B, L, D]."""
    if x.device.type == "cpu":
        return fused_mlp_half_plain(x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_half: no kernel for device {x.device}")
    what = "fused_mlp_half"
    cuda_lib.require_no_grad(what, x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b)
    b, l, d = x.shape
    hidden = c_fc_w.shape[-1]
    _check_block_args(
        what, x,
        dict(c_fc_w=c_fc_w, c_fc_b=c_fc_b, c_proj_w=c_proj_w, c_proj_b=c_proj_b,
             ln_s=ln_s, ln_b=ln_b),
    )
    if hidden % 8:
        raise ValueError(f"{what}: hidden width {hidden} must be a multiple of 8")
    _shapes_ok(
        what, c_fc_w=(c_fc_w, (d, hidden)), c_fc_b=(c_fc_b, (hidden,)),
        c_proj_w=(c_proj_w, (hidden, d)), c_proj_b=(c_proj_b, (d,)),
        ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        h = torch.empty((b, l, hidden), dtype=x.dtype, device=x.device)
        _gemm(lib, code, xln, c_fc_w, c_fc_b, h, _EPI_BIAS_GELU, stream)
        out = torch.empty_like(x)
        _gemm(lib, code, h, c_proj_w, c_proj_b, out, _EPI_BIAS_RESIDUAL, stream, resid=x)
    cuda_lib.count_launch("fused_mlp_half", x)
    return out


# the layer's tensors in the order the autograd Function takes them
BLOCK_KEYS = (
    "w_qkv", "b_qkv", "w_out", "b_out", "ln_1_scale", "ln_1_bias",
    "c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b", "ln_2_scale", "ln_2_bias",
)


class _FusedBlock(torch.autograd.Function):
    """K1 then K2 forward; K4 then K3 backward (``_fused_block`` :483-558).

    Saves the block input x, the attention half's output y (K1 wrote it to
    global memory anyway) and the layer's tensors, nothing else: both dx
    kernels recompute their half's intermediates, which is what gives a
    differentiated tower its per-layer rematerialisation. For CPU tensors
    the same wiring runs the plain twins in both directions."""

    @staticmethod
    def forward(ctx, x, mask, n_head, *weights):
        (w_qkv, b_qkv, w_out, b_out, ln_1_s, ln_1_b,
         c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_2_s, ln_2_b) = weights
        y = fused_attn_half(x, w_qkv, b_qkv, w_out, b_out, ln_1_s, ln_1_b,
                            mask=mask, n_head=n_head)
        z = fused_mlp_half(y, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_2_s, ln_2_b)
        ctx.n_head = n_head
        ctx.save_for_backward(x, y, mask, *weights)
        return z

    @staticmethod
    def backward(ctx, g):
        from ovmr_tpu_torch.ops.block_fused_bwd import attn_half_bwd_dx, mlp_half_bwd_dx

        x, y, mask, *weights = ctx.saved_tensors
        (w_qkv, b_qkv, w_out, b_out, ln_1_s, ln_1_b,
         c_fc_w, c_fc_b, c_proj_w, _, ln_2_s, ln_2_b) = weights
        # autograd may hand over a strided or differently typed cotangent;
        # the kernels take x's dtype, contiguous
        g = g.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dy = mlp_half_bwd_dx(y, g, c_fc_w, c_fc_b, c_proj_w, ln_2_s, ln_2_b)
            dx = attn_half_bwd_dx(x, dy, w_qkv, b_qkv, w_out, ln_1_s, ln_1_b,
                                  mask=mask, n_head=ctx.n_head)
        wanted = ctx.needs_input_grad[3:]
        dweights = [None] * len(weights)
        if any(wanted):
            # weight cotangents by torch autograd over the torch-math block
            # (:544-547); every shipped trainer freezes the towers, so the
            # training path never takes this branch
            with torch.enable_grad():
                leaves = [w.detach().requires_grad_(need) for w, need in zip(weights, wanted)]
                out = residual_attention_block(
                    x.detach(), dict(zip(BLOCK_KEYS, leaves)), ctx.n_head, mask
                )
                grads = torch.autograd.grad(
                    out, [w for w, need in zip(leaves, wanted) if need], g
                )
            it = iter(grads)
            dweights = [next(it) if need else None for need in wanted]
        return (dx, None, None, *dweights)


def fused_residual_block(x, p, n_head, mask=None):
    """Drop-in for :func:`ovmr_tpu_torch.ops.layers.residual_attention_block`
    running K1 then K2, differentiable through the dx kernels K4 and K3.
    Under ``torch.no_grad()`` nothing is saved."""
    return _FusedBlock.apply(x, mask, n_head, *(p[k] for k in BLOCK_KEYS))
