"""Input cotangents (dx) of the two block halves, as hand-written Hopper kernels.

PyTorch counterpart of ``ovmr_tpu/ops/block_fused_bwd.py``:

- **K4** :func:`mlp_half_bwd_dx` (TPU: ``_mlp_bwd_dx_kernel`` :57): d/dy of
  ``y + c_proj(QuickGELU(c_fc(LN2(y))))`` applied to the cotangent g.
- **K3** :func:`attn_half_bwd_dx` (TPU: ``_attn_bwd_dx_kernel`` :128, masked
  :219): d/dx of ``x + proj(attention(LN1(x)))`` applied to g, with an
  optional additive fp32 ``[L, L]`` mask (causal in the text tower).

**dx only**: every OVMR trainer freezes the CLIP towers, gradients flow
through the text tower into the prompt embeddings, and the weight
cotangents are never needed on that path
(:class:`ovmr_tpu_torch.ops.block_fused._FusedBlock` makes them by torch
autograd on the day a tower weight requires grad).

Each kernel recomputes its half's forward intermediates from the half's
input. The plain twins (``*_plain``) follow the TPU bodies step by step
with the same casts: fp32 LN pieces, the LN output cast, ``h_pre`` kept in
fp32 (unlike the forward's hidden), ``dh_pre`` cast after the fp32
QuickGELU' product, ``dattn`` cast, fp32 scores/softmax/dP, ``ds`` cast
after the scale, probs cast for dv, dq/dk/dv cast per head, ``dxln`` kept
in fp32, and the LN cotangent cast before it is added to g in the
activation dtype. They are not ``torch.autograd.grad`` of the forward
twins, which round elsewhere in bf16.

A wrapper takes its plain twin for a tensor on the CPU and launches the
kernels of ``csrc/block_fused_bwd.cu`` (plus the forward's LayerNorm and
QKV GEMM of ``csrc/block_fused.cu``) for a tensor on a CUDA card; it never
falls back. K3's attention-backward core takes every sequence length and
every head width that is a multiple of 8 up to 128: it is tiled over the
queries, two launches that recompute the scores from the packed qkv, so no
[L, L] matrix is kept (tensor cores in bf16/fp16, plain FMA in fp32).
"""

from __future__ import annotations

from typing import Optional

import torch

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused import (
    _EPI_BIAS,
    _check_block_args,
    _gemm,
    _layer_norm,
    _shapes_ok,
)
from ovmr_tpu_torch.ops.layers import matmul_f32, merge_heads, split_heads

# epilogue codes of csrc/block_fused_bwd.cu ovmr_gemm_bwd
_EPI_BIAS_F32, _EPI_T_CAST, _EPI_T_GELU_GRAD, _EPI_T_F32 = 3, 4, 5, 6

# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------

def _ln_pieces(x, ln_s, eps: float = 1e-5):
    """fp32 (normed, rstd, gamma) of LayerNorm (``_ln_pieces`` :38)."""
    xf = x.float()
    centered = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(centered.square().mean(dim=-1, keepdim=True) + eps)
    return centered * rstd, rstd, ln_s.float()


def _ln_bwd_dx(dxln, normed, rstd, gamma):
    """Input cotangent of ``normed * gamma + beta`` in fp32 (``_ln_bwd_dx`` :49)."""
    dnormed = dxln * gamma
    m1 = dnormed.mean(dim=-1, keepdim=True)
    m2 = (dnormed * normed).mean(dim=-1, keepdim=True)
    return rstd * (dnormed - m1 - normed * m2)


def mlp_half_bwd_dx_plain(y, g, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b):
    """K4's arithmetic in PyTorch for y, g [B, L, D]."""
    dtype = y.dtype
    normed, rstd, gamma = _ln_pieces(y, ln_s)
    xln = (normed * gamma + ln_b.float()).to(dtype)
    h_pre = matmul_f32(xln, c_fc_w) + c_fc_b.float()
    s = torch.sigmoid(1.702 * h_pre)
    dh = matmul_f32(g.to(dtype), c_proj_w.transpose(-1, -2))
    dh_pre = dh * (s + 1.702 * h_pre * s * (1.0 - s))
    dxln = matmul_f32(dh_pre.to(dtype), c_fc_w.transpose(-1, -2))
    return g + _ln_bwd_dx(dxln, normed, rstd, gamma).to(dtype)


def attn_half_bwd_dx_plain(
    x, g, w_qkv, b_qkv, w_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 12,
):
    """K3's arithmetic in PyTorch for x, g [B, L, D]."""
    dtype = x.dtype
    normed, rstd, gamma = _ln_pieces(x, ln_s)
    xln = (normed * gamma + ln_b.float()).to(dtype)
    qkv = (matmul_f32(xln, w_qkv) + b_qkv.float()).to(dtype)
    dattn = matmul_f32(g.to(dtype), w_out.transpose(-1, -2)).to(dtype)
    dqkv = attn_bwd_core_plain(qkv, dattn, mask, n_head)
    dxln = matmul_f32(dqkv, w_qkv.transpose(-1, -2))
    return g + _ln_bwd_dx(dxln, normed, rstd, gamma).to(dtype)


def attn_bwd_core_plain(qkv, dattn, mask: Optional[torch.Tensor] = None, n_head: int = 12):
    """K3's attention-backward core for ``qkv [B, L, 3D]`` (the forward's
    packing) and the head-merged cotangent ``dattn [B, L, D]``: ``dqkv`` in
    the same packing. fp32 scores, softmax and dP; ``ds`` cast after the
    scale; probs cast for dv; dq, dk, dv cast per head."""
    dtype = qkv.dtype
    scale = (qkv.shape[-1] // 3 // n_head) ** -0.5
    q, k, v = (split_heads(t, n_head) for t in qkv.chunk(3, dim=-1))
    do = split_heads(dattn, n_head)
    scores = matmul_f32(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    dp = matmul_f32(do, v.transpose(-1, -2))
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dtype)
    dq = matmul_f32(ds, k).to(dtype)
    dk = matmul_f32(ds.transpose(-1, -2), q).to(dtype)
    dv = matmul_f32(probs.to(dtype).transpose(-1, -2), do).to(dtype)
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _gemm_bwd(lib, code, a, w, out, epilogue, stream, bias=None, aux=None):
    """out = epilogue(a @ op(w)): op(w) = w [K, N] for ``_EPI_BIAS_F32``,
    w^T with w stored [N, K] for the ``_EPI_T_*`` epilogues."""
    k = a.shape[-1]
    n = w.shape[-1] if epilogue == _EPI_BIAS_F32 else w.shape[0]
    cuda_lib.check(
        lib,
        lib.ovmr_gemm_bwd(
            code, a.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            aux.data_ptr() if aux is not None else None,
            out.data_ptr(), a.numel() // k, n, k, epilogue, stream,
        ),
        "ovmr_gemm_bwd",
    )


def _ln_bwd(lib, code, x, dxln, g, ln_s, stream):
    """g + T(LayerNorm input cotangent of the fp32 dxln at x)."""
    out = torch.empty_like(x)
    cuda_lib.check(
        lib,
        lib.ovmr_ln_bwd(code, x.data_ptr(), dxln.data_ptr(), g.data_ptr(), ln_s.data_ptr(),
                        out.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], stream),
        "ovmr_ln_bwd",
    )
    return out


def _check_cotangent(what, x, g):
    if g.shape != x.shape:
        raise ValueError(f"{what}: g has shape {tuple(g.shape)}, expected {tuple(x.shape)}")
    cuda_lib.require_cuda_args(what, x.dtype, x.device, g=g)


def mlp_half_bwd_dx(y, g, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b):
    """K4: the MLP half's input cotangent for y, g [B, L, D]."""
    if y.device.type == "cpu":
        return mlp_half_bwd_dx_plain(y, g, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b)
    if y.device.type != "cuda":
        raise ValueError(f"mlp_half_bwd_dx: no kernel for device {y.device}")
    what = "mlp_half_bwd_dx"
    cuda_lib.require_no_grad(what, y, g, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b)
    b, l, d = y.shape
    hidden = c_fc_w.shape[-1]
    _check_block_args(
        what, y,
        dict(c_fc_w=c_fc_w, c_fc_b=c_fc_b, c_proj_w=c_proj_w, ln_s=ln_s, ln_b=ln_b),
    )
    _check_cotangent(what, y, g)
    if hidden % 8:
        raise ValueError(f"{what}: hidden width {hidden} must be a multiple of 8")
    _shapes_ok(
        what, c_fc_w=(c_fc_w, (d, hidden)), c_fc_b=(c_fc_b, (hidden,)),
        c_proj_w=(c_proj_w, (hidden, d)), ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )
    fwd = cuda_lib.library("block_fused")
    lib = cuda_lib.library("block_fused_bwd")
    code = cuda_lib.dtype_code(y.dtype)
    with torch.cuda.device(y.device):
        stream = cuda_lib.stream_of(y)
        xln = _layer_norm(fwd, code, y, ln_s, ln_b, stream)
        h_pre = torch.empty((b, l, hidden), dtype=torch.float32, device=y.device)
        _gemm_bwd(lib, code, xln, c_fc_w, h_pre, _EPI_BIAS_F32, stream, bias=c_fc_b)
        dh_pre = torch.empty((b, l, hidden), dtype=y.dtype, device=y.device)
        _gemm_bwd(lib, code, g, c_proj_w, dh_pre, _EPI_T_GELU_GRAD, stream, aux=h_pre)
        dxln = torch.empty((b, l, d), dtype=torch.float32, device=y.device)
        _gemm_bwd(lib, code, dh_pre, c_fc_w, dxln, _EPI_T_F32, stream)
        out = _ln_bwd(lib, code, y, dxln, g, ln_s, stream)
    cuda_lib.count_launch(what, y)
    return out


def attn_half_bwd_dx(
    x, g, w_qkv, b_qkv, w_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 12,
):
    """K3: the attention half's input cotangent for x, g [B, L, D]."""
    if x.device.type == "cpu":
        return attn_half_bwd_dx_plain(
            x, g, w_qkv, b_qkv, w_out, ln_s, ln_b, mask=mask, n_head=n_head
        )
    if x.device.type != "cuda":
        raise ValueError(f"attn_half_bwd_dx: no kernel for device {x.device}")
    what = "attn_half_bwd_dx"
    cuda_lib.require_no_grad(what, x, g, w_qkv, b_qkv, w_out, ln_s, ln_b)
    b, l, d = x.shape
    _check_block_args(
        what, x, dict(w_qkv=w_qkv, b_qkv=b_qkv, w_out=w_out, ln_s=ln_s, ln_b=ln_b),
        mask=mask, n_head=n_head,
    )
    _check_cotangent(what, x, g)
    _shapes_ok(
        what, w_qkv=(w_qkv, (d, 3 * d)), b_qkv=(b_qkv, (3 * d,)), w_out=(w_out, (d, d)),
        ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )
    if b > 65535 or n_head > 65535:  # the core's grid z and y limits
        raise ValueError(f"{what}: {b} sequences x {n_head} heads is too many for one launch")
    if d // n_head > 128:
        raise ValueError(
            f"{what}: head width {d // n_head} exceeds the attention-backward core's 128"
        )
    fwd = cuda_lib.library("block_fused")
    lib = cuda_lib.library("block_fused_bwd")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(fwd, code, x, ln_s, ln_b, stream)
        qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
        _gemm(fwd, code, xln, w_qkv, b_qkv, qkv, _EPI_BIAS, stream)
        dattn = torch.empty_like(x)
        _gemm_bwd(lib, code, g, w_out, dattn, _EPI_T_CAST, stream)
        dqkv = torch.empty_like(qkv)
        # each row's max, sum and delta, written by the tiled core's q-side
        # launch and read by its kv-side one
        stats = torch.empty((b, n_head, 3, -(-l // 128) * 128), dtype=torch.float32,
                            device=x.device)
        cuda_lib.check(
            lib,
            lib.ovmr_attn_bwd_core(
                code, qkv.data_ptr(), dattn.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                dqkv.data_ptr(), stats.data_ptr(), b, l, d, n_head, stream,
            ),
            "ovmr_attn_bwd_core",
        )
        dxln = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
        _gemm_bwd(lib, code, dqkv, w_qkv, dxln, _EPI_T_F32, stream)
        out = _ln_bwd(lib, code, x, dxln, g, ln_s, stream)
    cuda_lib.count_launch(what + "_masked" if mask is not None else what, x)
    return out
