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
falls back. The pieces, each with a public wrapper and a plain twin:

- :func:`block_gemm_bwd`, the backward's products with their epilogues
  (``"bias_f32"``: K4's fp32 ``h_pre``; against the transposed weight as it
  is stored, ``"cast"``: K3's ``dattn``, ``"gelu_grad"``: K4's ``dh_pre``,
  ``"f32"``: the fp32 ``dxln`` of both): in bf16/fp16 the wgmma/TMA GEMM of
  ``csrc/gemm_wgmma.cuh`` (K3's QKV recompute is K1's forward product,
  :func:`ovmr_tpu_torch.ops.block_fused.block_gemm`), in fp32 gemm.cuh's
  FMA GEMM.
- :func:`mlp_bwd_dh`, K4's ``"bias_f32"`` and ``"gelu_grad"`` products in
  one launch that keeps the c_fc recompute in registers, so the fp32
  ``h_pre`` never reaches device memory (bf16/fp16; bit-equal to the two
  launches, which fp32 keeps).
- :func:`attn_bwd_core`, K3's attention-backward core, routed by length
  (:func:`attn_bwd_core_route`): one launch per (head, image) for heads of
  up to 128 tokens in bf16/fp16 (the text tower), else the query-tiled pair
  (every length and every dtype; fp32 always). Head widths are multiples of
  8 up to 128; no [L, L] matrix leaves the chip.
- :func:`ln_bwd_plain`, the LayerNorm cotangent plus the residual path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused import (
    _EPI_BIAS,
    _block_gemm,
    _check_block_args,
    _layer_norm,
    _shapes_ok,
)
from ovmr_tpu_torch.ops.layers import matmul_f32, merge_heads, split_heads

# epilogue codes of csrc/block_fused_bwd.cu ovmr_gemm_bwd / ovmr_gemm_wgmma_bwd
# (csrc/gemm.cuh Epilogue): "bias_f32" multiplies by w [K, N], the others by
# the transpose of w stored [N, K]
_BWD_EPILOGUES = {"bias_f32": 3, "cast": 4, "gelu_grad": 5, "f32": 6}
_EPI_BIAS_F32, _EPI_T_CAST, _EPI_T_GELU_GRAD, _EPI_T_F32 = _BWD_EPILOGUES.values()

# the longest head K3's one-launch core takes (its score rows stay in
# registers); longer heads take the query-tiled pair
SHORT_CORE_MAX_L = 128

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


def block_gemm_bwd_plain(a, w, epilogue, bias=None, h_pre=None):
    """The backward halves' products with their epilogues, the kernels'
    rounding: ``"bias_f32"`` the fp32 ``a @ w + bias`` (w ``[K, N]``, the
    bias added in fp32: K4's h_pre); against ``w^T`` (w stored ``[N, K]``):
    ``"cast"`` T(a @ w^T) (K3's dattn), ``"gelu_grad"`` T((a @ w^T) *
    QuickGELU'(h_pre)) with the fp32 ``h_pre [..., N]`` (K4's dh_pre),
    ``"f32"`` the fp32 ``a @ w^T`` (K3's and K4's dxln)."""
    if epilogue == "bias_f32":
        return matmul_f32(a, w) + bias.float()
    acc = matmul_f32(a, w.transpose(-1, -2))
    if epilogue == "f32":
        return acc
    if epilogue == "cast":
        return acc.to(a.dtype)
    if epilogue == "gelu_grad":
        s = torch.sigmoid(1.702 * h_pre)
        return (acc * (s + 1.702 * h_pre * s * (1.0 - s))).to(a.dtype)
    raise ValueError(f"block_gemm_bwd: unknown epilogue {epilogue!r}")


def mlp_bwd_dh_plain(xln, c_fc_w, c_fc_b, g, c_proj_w):
    """K4's dh_pre: ``T((g @ c_proj_w^T) * QuickGELU'(h_pre))`` with the
    recomputed fp32 ``h_pre = xln @ c_fc_w + c_fc_b``, the ``"bias_f32"``
    and ``"gelu_grad"`` products of :func:`block_gemm_bwd_plain`."""
    h_pre = block_gemm_bwd_plain(xln, c_fc_w, "bias_f32", bias=c_fc_b)
    return block_gemm_bwd_plain(g, c_proj_w, "gelu_grad", h_pre=h_pre)


def ln_bwd_plain(x, dxln, g, ln_s):
    """``g + T(LayerNorm input cotangent of the fp32 dxln at x)``, added in
    the activation dtype: the last step of K3 and K4."""
    normed, rstd, gamma = _ln_pieces(x, ln_s)
    return g + _ln_bwd_dx(dxln, normed, rstd, gamma).to(x.dtype)


def attn_bwd_core_route(l: int, dtype: torch.dtype) -> str:
    """Which attention-backward core K3 launches on the card for heads of
    ``l`` tokens: ``"short"`` (one launch; bf16/fp16, at most
    :data:`SHORT_CORE_MAX_L` tokens: the text tower) or ``"tiled"`` (the
    query-tiled pair; longer heads, and fp32 at every length)."""
    return "short" if dtype != torch.float32 and l <= SHORT_CORE_MAX_L else "tiled"


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _gemm_bwd(lib, code, a, w, out, epilogue, stream, bias=None, aux=None):
    """out = epilogue(a @ op(w)): op(w) = w [K, N] for ``_EPI_BIAS_F32``,
    w^T with w stored [N, K] for the ``_EPI_T_*`` epilogues. bf16/fp16 on
    the wgmma/TMA GEMM (counted ``gemm_wgmma``); fp32 on gemm.cuh's FMA
    GEMM (whose sums the fp32 1e-5 gates rest on), dense w and out only."""
    k = a.shape[-1]
    n = w.shape[-1] if epilogue == _EPI_BIAS_F32 else w.shape[0]
    args = (code, a.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
            aux.data_ptr() if aux is not None else None, out.data_ptr(), a.numel() // k, n, k)
    if a.dtype == torch.float32:
        cuda_lib.check(lib, lib.ovmr_gemm_bwd(*args, epilogue, stream), "ovmr_gemm_bwd")
        return
    cuda_lib.check(lib, lib.ovmr_gemm_wgmma_bwd(*args, w.stride(0), out.stride(-2), epilogue,
                                                stream), "ovmr_gemm_wgmma_bwd")
    cuda_lib.count_inner_launch("gemm_wgmma")


def block_gemm_bwd(a, w, epilogue, bias=None, h_pre=None, out=None):
    """One product of the backward halves with its epilogue
    (:func:`block_gemm_bwd_plain`'s function and rounding) for ``a [...,
    K]`` and ``w [K, N]`` (``"bias_f32"``) or ``w [N, K]`` (the others, the
    product with ``w^T``); ``w`` may be a column slice of a wider weight and
    ``out`` a column slice of a wider buffer. ``out`` is fp32 for
    ``"bias_f32"`` and ``"f32"``, else ``a``'s dtype. On the card one launch
    of the wgmma/TMA GEMM, which takes bf16 and fp16."""
    what = "block_gemm_bwd"
    if epilogue not in _BWD_EPILOGUES:
        raise ValueError(f"{what}: unknown epilogue {epilogue!r}")
    if a.device.type == "cpu":
        got = block_gemm_bwd_plain(a, w, epilogue, bias, h_pre)
        if out is None:
            return got
        out.copy_(got)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    cuda_lib.require_no_grad(what, a, w, bias, h_pre, out)
    if a.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{what}: the wgmma GEMM takes bfloat16 or float16, not {a.dtype}")
    trans = epilogue != "bias_f32"
    k = a.shape[-1]
    if w.dim() != 2 or w.shape[1 if trans else 0] != k or w.stride(1) != 1:
        form = f"[N, {k}]" if trans else f"[{k}, N]"
        raise ValueError(f"{what}: w must be {form} with unit column stride")
    n = w.shape[0 if trans else 1]
    if n % 8 or k % 8 or w.stride(0) % 8 or w.stride(0) < w.shape[1]:
        raise ValueError(f"{what}: N, K and w's row stride must be multiples of 8, the row "
                         "stride at least w's row length")
    lead = tuple(a.shape[:-1])
    out_dtype = torch.float32 if epilogue in ("bias_f32", "f32") else a.dtype
    if out is None:
        out = torch.empty(lead + (n,), dtype=out_dtype, device=a.device)
    pair = 2 * out.element_size()  # the epilogue stores column pairs
    rows_even = all(out.stride(i) == out.stride(i + 1) * out.shape[i + 1]
                    for i in range(out.dim() - 2))
    if (tuple(out.shape) != lead + (n,) or out.stride(-1) != 1 or not rows_even
            or (out.dim() > 1 and out.stride(-2) % 2) or out.data_ptr() % pair):
        raise ValueError(f"{what}: out must be {lead + (n,)}, rows an even number of elements "
                         f"apart, unit column stride, {pair}-byte aligned")
    cuda_lib.require_cuda_args(what, a.dtype, a.device, a=a)
    for name, t, dtype in (("w", w, a.dtype), ("out", out, out_dtype), ("bias", bias, a.dtype),
                           ("h_pre", h_pre, torch.float32)):
        if t is not None and (t.device != a.device or t.dtype != dtype):
            raise ValueError(f"{what}: {name} must be {dtype} on {a.device}")
    if w.data_ptr() % 16:
        raise ValueError(f"{what}: w must start on a 16-byte boundary")
    if epilogue != "bias_f32":
        if bias is not None:
            raise ValueError(f"{what}: the {epilogue} epilogue takes no bias")
    elif bias is None or tuple(bias.shape) != (n,) or bias.stride(0) != 1 or bias.data_ptr() % 4:
        raise ValueError(f"{what}: the bias_f32 epilogue needs a bias of shape ({n},), "
                         "unit stride, 4-byte aligned")
    if epilogue != "gelu_grad":
        if h_pre is not None:
            raise ValueError(f"{what}: the {epilogue} epilogue takes no h_pre")
    elif (h_pre is None or tuple(h_pre.shape) != lead + (n,) or not h_pre.is_contiguous()
          or h_pre.data_ptr() % 8):
        raise ValueError(f"{what}: the gelu_grad epilogue needs a contiguous fp32 h_pre "
                         f"{lead + (n,)}, 8-byte aligned")
    with torch.cuda.device(a.device):
        _gemm_bwd(cuda_lib.library("block_fused_bwd"), cuda_lib.dtype_code(a.dtype), a, w, out,
                  _BWD_EPILOGUES[epilogue], cuda_lib.stream_of(a), bias=bias, aux=h_pre)
    return out


def _mlp_bwd_dh(lib, code, xln, c_fc_w, c_fc_b, g, c_proj_w, stream):
    """K4's dh_pre in one wgmma/TMA launch on checked bf16/fp16 arguments
    (counted ``gemm_wgmma``): h_pre stays in the accumulators."""
    m, d = xln.numel() // xln.shape[-1], xln.shape[-1]
    hidden = c_fc_w.shape[-1]
    dh_pre = torch.empty(xln.shape[:-1] + (hidden,), dtype=xln.dtype, device=xln.device)
    cuda_lib.check(lib, lib.ovmr_mlp_bwd_dh(
        code, xln.data_ptr(), c_fc_w.data_ptr(), c_fc_b.data_ptr(), g.data_ptr(),
        c_proj_w.data_ptr(), dh_pre.data_ptr(), m, hidden, d, stream), "ovmr_mlp_bwd_dh")
    cuda_lib.count_inner_launch("gemm_wgmma")
    return dh_pre


def mlp_bwd_dh(xln, c_fc_w, c_fc_b, g, c_proj_w):
    """K4's dh_pre alone (:func:`mlp_bwd_dh_plain`'s function and rounding)
    for ``xln, g [..., D]``, ``c_fc_w [D, hidden]``, ``c_proj_w [hidden,
    D]``: on the card one launch of the wgmma/TMA GEMM holding both
    products' accumulators, bf16 or fp16, every tensor dense."""
    what = "mlp_bwd_dh"
    if xln.device.type == "cpu":
        return mlp_bwd_dh_plain(xln, c_fc_w, c_fc_b, g, c_proj_w)
    if xln.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {xln.device}")
    cuda_lib.require_no_grad(what, xln, c_fc_w, c_fc_b, g, c_proj_w)
    if xln.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{what}: the wgmma GEMM takes bfloat16 or float16, not {xln.dtype}")
    d, hidden = xln.shape[-1], c_fc_w.shape[-1]
    if d % 8 or hidden % 8:
        raise ValueError(f"{what}: width {d} and hidden width {hidden} must be multiples of 8")
    _shapes_ok(what, g=(g, tuple(xln.shape)), c_fc_w=(c_fc_w, (d, hidden)),
               c_fc_b=(c_fc_b, (hidden,)), c_proj_w=(c_proj_w, (hidden, d)))
    cuda_lib.require_cuda_args(what, xln.dtype, xln.device, xln=xln, c_fc_w=c_fc_w,
                               c_fc_b=c_fc_b, g=g, c_proj_w=c_proj_w)
    with torch.cuda.device(xln.device):
        return _mlp_bwd_dh(cuda_lib.library("block_fused_bwd"), cuda_lib.dtype_code(xln.dtype),
                           xln, c_fc_w, c_fc_b, g, c_proj_w, cuda_lib.stream_of(xln))


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


def _attn_bwd_core(lib, code, qkv, dattn, mask, n_head, stream):
    """One run of K3's core on arguments already checked, by the route of
    :func:`attn_bwd_core_route` (counted by route)."""
    b, l, w3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    args = (code, qkv.data_ptr(), dattn.data_ptr(),
            mask.data_ptr() if mask is not None else None, dqkv.data_ptr())
    route = attn_bwd_core_route(l, qkv.dtype)
    if route == "short":
        cuda_lib.check(lib, lib.ovmr_attn_bwd_core_short(*args, b, l, w3 // 3, n_head, stream),
                       "ovmr_attn_bwd_core_short")
    else:
        # each row's max, sum and delta, written by the q-side launch and
        # read by the kv-side one
        stats = torch.empty((b, n_head, 3, -(-l // 128) * 128), dtype=torch.float32,
                            device=qkv.device)
        cuda_lib.check(lib, lib.ovmr_attn_bwd_core(*args, stats.data_ptr(), b, l, w3 // 3,
                                                   n_head, stream), "ovmr_attn_bwd_core")
    cuda_lib.count_inner_launch("attn_bwd_core_" + route)
    return dqkv


def attn_bwd_core(qkv, dattn, mask: Optional[torch.Tensor] = None, n_head: int = 12):
    """K3's attention-backward core alone: ``dqkv`` from the packed ``qkv
    [B, L, 3W]`` and the head-merged cotangent ``dattn [B, L, W]``,
    :func:`attn_bwd_core_plain`'s function and rounding. On the card the
    route of :func:`attn_bwd_core_route`; the head width ``W / n_head`` must
    be a multiple of 8 and at most 128, the mask fp32 ``[L, L]``."""
    what = "attn_bwd_core"
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{what}: qkv must be [B, L, 3W], got {tuple(qkv.shape)}")
    b, l, w3 = qkv.shape
    w = w3 // 3
    if tuple(dattn.shape) != (b, l, w):
        raise ValueError(f"{what}: dattn has shape {tuple(dattn.shape)}, expected {(b, l, w)}")
    if n_head <= 0 or w % n_head:
        raise ValueError(f"{what}: width {w} does not split into {n_head} heads")
    if mask is not None and tuple(mask.shape) != (l, l):
        raise ValueError(f"{what}: mask must be [{l}, {l}], got {tuple(mask.shape)}")
    if qkv.device.type == "cpu":
        return attn_bwd_core_plain(qkv, dattn, mask, n_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qkv.device}")
    cuda_lib.require_no_grad(what, qkv, dattn, mask)
    code = cuda_lib.dtype_code(qkv.dtype)
    cuda_lib.require_cuda_args(what, qkv.dtype, qkv.device, qkv=qkv, dattn=dattn)
    if (w // n_head) % 8 or w // n_head > 128:
        raise ValueError(f"{what}: head width {w // n_head} must be a multiple of 8 up to 128")
    if b > 65535 or n_head > 65535:  # the grids' z (y) and y (x) limits
        raise ValueError(f"{what}: {b} sequences x {n_head} heads is too many for one launch")
    if mask is not None and (mask.dtype != torch.float32 or mask.device != qkv.device
                             or not mask.is_contiguous()):
        raise ValueError(f"{what}: mask must be fp32, contiguous on {qkv.device}")
    with torch.cuda.device(qkv.device):
        return _attn_bwd_core(cuda_lib.library("block_fused_bwd"), code, qkv, dattn, mask,
                              n_head, cuda_lib.stream_of(qkv))


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
        if y.dtype == torch.float32:
            h_pre = torch.empty((b, l, hidden), dtype=torch.float32, device=y.device)
            _gemm_bwd(lib, code, xln, c_fc_w, h_pre, _EPI_BIAS_F32, stream, bias=c_fc_b)
            dh_pre = torch.empty((b, l, hidden), dtype=y.dtype, device=y.device)
            _gemm_bwd(lib, code, g, c_proj_w, dh_pre, _EPI_T_GELU_GRAD, stream, aux=h_pre)
        else:  # the c_fc recompute stays in registers
            dh_pre = _mlp_bwd_dh(lib, code, xln, c_fc_w, c_fc_b, g, c_proj_w, stream)
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
        _block_gemm(fwd, code, xln, w_qkv, b_qkv, qkv, _EPI_BIAS, stream)  # K1's launch
        dattn = torch.empty_like(x)
        _gemm_bwd(lib, code, g, w_out, dattn, _EPI_T_CAST, stream)
        dqkv = _attn_bwd_core(lib, code, qkv, dattn, mask, n_head, stream)
        dxln = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
        _gemm_bwd(lib, code, dqkv, w_qkv, dxln, _EPI_T_F32, stream)
        out = _ln_bwd(lib, code, x, dxln, g, ln_s, stream)
    cuda_lib.count_launch(what + "_masked" if mask is not None else what, x)
    return out
