"""The two halves of the CLIP residual block, as hand-written Hopper kernels.

PyTorch counterpart of ``ovmr_tpu/ops/block_fused.py``:

- **K1** :func:`fused_attn_half` (TPU: ``_attn_half_kernel`` :58 and
  ``_masked_attn_half_kernel`` :113): ``x + out_proj(MHA(LN1(x)))`` with a
  packed ``[D, 3D]`` QKV weight and an optional additive fp32 ``[L, L]``
  mask (causal in the text tower).
- **K2** :func:`fused_mlp_half` (TPU: ``_mlp_half_kernel`` :123):
  ``x + c_proj(QuickGELU(c_fc(LN2(x))))``.
- **K5** :func:`fused_mlp_half_chunked` (TPU: ``_mlp_half_chunked_kernel``
  :249): the same half with the hidden width taken in ``chunks`` slices;
  each slice's partial ``c_proj`` product is cast and added to the output
  in the activation dtype, so in bf16 it differs from K2 by that rounding.

- :func:`fused_residual_block`, the differentiable block (TPU:
  ``_fused_block`` :483-558): K1, then K2 or K5 as :func:`mlp_tier_chunks`
  routes the tower (K5 only for ViT-L/14@336px's vision tower), forward; the
  backward runs the dx kernels K4 then K3 of
  :mod:`ovmr_tpu_torch.ops.block_fused_bwd` on the saved block input and
  attention-half output, after K2 and after K5 alike (K5's chunked rounding
  does not change the function that dx differentiates).

Each wrapper takes its plain PyTorch version (``*_plain``, built from
:mod:`ovmr_tpu_torch.ops.layers`) for a tensor on the CPU and launches the
CUDA kernels of ``csrc/block_fused.cu`` for a tensor on a CUDA card; it
never falls back from one to the other. A raw wrapper (``fused_attn_half``,
``fused_mlp_half``) records no autograd graph, so on the card it raises for
a tensor that requires grad; gradients go through
:func:`fused_residual_block`. The plain versions round where
the kernels round (``block_fused.py:68-149``, ``:249-283``): LN output cast
before the product, qkv cast after its bias, scores scaled after the fp32
product, probs and each head's output cast, the projection cast before the
residual add, QuickGELU in fp32 then cast, K5's partial products cast
before each add.

- :func:`attn_core`, the attention core K1 and K7
  (:mod:`ovmr_tpu_torch.ops.block_fused_tp`) launch between their
  projections: per head ``T(softmax(q k^T * Dh^-0.5 + mask) . v)`` from a
  packed ``qkv [B, L, 3W]`` into ``[B, L, W]``, probs normalised in fp32
  and then cast. In bf16/fp16 one register-resident tensor-core kernel
  takes every length and head width (a multiple of 8 up to 128), walking
  the keys in tiles in two passes that keep K1's rounding.
- :func:`block_gemm`, one product of K1, K2, K5, K7 or K8 (or K3's
  recompute of K1's QKV) with its epilogue
  (bias, QuickGELU, residual, fp32 out, accumulate): in bf16/fp16 the
  wgmma/TMA GEMM of ``csrc/gemm_wgmma.cuh``, in fp32 gemm.cuh's FMA GEMM.

Of the TPU module's VMEM residency routing only the MLP tier is kept
(:func:`mlp_tier_chunks`), so that each configuration runs the counterpart
of the kernel it runs there; batch tiles (``_g_limits``) and the XLA
fallbacks (``_block_flavor``) have no counterpart: on CUDA every dtype
(fp32, bf16, fp16) and every width that is a multiple of 8 runs the
kernels. The source note in ``csrc/block_fused.cu`` says what bounds them
and how they are built.
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

# epilogue codes of csrc/block_fused.cu ovmr_gemm (csrc/gemm.cuh Epilogue)
_EPI_BIAS, _EPI_BIAS_GELU, _EPI_BIAS_RESIDUAL, _EPI_F32, _EPI_ACCUM = 0, 1, 2, 6, 7

# The MLP tier of the TPU module's forward routing (``_fused_block_fwd_impl``
# :441-477), in bytes of bf16 weights and activations: the MLP weights stay
# resident up to _MLP_W_CUTOFF, and up to _MLP_W_RESIDENT_FWD where two
# images' padded tokens fit the x-tile envelope _TILE_X_BYTES; beyond that
# they stream in hidden chunks of at most 8 MiB.
_MLP_W_CUTOFF = 10 * 1024 * 1024
_MLP_W_RESIDENT_FWD = 18 * 1024 * 1024
_TILE_X_BYTES = 16 * 80 * 512 * 2
_MLP_CHUNK_BYTES = 8 * 1024 * 1024


def _tile_token_limit(l: int, d: int) -> int:
    """bf16 images per tile within the padded x-tile envelope (``:367-370``)."""
    l_pad = -8 * (-l // 8)
    return max(1, _TILE_X_BYTES // (l_pad * d * 2))


def mlp_tier_chunks(l: int, d: int, hidden: int) -> int:
    """Which MLP half a tower of ``l`` tokens, width ``d`` and ``hidden``
    takes: 0 for K2 (:func:`fused_mlp_half`), else the number of hidden
    chunks K5 (:func:`fused_mlp_half_chunked`) streams.

    The thresholds are the TPU's VMEM envelope, not the card's: they are kept
    so that each configuration runs the counterpart of the kernel the JAX
    package runs for it (only ViT-L/14@336px's vision tower, 577 tokens x
    1024 with 16.8 MB of MLP weights, takes K5, in 2 chunks). The decision
    is made on the 2-byte sizes those thresholds were measured at, whatever
    the tensor's dtype, so an fp32 check of a path runs the same kernels as
    the bf16 path it checks."""
    mlp_w = 2 * d * hidden * 2  # c_fc_w and c_proj_w in bf16
    if mlp_w <= _MLP_W_CUTOFF:
        return 0
    if mlp_w <= _MLP_W_RESIDENT_FWD and _tile_token_limit(l, d) >= 2:
        return 0
    return max(2, -(-mlp_w // _MLP_CHUNK_BYTES))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def fused_attn_half_plain(
    x, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 12,
):
    """x + proj(attention(LN1(x))) for x [B, L, D], K1's rounding."""
    qkv = dense(layer_norm(x, ln_s, ln_b), w_qkv, b_qkv)
    return x + dense(attn_core_plain(qkv, mask, n_head), w_out, b_out)


def attn_core_plain(qkv, mask: Optional[torch.Tensor] = None, n_head: int = 12):
    """Heads ``[B, L, W]`` from a packed ``qkv [B, L, 3W]`` (head h's q, k
    and v at columns ``h Dh``, ``W + h Dh``, ``2W + h Dh``), K1's rounding:
    fp32 scores scaled after the product, the fp32 mask added, an fp32
    softmax whose normalised probs are cast before the fp32-accumulated
    probs x V, each head's output cast."""
    dtype = qkv.dtype
    q, k, v = (split_heads(t, n_head) for t in qkv.chunk(3, dim=-1))
    scores = matmul_f32(q, k.transpose(-1, -2)) * (qkv.shape[-1] // 3 // n_head) ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return merge_heads(matmul_f32(probs.to(dtype), v).to(dtype))


def fused_mlp_half_plain(x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b):
    """x + c_proj(QuickGELU(c_fc(LN2(x)))) for x [B, L, D], K2's rounding
    (QuickGELU in fp32, then cast)."""
    h = matmul_f32(layer_norm(x, ln_s, ln_b), c_fc_w) + c_fc_b.float()
    h = (h * torch.sigmoid(1.702 * h)).to(x.dtype)
    return x + dense(h, c_proj_w, c_proj_b)


def block_gemm_plain(a, w, bias=None, epilogue="gelu", resid=None, out=None):
    """The block halves' products with their epilogues, the kernels'
    rounding: ``"bias"`` T(a @ w + bias) with the bias added in fp32;
    ``"gelu"`` T(QuickGELU(a @ w + bias)) with QuickGELU in fp32;
    ``"residual"`` resid + T(a @ w + bias) added in the activation dtype;
    ``"f32"`` the fp32 sum a @ w, uncast; ``"accum"`` out + T(a @ w) added
    in the activation dtype (a new tensor; the kernel updates ``out`` in
    place)."""
    acc = matmul_f32(a, w)
    if epilogue == "bias":
        return (acc + bias.float()).to(a.dtype)
    if epilogue == "f32":
        return acc
    if epilogue == "gelu":
        h = acc + bias.float()
        return (h * torch.sigmoid(1.702 * h)).to(a.dtype)
    if epilogue == "residual":
        return resid + (acc + bias.float()).to(a.dtype)
    if epilogue == "accum":
        return out + acc.to(a.dtype)
    raise ValueError(f"block_gemm: unknown epilogue {epilogue!r}")


def _chunk_width(hidden: int, chunks: int) -> int:
    """``chunks`` raised until it divides ``hidden`` (``:300-302``)."""
    while hidden % chunks:
        chunks += 1
    return hidden // chunks


def fused_mlp_half_chunked_plain(
    x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b, chunks: int = 4
):
    """K5's arithmetic step by step (``:249-283``): the output starts as
    ``x + c_proj_b`` and each hidden chunk's partial c_proj product is cast
    to the activation dtype and added there; the partials are never summed
    in fp32, which is K5's one difference from K2."""
    dtype = x.dtype
    hc = _chunk_width(c_fc_w.shape[-1], chunks)
    xln = layer_norm(x, ln_s, ln_b)
    out = x + c_proj_b.float().to(dtype)
    for j in range(0, c_fc_w.shape[-1], hc):
        h = matmul_f32(xln, c_fc_w[:, j : j + hc]) + c_fc_b[j : j + hc].float()
        h = (h * torch.sigmoid(1.702 * h)).to(dtype)
        out = out + matmul_f32(h, c_proj_w[j : j + hc]).to(dtype)
    return out


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
    """out = epilogue(a @ w + bias) on gemm.cuh's fp32 FMA kernel, for a
    [..., K] and w [K, N]; w may be a column slice of a wider matrix, and
    out a column slice of a wider buffer (their row strides are handed
    on). Every fp32 product of the forward halves runs here, through
    :func:`_block_gemm`."""
    cuda_lib.check(
        lib,
        lib.ovmr_gemm(
            code, a.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
            resid.data_ptr() if resid is not None else None, out.data_ptr(),
            a.numel() // a.shape[-1], w.shape[-1], a.shape[-1], w.stride(0), out.stride(-2),
            epilogue, stream,
        ),
        "ovmr_gemm",
    )


_BLOCK_EPILOGUES = {"bias": _EPI_BIAS, "gelu": _EPI_BIAS_GELU, "residual": _EPI_BIAS_RESIDUAL,
                    "f32": _EPI_F32, "accum": _EPI_ACCUM}


def _block_gemm(lib, code, a, w, bias, out, epilogue, stream, resid=None):
    """The products of K1, K2, K5, K7 and K8 (and K3's recompute of K1's
    QKV): the wgmma/TMA GEMM (``csrc/gemm_wgmma.cuh``) in bf16/fp16,
    gemm.cuh's FMA GEMM in fp32 (whose sums the fp32 1e-5 gates rest on)."""
    if a.dtype == torch.float32:
        _gemm(lib, code, a, w, bias, out, epilogue, stream, resid=resid)
        return
    cuda_lib.check(
        lib,
        lib.ovmr_gemm_wgmma(
            code, a.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
            resid.data_ptr() if resid is not None else None, out.data_ptr(),
            a.numel() // a.shape[-1], w.shape[-1], a.shape[-1], w.stride(0), out.stride(-2),
            epilogue, stream,
        ),
        "ovmr_gemm_wgmma",
    )
    cuda_lib.count_inner_launch("gemm_wgmma")


def block_gemm(a, w, bias=None, epilogue="gelu", resid=None, out=None):
    """One product of the block halves with its epilogue
    (:func:`block_gemm_plain`'s function and rounding) for ``a [..., K]``
    and ``w [K, N]``; ``w`` may be a column slice of a wider weight and
    ``out`` (written for ``"bias"``/``"gelu"``/``"residual"``/``"f32"``,
    updated for ``"accum"``) a column slice of a wider buffer. ``out`` is
    fp32 for ``"f32"``, else ``a``'s dtype. On the card one launch of the
    wgmma/TMA GEMM that K1-K5, K7 and K8 run, which takes bf16 and fp16
    (the backward's epilogues: :func:`ovmr_tpu_torch.ops.block_fused_bwd.block_gemm_bwd`)."""
    what = "block_gemm"
    if epilogue not in _BLOCK_EPILOGUES:
        raise ValueError(f"{what}: unknown epilogue {epilogue!r}")
    if a.device.type == "cpu":
        got = block_gemm_plain(a, w, bias, epilogue, resid, out)
        if out is None:
            return got
        out.copy_(got)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    cuda_lib.require_no_grad(what, a, w, bias, resid, out)
    if a.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{what}: the wgmma GEMM takes bfloat16 or float16, not {a.dtype}")
    k, n = a.shape[-1], w.shape[-1]
    if w.dim() != 2 or w.shape[0] != k or w.stride(1) != 1:
        raise ValueError(f"{what}: w must be [{k}, N] with unit column stride")
    if n % 8 or k % 8 or w.stride(0) % 8:
        raise ValueError(f"{what}: N, K and w's row stride must be multiples of 8")
    lead = tuple(a.shape[:-1])
    out_dtype = torch.float32 if epilogue == "f32" else a.dtype
    if out is None:
        if epilogue == "accum":
            raise ValueError(f"{what}: the accum epilogue adds to out, which is missing")
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
                           ("resid", resid, a.dtype)):
        if t is not None and (t.device != a.device or t.dtype != dtype):
            raise ValueError(f"{what}: {name} must be {dtype} on {a.device}")
    if w.data_ptr() % 16:
        raise ValueError(f"{what}: w must start on a 16-byte boundary")
    if epilogue in ("f32", "accum"):
        if bias is not None:
            raise ValueError(f"{what}: the {epilogue} epilogue takes no bias")
    elif bias is None or tuple(bias.shape) != (n,) or bias.stride(0) != 1 or bias.data_ptr() % 4:
        raise ValueError(f"{what}: the {epilogue} epilogue needs a bias of shape ({n},), "
                         "unit stride, 4-byte aligned")
    if epilogue == "residual" and (resid is None or tuple(resid.shape) != lead + (n,)
                                   or not resid.is_contiguous() or resid.data_ptr() % 4):
        raise ValueError(f"{what}: the residual epilogue needs a contiguous resid {lead + (n,)}, "
                         "4-byte aligned")
    with torch.cuda.device(a.device):
        _block_gemm(cuda_lib.library("block_fused"), cuda_lib.dtype_code(a.dtype), a, w, bias,
                    out, _BLOCK_EPILOGUES[epilogue], cuda_lib.stream_of(a), resid=resid)
    return out


def attn_core(qkv, mask: Optional[torch.Tensor] = None, n_head: int = 12):
    """The attention core of K1 and K7: heads ``[B, L, W]`` from a packed
    ``qkv [B, L, 3W]``, :func:`attn_core_plain`'s function and rounding.
    On the card one launch of ``ovmr_attn_core``; the head width ``W /
    n_head`` must be a multiple of 8 and at most 128, the mask fp32
    ``[L, L]``."""
    what = "attn_core"
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{what}: qkv must be [B, L, 3W], got {tuple(qkv.shape)}")
    b, l, w3 = qkv.shape
    w = w3 // 3
    if n_head <= 0 or w % n_head:
        raise ValueError(f"{what}: width {w} does not split into {n_head} heads")
    if mask is not None and tuple(mask.shape) != (l, l):
        raise ValueError(f"{what}: mask must be [{l}, {l}], got {tuple(mask.shape)}")
    if qkv.device.type == "cpu":
        return attn_core_plain(qkv, mask, n_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qkv.device}")
    cuda_lib.require_no_grad(what, qkv, mask)
    code = cuda_lib.dtype_code(qkv.dtype)
    cuda_lib.require_cuda_args(what, qkv.dtype, qkv.device, qkv=qkv)
    if (w // n_head) % 8:
        raise ValueError(f"{what}: head width {w}/{n_head} must be a whole multiple of 8")
    if w // n_head > 128:
        raise ValueError(f"{what}: head width {w // n_head} exceeds the attention core's 128")
    if b > 65535 or n_head > 65535:  # the grid's z and y limits
        raise ValueError(f"{what}: {b} images x {n_head} heads is too many for one launch")
    if mask is not None:
        if mask.dtype != torch.float32:
            raise ValueError(f"{what}: mask must be fp32, got {mask.dtype}")
        if mask.device != qkv.device or not mask.is_contiguous():
            raise ValueError(f"{what}: mask must be contiguous on {qkv.device}")
    with torch.cuda.device(qkv.device):
        return _attn_core(cuda_lib.library("block_fused"), code, qkv, mask, n_head,
                          cuda_lib.stream_of(qkv))


def _attn_core(lib, code, qkv, mask, n_head, stream):
    """One launch of the core on arguments already checked: by
    :func:`attn_core`, or by K1's and K7's wrappers, whose short text-tower
    launches are host-bound and would pay the checks twice."""
    b, l, w3 = qkv.shape
    heads = torch.empty((b, l, w3 // 3), dtype=qkv.dtype, device=qkv.device)
    cuda_lib.check(
        lib,
        lib.ovmr_attn_core(
            code, qkv.data_ptr(), mask.data_ptr() if mask is not None else None,
            heads.data_ptr(), b, l, w3 // 3, n_head, stream,
        ),
        "ovmr_attn_core",
    )
    cuda_lib.count_launch("attn_core", qkv, shape=(b, l, w3 // 3, n_head))
    return heads


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
    if d // n_head > 128:
        # the attention core keeps a warp's 16 x head-width output tile in
        # its fp32 accumulators (64 registers a thread at 128); the sequence
        # length is free
        raise ValueError(f"{what}: head width {d // n_head} exceeds the attention core's 128")
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
        _block_gemm(lib, code, xln, w_qkv, b_qkv, qkv, _EPI_BIAS, stream)
        heads = _attn_core(lib, code, qkv, mask, n_head, stream)
        out = torch.empty_like(x)
        _block_gemm(lib, code, heads, w_out, b_out, out, _EPI_BIAS_RESIDUAL, stream, resid=x)
    cuda_lib.count_launch("fused_attn_half_masked" if mask is not None else "fused_attn_half", x)
    return out


def _check_mlp_args(what, x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b):
    """What K2 and K5 ask of their arguments on the card."""
    cuda_lib.require_no_grad(what, x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b)
    _check_block_args(
        what, x,
        dict(c_fc_w=c_fc_w, c_fc_b=c_fc_b, c_proj_w=c_proj_w, c_proj_b=c_proj_b,
             ln_s=ln_s, ln_b=ln_b),
    )
    d, hidden = x.shape[-1], c_fc_w.shape[-1]
    if hidden % 8:
        raise ValueError(f"{what}: hidden width {hidden} must be a multiple of 8")
    _shapes_ok(
        what, c_fc_w=(c_fc_w, (d, hidden)), c_fc_b=(c_fc_b, (hidden,)),
        c_proj_w=(c_proj_w, (hidden, d)), c_proj_b=(c_proj_b, (d,)),
        ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )


def fused_mlp_half(x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b):
    """K2: x + c_proj(QuickGELU(c_fc(LN2(x)))) for x [B, L, D]."""
    if x.device.type == "cpu":
        return fused_mlp_half_plain(x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_half: no kernel for device {x.device}")
    _check_mlp_args("fused_mlp_half", x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b)
    b, l, _ = x.shape
    hidden = c_fc_w.shape[-1]
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        h = torch.empty((b, l, hidden), dtype=x.dtype, device=x.device)
        _block_gemm(lib, code, xln, c_fc_w, c_fc_b, h, _EPI_BIAS_GELU, stream)
        out = torch.empty_like(x)
        _block_gemm(lib, code, h, c_proj_w, c_proj_b, out, _EPI_BIAS_RESIDUAL, stream, resid=x)
    cuda_lib.count_launch("fused_mlp_half", x)
    return out


def fused_mlp_half_chunked(
    x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b, chunks: int = 4
):
    """K5: K2's function with the hidden width taken in ``chunks`` slices
    (raised until it divides the hidden width), the partial c_proj products
    cast and added in the activation dtype. The hidden buffer is
    ``[B, L, hidden / chunks]``; the weight slices are read in place."""
    if x.device.type == "cpu":
        return fused_mlp_half_chunked_plain(
            x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b, chunks=chunks
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_half_chunked: no kernel for device {x.device}")
    what = "fused_mlp_half_chunked"
    _check_mlp_args(what, x, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_s, ln_b)
    b, l, d = x.shape
    hidden = c_fc_w.shape[-1]
    hc = _chunk_width(hidden, chunks)
    if hc % 8:  # a column slice must start on a 16-byte boundary
        raise ValueError(f"{what}: chunk width {hc} must be a multiple of 8")
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        out = torch.empty_like(x)
        cuda_lib.check(
            lib,
            lib.ovmr_residual_bias(code, x.data_ptr(), c_proj_b.data_ptr(), out.data_ptr(),
                                   b * l, d, stream),
            "ovmr_residual_bias",
        )
        h = torch.empty((b, l, hc), dtype=x.dtype, device=x.device)
        for j in range(0, hidden, hc):
            _block_gemm(lib, code, xln, c_fc_w[:, j : j + hc], c_fc_b[j : j + hc], h,
                        _EPI_BIAS_GELU, stream)
            _block_gemm(lib, code, h, c_proj_w[j : j + hc], None, out, _EPI_ACCUM, stream)
    cuda_lib.count_launch(what, x)
    return out


# the layer's tensors in the order the autograd Function takes them
BLOCK_KEYS = (
    "w_qkv", "b_qkv", "w_out", "b_out", "ln_1_scale", "ln_1_bias",
    "c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b", "ln_2_scale", "ln_2_bias",
)


class _FusedBlock(torch.autograd.Function):
    """K1 then K2 (or K5, as :func:`mlp_tier_chunks` routes the tower)
    forward; K4 then K3 backward (``_fused_block`` :483-558). After a K5
    forward the backward is the same K4 (unchunked) then K3: the chunks
    only round the forward's partial sums, and the function dx
    differentiates is the block's, as the TPU module's XLA VJP for such a
    block (``:549-551``) differentiates it.

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
        chunks = mlp_tier_chunks(x.shape[-2], x.shape[-1], c_fc_w.shape[-1])
        if chunks:
            z = fused_mlp_half_chunked(y, c_fc_w, c_fc_b, c_proj_w, c_proj_b, ln_2_s, ln_2_b,
                                       chunks=chunks)
        else:
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
    running K1 then K2 (K5 where :func:`mlp_tier_chunks` says so),
    differentiable through the dx kernels K4 and K3.
    Under ``torch.no_grad()`` nothing is saved."""
    return _FusedBlock.apply(x, mask, n_head, *(p[k] for k in BLOCK_KEYS))
