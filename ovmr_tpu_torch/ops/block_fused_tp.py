"""Tensor-parallel residual block: per-shard Hopper kernels, summed partials.

PyTorch counterpart of ``ovmr_tpu/ops/block_fused_tp.py``. A model axis of
size m splits every block of a tower m ways (Megatron column/row split):

- **head-split attention**: shard j holds heads ``[j H/m, (j+1) H/m)``, the
  column shards of ``w_q``/``w_k``/``w_v`` with their biases and the row
  shard of ``w_out``;
- **hidden-split MLP**: shard j holds hidden columns ``[j 4D/m, (j+1) 4D/m)``,
  the column shard of ``c_fc`` with its bias and the row shard of ``c_proj``.

Each shard computes an fp32 partial of its half, with no bias and no
residual:

- **K7** :func:`tp_attn_half_partial` (TPU: ``_attn_partial_kernel`` :179,
  ``_masked_attn_partial_kernel`` :235): ``attn_local(LN1(x)) @ w_out_local``;
- **K8** :func:`tp_mlp_half_partial` (TPU: ``_mlp_partial_kernel`` :245):
  ``QuickGELU(LN2(x) @ c_fc_local + b_local) @ c_proj_local``.

:func:`make_tp_block` sums the partials over the model axis
(:meth:`ovmr_tpu_torch.parallel.mesh.ModelAxis.reduce`: the shards this
process holds in shard order, then an all-reduce over the process group)
and adds the bias and the residual once:
``y = x + T(sum_j K7_j(x) + b_out)``, ``z = y + T(sum_j K8_j(y) + c_proj_b)``.
The TPU module sends a shard whose weights exceed its VMEM residency
cutoffs to an XLA partial (``_tp_flavor`` :433); K7 and K8 stream their
weights from HBM through the GEMM, so here every shard size takes them.

Storage: the TP towers replace the packed ``w_qkv``/``b_qkv`` leaves with
``w_q/w_k/w_v [D, D]`` and ``b_q/b_k/b_v [D]`` (:func:`split_qkv_blocks`),
so a contiguous shard of each is a head group. Head counts that do not
divide the axis are zero-padded to the next multiple
(:func:`pad_head_shards`); a padded head is exact zeros forward and
backward. :data:`TP_BLOCK_AXES` names the dimension each leaf is split on.

Each kernel wrapper takes its plain PyTorch version (``*_plain``) for a
tensor on the CPU and launches the kernels of ``csrc/block_fused.cu`` for a
tensor on a CUDA card, never one for the other; on the card it raises for a
tensor that requires grad (gradients go through :func:`make_tp_block`). The
plain versions round where the Pallas bodies round (``:190-266``): the LN
output is cast; q, k and v are each cast after their fp32 bias; the scores
are scaled after the fp32 product and the mask is added in fp32; the probs
and each head's output are cast; the partial is fp32, uncast; QuickGELU
runs in fp32 and is then cast. K7 and K8 take fp32, bf16 and fp16 and every
width that is a multiple of 8, with head width at most 128. In bf16/fp16
K7's four products and K8's two run on the wgmma/TMA GEMM (the launches of
:func:`ovmr_tpu_torch.ops.block_fused.block_gemm`: K8's c_fc with the
bias + QuickGELU epilogue, its c_proj with the fp32-out one); in fp32 both
keep gemm.cuh's FMA GEMM.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused import (
    _EPI_BIAS,
    _EPI_BIAS_GELU,
    _EPI_F32,
    _attn_core,
    _block_gemm,
    _check_block_args,
    _layer_norm,
    _refuse_int8,
    _shapes_ok,
    attn_core_plain,
)
from ovmr_tpu_torch.ops.layers import (
    attention_plain,
    dense,
    layer_norm,
    matmul_f32,
    merge_heads,
    quick_gelu,
    split_heads,
)

# --------------------------------------------------------------------------
# layout: packed qkv -> split q/k/v (contiguous shards are head groups)
# --------------------------------------------------------------------------


def split_qkv_blocks(blocks: dict) -> dict:
    """Packed-qkv block params -> the split-qkv TP layout: ``w_qkv [..., D,
    3D] -> w_q/w_k/w_v [..., D, D]`` (and the biases likewise); every other
    leaf passes through. Works on stacked ``[L, ...]`` and per-layer trees."""
    out = {k: v for k, v in blocks.items() if k not in ("w_qkv", "b_qkv")}
    out["w_q"], out["w_k"], out["w_v"] = (t.contiguous() for t in blocks["w_qkv"].chunk(3, dim=-1))
    out["b_q"], out["b_k"], out["b_v"] = (t.contiguous() for t in blocks["b_qkv"].chunk(3, dim=-1))
    return out


def pad_head_shards(blocks: dict, head_dim: int, msize: int) -> dict:
    """Zero-pad the split-qkv head axis to a multiple of ``msize`` heads.

    Exact (``:98-108``): a padded head has zero ``w_k``/``b_k`` (uniform
    probs) and zero ``w_v``/``b_v`` (its output is 0), and its ``w_out``
    rows are zero, so its partial is an exact 0 in every dtype; backward
    its cotangents are exact zeros too."""
    n_head = blocks["w_q"].shape[-1] // head_dim
    pad = ((-n_head) % msize) * head_dim
    if pad == 0:
        return blocks
    out = dict(blocks)
    for name in ("w_q", "b_q", "w_k", "b_k", "w_v", "b_v"):
        out[name] = F.pad(blocks[name], (0, pad))
    out["w_out"] = F.pad(blocks["w_out"], (0, 0, 0, pad))
    return out


def split_clip_qkv(clip_params: dict, msize: int = 1, cfg=None) -> dict:
    """Split both ViT towers' stacked blocks; with ``msize > 1`` and a
    ``cfg`` (:class:`ovmr_tpu_torch.models.clip.CLIPConfig`) each tower
    whose head count does not divide the model axis is zero-padded to the
    next multiple, so that a contiguous shard is always a whole head group."""
    out = dict(clip_params)
    for tower in ("visual", "text"):
        t = clip_params.get(tower)
        if isinstance(t, dict) and isinstance(t.get("blocks"), dict) and "w_qkv" in t["blocks"]:
            t = dict(t)
            blocks = split_qkv_blocks(t["blocks"])
            if msize > 1 and cfg is not None:
                width, heads = (
                    (cfg.vision_width, cfg.vision_heads) if tower == "visual"
                    else (cfg.transformer_width, cfg.transformer_heads)
                )
                blocks = pad_head_shards(blocks, width // heads, msize)
            t["blocks"] = blocks
            out[tower] = t
    return out


# leaf name -> the dimension split over the model axis, counted after the
# stacked layer axis (None: every shard holds the whole leaf)
TP_BLOCK_AXES = {
    "w_q": 1, "w_k": 1, "w_v": 1,       # [L, D, D]   column shards
    "b_q": 0, "b_k": 0, "b_v": 0,       # [L, D]
    "w_out": 0,                          # [L, D, D]   row shard
    "c_fc_w": 1, "c_fc_b": 0,           # [L, D, 4D] / [L, 4D]
    "c_proj_w": 0,                       # [L, 4D, D]  row shard
    "b_out": None, "c_proj_b": None,
    "ln_1_scale": None, "ln_1_bias": None,
    "ln_2_scale": None, "ln_2_bias": None,
}
# the layer's tensors in the order the autograd Function takes them
TP_KEYS = tuple(TP_BLOCK_AXES)

# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def tp_attn_half_partial_plain(
    x, w_q, b_q, w_k, b_k, w_v, b_v, w_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 6,
):
    """fp32 ``attn_local(LN1(x)) @ w_out_local`` for x [B, L, D] over a head
    shard of width ``dl = w_q.shape[-1]`` (``n_head`` local heads), K7's
    rounding."""
    xln = layer_norm(x, ln_s, ln_b)
    qkv = torch.cat([dense(xln, w, b) for w, b in ((w_q, b_q), (w_k, b_k), (w_v, b_v))], dim=-1)
    return matmul_f32(attn_core_plain(qkv, mask, n_head), w_out)


def tp_mlp_half_partial_plain(x, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b):
    """fp32 ``QuickGELU(LN2(x) @ c_fc_local + b_local) @ c_proj_local`` for
    x [B, L, D] over a hidden shard, K8's rounding."""
    h = matmul_f32(layer_norm(x, ln_s, ln_b), c_fc_w) + c_fc_b.float()
    h = (h * torch.sigmoid(1.702 * h)).to(x.dtype)
    return matmul_f32(h, c_proj_w)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def tp_attn_half_partial(
    x, w_q, b_q, w_k, b_k, w_v, b_v, w_out, ln_s, ln_b,
    mask: Optional[torch.Tensor] = None, n_head: int = 6,
):
    """K7: the fp32 attention partial of one head shard, x [B, L, D]."""
    _refuse_int8("tp_attn_half_partial", w_q, w_k, w_v, w_out)
    if x.device.type == "cpu":
        return tp_attn_half_partial_plain(
            x, w_q, b_q, w_k, b_k, w_v, b_v, w_out, ln_s, ln_b, mask=mask, n_head=n_head
        )
    if x.device.type != "cuda":
        raise ValueError(f"tp_attn_half_partial: no kernel for device {x.device}")
    what = "tp_attn_half_partial"
    weights = dict(w_q=w_q, b_q=b_q, w_k=w_k, b_k=b_k, w_v=w_v, b_v=b_v, w_out=w_out,
                   ln_s=ln_s, ln_b=ln_b)
    cuda_lib.require_no_grad(what, x, *weights.values())
    b, l, d = x.shape
    dl = w_q.shape[-1]
    _check_block_args(what, x, weights, mask=mask)
    if dl % 8 or dl % n_head or (dl // n_head) % 8:
        raise ValueError(f"{what}: head width {dl}/{n_head} must be a whole multiple of 8")
    if dl // n_head > 128:
        raise ValueError(f"{what}: head width {dl // n_head} exceeds the attention core's 128")
    _shapes_ok(
        what, w_q=(w_q, (d, dl)), b_q=(b_q, (dl,)), w_k=(w_k, (d, dl)), b_k=(b_k, (dl,)),
        w_v=(w_v, (d, dl)), b_v=(b_v, (dl,)), w_out=(w_out, (dl, d)),
        ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        # q, k and v side by side, as the attention core reads them
        qkv = torch.empty((b, l, 3 * dl), dtype=x.dtype, device=x.device)
        for j, (w, bias) in enumerate(((w_q, b_q), (w_k, b_k), (w_v, b_v))):
            _block_gemm(lib, code, xln, w, bias, qkv[..., j * dl : (j + 1) * dl], _EPI_BIAS,
                        stream)
        heads = _attn_core(lib, code, qkv, mask, n_head, stream)
        out = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
        _block_gemm(lib, code, heads, w_out, None, out, _EPI_F32, stream)
    name = "tp_attn_half_partial_masked" if mask is not None else "tp_attn_half_partial"
    cuda_lib.count_launch(name, x, shape=(b, l, d, dl))
    return out


def tp_mlp_half_partial(x, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b):
    """K8: the fp32 MLP partial of one hidden shard, x [B, L, D]."""
    _refuse_int8("tp_mlp_half_partial", c_fc_w, c_proj_w)
    if x.device.type == "cpu":
        return tp_mlp_half_partial_plain(x, c_fc_w, c_fc_b, c_proj_w, ln_s, ln_b)
    if x.device.type != "cuda":
        raise ValueError(f"tp_mlp_half_partial: no kernel for device {x.device}")
    what = "tp_mlp_half_partial"
    weights = dict(c_fc_w=c_fc_w, c_fc_b=c_fc_b, c_proj_w=c_proj_w, ln_s=ln_s, ln_b=ln_b)
    cuda_lib.require_no_grad(what, x, *weights.values())
    b, l, d = x.shape
    hl = c_fc_w.shape[-1]
    _check_block_args(what, x, weights)
    if hl % 8:
        raise ValueError(f"{what}: hidden shard width {hl} must be a multiple of 8")
    _shapes_ok(
        what, c_fc_w=(c_fc_w, (d, hl)), c_fc_b=(c_fc_b, (hl,)), c_proj_w=(c_proj_w, (hl, d)),
        ln_s=(ln_s, (d,)), ln_b=(ln_b, (d,)),
    )
    lib = cuda_lib.library("block_fused")
    code = cuda_lib.dtype_code(x.dtype)
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        xln = _layer_norm(lib, code, x, ln_s, ln_b, stream)
        h = torch.empty((b, l, hl), dtype=x.dtype, device=x.device)
        _block_gemm(lib, code, xln, c_fc_w, c_fc_b, h, _EPI_BIAS_GELU, stream)
        out = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
        _block_gemm(lib, code, h, c_proj_w, None, out, _EPI_F32, stream)
    cuda_lib.count_launch(what, x, shape=(b, l, d, hl))
    return out


# --------------------------------------------------------------------------
# torch math on the split layout (backward's recompute)
# --------------------------------------------------------------------------


def _attn_partial_torch(x, p, n_head, mask):
    """fp32 attention partial of one head shard in torch math
    (``_attn_partial_xla`` :374): the reference path's rounding."""
    xln = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
    q, k, v = (split_heads(dense(xln, p[w], p[b]), n_head)
               for w, b in (("w_q", "b_q"), ("w_k", "b_k"), ("w_v", "b_v")))
    o = merge_heads(attention_plain(q, k, v, mask))
    return matmul_f32(o, p["w_out"].to(o.dtype))


def _mlp_partial_torch(y, p):
    """fp32 MLP partial of one hidden shard in torch math
    (``_mlp_partial_xla`` :386)."""
    h = quick_gelu(dense(layer_norm(y, p["ln_2_scale"], p["ln_2_bias"]),
                         p["c_fc_w"], p["c_fc_b"]))
    return matmul_f32(h, p["c_proj_w"].to(h.dtype))


# --------------------------------------------------------------------------
# the TP block
# --------------------------------------------------------------------------


def _attn_partial(x, p, nh_local, mask):
    """Shard ``p``'s attention partial: K7 (its plain twin on the CPU)."""
    return tp_attn_half_partial(
        x, p["w_q"], p["b_q"], p["w_k"], p["b_k"], p["w_v"], p["b_v"], p["w_out"],
        p["ln_1_scale"], p["ln_1_bias"], mask=mask, n_head=nh_local,
    )


def _mlp_partial(y, p):
    """Shard ``p``'s MLP partial: K8 (its plain twin on the CPU)."""
    return tp_mlp_half_partial(
        y, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["ln_2_scale"], p["ln_2_bias"]
    )


def _shard(p: dict, j: int) -> dict:
    """Shard j of a layer whose split leaves are stored ``[m_local, ...]``."""
    return {k: v[j] if TP_BLOCK_AXES[k] is not None else v for k, v in p.items()}


class _TPBlock(torch.autograd.Function):
    """The block over this process's shards (``_tp_block`` :505-548).

    Forward: per shard K7, the partials reduced
    over the model axis, then bias and residual; the same for K8. Backward
    recomputes each shard's partials in torch math (the recompute policy of
    the single-device block) and reduces the dx partials over the axis the
    same way. Weight cotangents, only for leaves that require grad: a split
    leaf gets its shards' own cotangents; a LayerNorm leaf the sum over the
    shards (reduced over the axis); ``b_out`` and ``c_proj_b`` the summed
    cotangent of their half."""

    @staticmethod
    def forward(ctx, x, mask, nh_local, axis, *weights):
        p = dict(zip(TP_KEYS, weights))
        shards = [_shard(p, j) for j in range(p["w_q"].shape[0])]
        dtype = x.dtype
        partial = axis.reduce(_attn_partial(x, s, nh_local, mask) for s in shards)
        y = x + (partial + p["b_out"].float()).to(dtype)
        partial = axis.reduce(_mlp_partial(y, s) for s in shards)
        z = y + (partial + p["c_proj_b"].float()).to(dtype)
        ctx.nh_local, ctx.axis = nh_local, axis
        ctx.save_for_backward(x, y, mask, *weights)
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, mask, *weights = ctx.saved_tensors
        p = dict(zip(TP_KEYS, weights))
        wanted = dict(zip(TP_KEYS, ctx.needs_input_grad[4:]))
        axis = ctx.axis
        g = g.to(x.dtype).contiguous()
        gf = g.float()
        m_local = p["w_q"].shape[0]
        per_shard = {k: [None] * m_local for k in TP_KEYS}  # weight cotangents

        def shard_vjps(fn, inp, cot):
            """Per shard: the cotangent of ``inp`` through ``fn(inp, shard)``;
            the shard's weight cotangents are added into ``per_shard``."""
            outs = []
            with torch.enable_grad():
                inp = inp.detach().requires_grad_(True)
                for j in range(m_local):
                    leaves = {k: v.detach().requires_grad_(wanted[k])
                              for k, v in _shard(p, j).items()}
                    names = [k for k, v in leaves.items() if v.requires_grad]
                    grads = torch.autograd.grad(
                        fn(inp, leaves), [inp] + [leaves[k] for k in names], cot,
                        allow_unused=True,
                    )
                    outs.append(grads[0])
                    for k, grad in zip(names, grads[1:]):
                        if grad is not None:
                            old = per_shard[k][j]
                            per_shard[k][j] = grad if old is None else old + grad
            return outs

        nh = ctx.nh_local
        dy_parts = shard_vjps(_mlp_partial_torch, y, gf)
        dy = g + axis.reduce(t.float() for t in dy_parts).to(g.dtype)
        dyf = dy.float()
        dx_parts = shard_vjps(lambda x_, s: _attn_partial_torch(x_, s, nh, mask), x, dyf)
        dx = dy + axis.reduce(t.float() for t in dx_parts).to(g.dtype)

        dweights = []
        for k in TP_KEYS:
            if not wanted[k]:
                dweights.append(None)
            elif k in ("b_out", "c_proj_b"):  # added once, after the reduce
                cot = dyf if k == "b_out" else gf
                dweights.append(cot.sum(tuple(range(cot.dim() - 1))).to(p[k].dtype))
            else:
                shards = [torch.zeros_like(_shard(p, j)[k]) if grad is None else grad
                          for j, grad in enumerate(per_shard[k])]
                # a LayerNorm leaf serves every shard: its cotangents add up
                dweights.append(axis.reduce(shards) if TP_BLOCK_AXES[k] is None
                                else torch.stack(shards))
        return (dx if ctx.needs_input_grad[0] else None, None, None, None, *dweights)


def make_tp_block(axis):
    """The TP block over the shards that ``axis``
    (:class:`ovmr_tpu_torch.parallel.mesh.ModelAxis`) says this process
    holds: ``block_fn(h, layer_params, n_head, mask)`` with the standard
    block signature (``make_tp_block`` :551).

    ``layer_params`` is one layer of towers placed with
    :func:`ovmr_tpu_torch.parallel.mesh.place_tower_params` (split leaves
    ``[m_local, ...]``). ``n_head`` is the model's unpadded head count and
    fixes only the head width; the local head count comes from the shard's
    ``w_q`` width, so head-padded layouts run the same kernels. Differentiable
    (:class:`_TPBlock`); under ``torch.no_grad()`` nothing is saved."""

    def block_fn(h, layer_params, n_head, mask=None):
        d = h.shape[-1]
        if d % n_head:
            raise ValueError(f"width {d} not divisible by n_head={n_head}")
        head_dim = d // n_head
        w_q = layer_params["w_q"]
        if w_q.dtype == torch.int8:
            # JAX sends int8 on a model axis to its GSPMD XLA block
            # (``ovmr_tpu/ops/block_fused_tp.py:395-431``)
            raise ValueError(
                "the TP block takes float weights; int8 towers on a model axis take the "
                "GSPMD route (parallel.mesh.place_packed_mlp + make_gspmd_block)")
        dl = w_q.shape[-1]
        if dl % head_dim:
            raise ValueError(
                f"local q shard width {dl} not divisible by the head dim {head_dim}; "
                f"split/pad the towers with split_clip_qkv (model axis {axis.size})"
            )
        if w_q.dim() != 3 or w_q.shape[0] != len(axis.shards):
            raise ValueError(
                f"w_q of shape {tuple(w_q.shape)} does not hold this process's "
                f"{len(axis.shards)} shards; place the towers with place_tower_params"
            )
        return _TPBlock.apply(h, mask, dl // head_dim, axis, *(layer_params[k] for k in TP_KEYS))

    return block_fn


# --------------------------------------------------------------------------
# the GSPMD route: packed towers, MLP split over the model axis
# --------------------------------------------------------------------------


def make_gspmd_block(axis):
    """The block of JAX's ``tp == "gspmd"`` route (int8 towers,
    ``TP_SPLIT_QKV False``, or an MLP hidden width the axis does not
    divide; ``ovmr_tpu/engine/trainer.py:157-218``), where XLA partitions
    the packed towers' matmuls itself. Here it is torch math over the
    shards ``axis`` (:class:`ovmr_tpu_torch.parallel.mesh.ModelAxis`) says
    this process holds: the attention half whole on every shard
    (``ops.layers.multi_head_attention``), the MLP Megatron-split, each
    shard's c_fc columns (their bias, and their scales when int8) and
    c_proj rows giving an fp32 partial, summed over the axis before
    ``c_proj_b`` and the residual. The int8 c_proj quantizes each row with
    its scale over the whole row (:func:`ops.quant.dense_int8_row_parallel`),
    so the sharded int8 tower equals the unsharded one bit for bit.
    ``layer_params`` is one layer of towers placed with
    :func:`ovmr_tpu_torch.parallel.mesh.place_packed_mlp` (MLP leaves
    ``[m_local, ...]``). Differentiable in the float towers; no kernel
    runs on this route."""
    from ovmr_tpu_torch.ops.layers import multi_head_attention

    def block_fn(h, p, n_head, mask=None):
        w_fc = p["c_fc_w"]
        if w_fc.dim() != 3 or w_fc.shape[0] != len(axis.shards):
            raise ValueError(
                f"c_fc_w of shape {tuple(w_fc.shape)} does not hold this process's "
                f"{len(axis.shards)} shards; place the towers with place_packed_mlp")
        x = h + multi_head_attention(layer_norm(h, p["ln_1_scale"], p["ln_1_bias"]), p, n_head,
                                     mask)
        y = axis.enter(layer_norm(x, p["ln_2_scale"], p["ln_2_bias"]))
        m_local = w_fc.shape[0]
        if w_fc.dtype == torch.int8:
            from ovmr_tpu_torch.ops.quant import dense_int8, dense_int8_row_parallel

            hs = [quick_gelu(dense_int8(y, w_fc[j], p["c_fc_w_scale"][j], p["c_fc_b"][j]))
                  for j in range(m_local)]
            return x + dense_int8_row_parallel(
                hs, [p["c_proj_w"][j] for j in range(m_local)], p["c_proj_w_scale"],
                p["c_proj_b"], axis)
        partial = axis.reduce_partials(
            matmul_f32(quick_gelu(dense(y, w_fc[j], p["c_fc_b"][j])), p["c_proj_w"][j].to(y.dtype))
            for j in range(m_local))
        return x + (partial + p["c_proj_b"].float()).to(x.dtype)

    block_fn.torch_math = True  # the differentiated text tower rematerialises it
    return block_fn
