"""Visual token generator ("aggregator"), the only trained module.

Counterpart of ``ovmr_tpu/models/aggregator.py`` (reference
``TransformerDropout``, ``clip/model.py:341-358``): a 4-layer pre-LN
transformer of width = CLIP embed dim, heads = width // 64, that turns a
class's exemplar features into ``n_ctx`` visual tokens (vokens).

Training runs it with dropout on the attention probabilities and twice
inside the MLP (after QuickGELU and after ``c_proj``). The masks come from
an explicit ``torch.Generator`` on the tensor's device, drawn in a fixed
order (layer by layer: attention, MLP hidden, MLP output), so one seed
gives one set of masks. They are not the JAX package's masks (another
RNG): parity holds at dropout 0. Serving passes no generator and runs the
dropout-0 path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ovmr_tpu_torch.ops.attention import fused_attention
from ovmr_tpu_torch.ops.layers import (
    dense,
    l2_normalize,
    layer_norm,
    matmul_f32,
    merge_heads,
    quick_gelu,
    split_heads,
)
from ovmr_tpu_torch.utils import trace


def init_aggregator(
    width: int = 512,
    layers: int = 4,
    n_ctx: int = 2,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cpu",
) -> dict:
    """Seeded random aggregator with the CLIP text-transformer init scales;
    the learned query ``cls_token`` [n_ctx, width] is unit-normalized noise.
    Drawn on the CPU from ``generator`` (or one seeded with ``seed``)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dtype)

    blocks = {
        "w_qkv": normal((layers, width, 3 * width), attn_std),
        "b_qkv": torch.zeros(layers, 3 * width, dtype=dtype),
        "w_out": normal((layers, width, width), proj_std),
        "b_out": torch.zeros(layers, width, dtype=dtype),
        "ln_1_scale": torch.ones(layers, width, dtype=dtype),
        "ln_1_bias": torch.zeros(layers, width, dtype=dtype),
        "c_fc_w": normal((layers, width, 4 * width), fc_std),
        "c_fc_b": torch.zeros(layers, 4 * width, dtype=dtype),
        "c_proj_w": normal((layers, 4 * width, width), proj_std),
        "c_proj_b": torch.zeros(layers, width, dtype=dtype),
        "ln_2_scale": torch.ones(layers, width, dtype=dtype),
        "ln_2_bias": torch.zeros(layers, width, dtype=dtype),
    }
    cls_token = l2_normalize(torch.randn((n_ctx, width), generator=gen)).to(dtype)
    return {
        "blocks": {k: v.to(device) for k, v in blocks.items()},
        "cls_token": cls_token.to(device),
    }


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)`` (``_dropout`` :69-74)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def _dropout_block(
    x: torch.Tensor,
    p: dict,
    n_head: int,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attn_fn=fused_attention,
) -> torch.Tensor:
    """Pre-LN residual block with the dropout placement of the reference
    ``ResidualAttentionBlockWithDropout`` (``_dropout_block`` :77-120):
    attention-probability dropout, MLP dropout after QuickGELU and after
    ``c_proj``."""
    active = generator is not None and dropout > 0.0
    h = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
    qkv = dense(h, p["w_qkv"], p["b_qkv"])
    q, k, v = (split_heads(t, n_head) for t in qkv.chunk(3, dim=-1))
    if active:
        # dropout must hit the attention probabilities, so the attention is
        # expanded in torch ops and ``attn_fn`` (K6) is not called
        scale = q.shape[-1] ** -0.5
        probs = torch.softmax(matmul_f32(q * scale, k.transpose(-1, -2)), dim=-1)
        probs = _dropout(probs, dropout, generator)
        attn_out = matmul_f32(probs.to(q.dtype), v).to(q.dtype)
    else:
        attn_out = attn_fn(q, k, v, None)
    x = x + dense(merge_heads(attn_out), p["w_out"], p["b_out"])
    h = layer_norm(x, p["ln_2_scale"], p["ln_2_bias"])
    h = quick_gelu(dense(h, p["c_fc_w"], p["c_fc_b"]))
    h = _dropout(h, dropout, generator)
    h = dense(h, p["c_proj_w"], p["c_proj_b"])
    h = _dropout(h, dropout, generator)
    return x + h


def generate_vokens(
    params: dict,
    exemplar_feats: torch.Tensor,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attn_fn=fused_attention,
) -> torch.Tensor:
    """exemplar_feats [N, K, D] -> vokens [N, n_ctx, D]: prepend the learned
    queries, run the blocks, keep the first n_ctx positions
    (reference ``trainers/mm_classifier_one_prompt.py:167-169``). Dropout is
    active only with a ``generator`` and ``dropout`` > 0."""
    with trace.span("generator"):
        n, _, d = exemplar_feats.shape
        cls = params["cls_token"].to(exemplar_feats.dtype)
        n_ctx = cls.shape[0]
        x = torch.cat([cls[None].expand(n, n_ctx, d), exemplar_feats], dim=1)
        blocks = params["blocks"]
        for i in range(blocks["w_qkv"].shape[0]):
            x = _dropout_block(
                x, {k: v[i] for k, v in blocks.items()}, d // 64, dropout, generator, attn_fn
            )
        return x[:, :n_ctx, :]
