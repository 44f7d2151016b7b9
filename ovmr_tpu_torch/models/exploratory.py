"""Exploratory ViT encode variants: the reference's research forwards.

Counterpart of ``ovmr_tpu/models/exploratory.py`` (reference
``clip/model.py:184-217, 254-259, 311-325, 352-358, 382-409, 430-714``):
the dozen research forward paths of the reference's VisionTransformer and
block classes that no shipped trainer calls, as functions over the port's
CLIP parameter tree, with the JAX package's redesigns:

- "the last block behaves differently" paths split the stacked block
  leaves into a front and an explicit last layer (no module mutation like
  the reference's ``resblocks[-1].attn_mask = ...``);
- :func:`forward_multi_pos` runs every shifted positional table at one
  fixed length with the dropped tokens masked out of the keys, which gives
  the CLS output of the reference's per-shift gathered sequences;
- where a reference body cannot run (``get_avg_patch_embed``,
  ``forward_with_image_feat_map``) the evident intent is computed, as in
  the JAX package, and each function says how.

This is diagnostics, not a hot path: plain torch math (the torch-math
block, :func:`ovmr_tpu_torch.ops.layers.attention_plain`, fp32 softmax),
as the JAX package keeps it in plain XLA, away from the kernels.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ovmr_tpu_torch.models.clip import CLIPConfig, patch_embed_grid, run_blocks
from ovmr_tpu_torch.ops.layers import (
    attention_plain,
    dense,
    layer_norm,
    matmul_f32,
    mlp_block,
    multi_head_attention,
    quick_gelu,
    residual_attention_block,
    split_heads,
)


def _torch_block(attn_fn):
    """The torch-math block as a ``run_blocks`` block function."""
    return lambda h, p, n_head, mask: residual_attention_block(h, p, n_head, mask, attn_fn)


def _blocks(x, blocks, n_head, mask=None, attn_fn=attention_plain):
    return run_blocks(x, blocks, n_head, mask=mask, block_fn=_torch_block(attn_fn))


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def _patch_tokens(v: dict, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    dtype = v["patch_embed_w"].dtype
    xg = patch_embed_grid(images.to(dtype), v["patch_embed_w"], cfg.vision_patch_size)
    b, gh, gw, width = xg.shape
    return xg.reshape(b, gh * gw, width)


def _with_cls(x: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    return torch.cat([cls.to(x.dtype).expand(x.shape[0], 1, x.shape[-1]), x], dim=1)


def prepare_tokens(params: dict, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """Patchify + CLS + positional embedding, no ln_pre (reference
    ``prepare_tokens``, model.py:382-388). [B, 1+G^2, D]."""
    v = params["visual"]
    x = _with_cls(_patch_tokens(v, cfg, images), v["class_embedding"])
    return x + v["positional_embedding"].to(x.dtype)


def _split_last(blocks: dict) -> Tuple[dict, dict]:
    """Stacked block leaves [L, ...] -> (front [L-1, ...], last [...])."""
    return ({k: leaf[:-1] for k, leaf in blocks.items()},
            {k: leaf[-1] for k, leaf in blocks.items()})


def _pool_project(v: dict, x_cls: torch.Tensor) -> torch.Tensor:
    pooled = layer_norm(x_cls, v["ln_post_scale"], v["ln_post_bias"])
    return matmul_f32(pooled, v["proj"].to(x_cls.dtype)).to(x_cls.dtype)


def _encode_tokens(params, cfg, x, mask=None, attn_fn=attention_plain):
    """ln_pre -> blocks -> the projected CLS feature."""
    v = params["visual"]
    x = layer_norm(x, v["ln_pre_scale"], v["ln_pre_bias"])
    x = _blocks(x, v["blocks"], cfg.vision_heads, mask, attn_fn)
    return x


def last_visual_attention_mask(length: int, device=None) -> torch.Tensor:
    """Every token attends only to itself, except the CLS token, which sees
    everything (reference ``build_last_visual_attention_mask``,
    model.py:647-655)."""
    mask = torch.full((length, length), float("-inf"), device=device)
    mask.fill_diagonal_(0.0)
    mask[0, :] = 0.0
    return mask


# --------------------------------------------------------------------------
# whole-tower variants
# --------------------------------------------------------------------------

def forward_with_embeds(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                        new_embeds: torch.Tensor, attn_fn=attention_plain) -> torch.Tensor:
    """The encode with extra additive embeddings [1+G^2, D] after the
    positional embedding (reference ``forward_with_embeds``
    model.py:468-486)."""
    x = prepare_tokens(params, cfg, images)
    x = x + new_embeds.to(x.dtype)[None]
    x = _encode_tokens(params, cfg, x, attn_fn=attn_fn)
    return _pool_project(params["visual"], x[:, 0, :])


def forward_v(params: dict, cfg: CLIPConfig, images: torch.Tensor,
              vision_prompt: torch.Tensor, attn_fn=attention_plain) -> torch.Tensor:
    """Vision-prompt tokens [n_prompt, D] appended after the image tokens
    (reference ``forward_v`` model.py:626-645); the CLS token pools."""
    x = prepare_tokens(params, cfg, images)
    prompt = vision_prompt.to(x.dtype)[None].expand(x.shape[0], *vision_prompt.shape)
    x = _encode_tokens(params, cfg, torch.cat([x, prompt], dim=1), attn_fn=attn_fn)
    return _pool_project(params["visual"], x[:, 0, :])


def forward_new_cls(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                    new_cls: torch.Tensor, attn_fn=attention_plain) -> torch.Tensor:
    """The encode with the class embedding replaced by ``new_cls`` [D]
    (reference ``forward_new_cls`` model.py:678-696)."""
    v = params["visual"]
    x = _with_cls(_patch_tokens(v, cfg, images), new_cls)
    x = x + v["positional_embedding"].to(x.dtype)
    x = _encode_tokens(params, cfg, x, attn_fn=attn_fn)
    return _pool_project(v, x[:, 0, :])


def forward_eTT(params: dict, cfg: CLIPConfig, images: torch.Tensor, prefix_token=None,
                attn_fn=attention_plain) -> torch.Tensor:
    """Reference ``forward_eTT`` (model.py:697-714) takes a
    ``prefix_token`` and never uses it: the body is the plain encode. The
    quirk is kept: the argument is accepted and ignored."""
    del prefix_token
    x = _encode_tokens(params, cfg, prepare_tokens(params, cfg, images), attn_fn=attn_fn)
    return _pool_project(params["visual"], x[:, 0, :])


def forward_multi_cls(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                      multi_cls: torch.Tensor, attn_fn=attention_plain):
    """Groups of learnable class tokens ``[model_num, n_token, D]`` appended
    after the image tokens under a structured mask (reference
    ``forward_multi_cls`` model.py:430-466): the image tokens see no group,
    each group sees itself and the patches but not the real CLS token.
    Returns the projected real-CLS feature and the projected last appended
    token's feature."""
    v = params["visual"]
    x = prepare_tokens(params, cfg, images)
    b, base_len, d = x.shape
    model_num, n_token, _ = multi_cls.shape
    extra = model_num * n_token
    tail = multi_cls.reshape(1, extra, d).to(x.dtype).expand(b, extra, d)
    x = torch.cat([x, tail], dim=1)
    total = base_len + extra

    mask = torch.zeros((total, total), device=x.device)
    mask[:, base_len:] = float("-inf")  # nobody sees the groups...
    mask[base_len:, 0] = float("-inf")  # ...the groups do not see CLS
    for i in range(model_num, 0, -1):
        lo, hi = total - i * n_token, total - (i - 1) * n_token
        mask[lo:hi, lo:hi] = 0.0  # ...except each group itself
    mask[total - n_token:, total - n_token:] = 0.0

    x = _encode_tokens(params, cfg, x, mask=mask, attn_fn=attn_fn)
    return _pool_project(v, x[:, 0, :]), _pool_project(v, x[:, -1, :])


# --------------------------------------------------------------------------
# exemplar paths (last block masked to its diagonal and an open CLS row)
# --------------------------------------------------------------------------

def encode_exemplar(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                    attn_fn=attention_plain):
    """The encode with the last block's attention under
    :func:`last_visual_attention_mask` (reference ``encode_exemplar``
    model.py:657-676). Returns ``(cls_feat [B, E], patch_feats [B, G^2,
    E])``: ln_post and the projection on every token, as the reference
    does."""
    v = params["visual"]
    x = prepare_tokens(params, cfg, images)
    x = layer_norm(x, v["ln_pre_scale"], v["ln_pre_bias"])
    front, last = _split_last(v["blocks"])
    x = _blocks(x, front, cfg.vision_heads, attn_fn=attn_fn)
    x = residual_attention_block(x, last, cfg.vision_heads,
                                 last_visual_attention_mask(x.shape[1], x.device), attn_fn)
    x = layer_norm(x, v["ln_post_scale"], v["ln_post_bias"])
    x = matmul_f32(x, v["proj"].to(x.dtype)).to(x.dtype)
    return x[:, 0, :], x[:, 1:, :]


def _repeat_queries(mm_query: torch.Tensor, b: int, dtype) -> torch.Tensor:
    """Each of the Q queries covers B/Q consecutive images (the reference's
    repeat-interleave)."""
    return mm_query.repeat_interleave(b // mm_query.shape[0], dim=0).to(dtype)


def encode_exemplar_mmclassifier(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                                 mm_query: torch.Tensor, attn_fn=attention_plain):
    """Query-guided exemplar pooling (reference
    ``encode_exemplar_mmclassifier`` model.py:488-515): the patch tokens of
    :func:`encode_exemplar` pooled by softmax(50 <query, patch>) and added
    to the normalised CLS feature. ``mm_query`` is [Q, E], B a multiple of
    Q."""
    cls_feat, patches = encode_exemplar(params, cfg, images, attn_fn)
    q = _repeat_queries(mm_query, cls_feat.shape[0], cls_feat.dtype)
    x1 = cls_feat / torch.linalg.vector_norm(cls_feat, dim=-1, keepdim=True)
    x2 = patches / torch.linalg.vector_norm(patches, dim=-1, keepdim=True)
    w = torch.softmax(torch.einsum("bc,bnc->bn", 50.0 * q, x2).float(), dim=-1).to(x2.dtype)
    return x1 + torch.einsum("bn,bnc->bc", w, x2)


def forward_with_mmclassifier(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                              mm_query: torch.Tensor, attn_fn=attention_plain):
    """An mm-classifier query added to every image's CLS token before the
    last block (reference ``forward_with_mmclassfier`` [sic]
    model.py:517-537); B a multiple of Q."""
    v = params["visual"]
    x = prepare_tokens(params, cfg, images)
    x = layer_norm(x, v["ln_pre_scale"], v["ln_pre_bias"])
    front, last = _split_last(v["blocks"])
    x = _blocks(x, front, cfg.vision_heads, attn_fn=attn_fn)
    q = _repeat_queries(mm_query, x.shape[0], x.dtype)
    x = torch.cat([(x[:, 0, :] + q)[:, None], x[:, 1:]], dim=1)
    x = residual_attention_block(x, last, cfg.vision_heads, None, attn_fn)
    return _pool_project(v, x[:, 0, :])


# the reference's spelling, so code ported from it finds the name
forward_with_mmclassfier = forward_with_mmclassifier


# --------------------------------------------------------------------------
# multi-position encoding
# --------------------------------------------------------------------------

def build_multi_pos(params: dict, cfg: CLIPConfig, max_bias: int = 2, stride: int = 1):
    """Shifted positional tables (reference ``build_multi_pos``
    model.py:539-570): for every (dx, dy) of a (2 max_bias / stride + 1)^2
    grid the spatial table shifts by (dx, dy), positions out of the window
    zeroed. Returns ``(pos [P, 1+G^2, D], keep [P, 1+G^2] bool)``, the CLS
    row always kept."""
    pe = params["visual"]["positional_embedding"]
    g = cfg.grid_size
    cls_pos, spatial = pe[:1], pe[1:].reshape(g, g, -1)
    num_pos = 1 + 2 * (max_bias // stride)
    pos_list, keep_list = [], []
    for ix in range(num_pos):
        for iy in range(num_pos):
            cx, cy = -max_bias + ix * stride, -max_bias + iy * stride
            sx, ex = max(0, cx), min(g, cx + g)
            sy, ey = max(0, cy), min(g, cy + g)
            grid = torch.zeros_like(spatial)
            keep = torch.zeros((g, g), dtype=torch.bool, device=pe.device)
            if ex > sx and ey > sy:
                grid[sx:ex, sy:ey] = spatial[sx:ex, sy:ey]
                keep[sx:ex, sy:ey] = True
            pos_list.append(torch.cat([cls_pos, grid.reshape(g * g, -1)]))
            keep_list.append(torch.cat([torch.ones(1, dtype=torch.bool, device=pe.device),
                                        keep.reshape(-1)]))
    return torch.stack(pos_list), torch.stack(keep_list)


def forward_multi_pos(params: dict, cfg: CLIPConfig, images: torch.Tensor, max_bias: int = 2,
                      stride: int = 1, attn_fn=attention_plain) -> torch.Tensor:
    """The encode under every shifted positional table (reference
    ``forward_multi_pos`` model.py:572-592). [P, B, E].

    Each shift runs at the full length with its dropped tokens masked out
    of the keys: for the CLS output that equals the reference's gathered
    shorter sequence (attention is the only op across tokens, and a -inf
    key contributes nothing)."""
    v = params["visual"]
    x0 = _with_cls(_patch_tokens(v, cfg, images), v["class_embedding"])  # no base pos
    pos, keep = build_multi_pos(params, cfg, max_bias, stride)
    outs = []
    for pos_i, keep_i in zip(pos, keep):
        x = x0 + pos_i.to(x0.dtype)[None]
        neg = torch.where(keep_i, 0.0, float("-inf"))
        mask = torch.zeros((x.shape[1], x.shape[1]), device=x.device) + neg[None]
        x = _encode_tokens(params, cfg, x, mask=mask, attn_fn=attn_fn)
        outs.append(_pool_project(v, x[:, 0, :]))
    return torch.stack(outs)


def forward_with_new_pos(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                         pos_generator: Callable, kv: torch.Tensor, attn_fn=attention_plain):
    """Predicted positional reassignment (reference ``forward_with_new_pos``
    model.py:594-624): ``pos_generator(patch_tokens [B, N, D], kv) ->
    logits [B, N, N]`` scores every patch against every position, and each
    patch adds the positional row its argmax selects on top of the usual
    one. Returns ``(feats [B, E], pred_center [B])``, the argmax patch of
    the centre position."""
    v = params["visual"]
    x = prepare_tokens(params, cfg, images)
    n_patches = x.shape[1] - 1
    probs = torch.softmax(torch.as_tensor(pos_generator(x[:, 1:, :], kv)), dim=-1)
    pred_center = probs[:, :, n_patches // 2].argmax(dim=-1)
    new_pos = v["positional_embedding"].to(x.dtype)[probs.argmax(dim=-1)]  # [B, N, D]
    x = torch.cat([x[:, :1], x[:, 1:] + new_pos], dim=1)
    x = _encode_tokens(params, cfg, x, attn_fn=attn_fn)
    return _pool_project(v, x[:, 0, :]), pred_center


# --------------------------------------------------------------------------
# attention introspection
# --------------------------------------------------------------------------

def _attention_probs(xln: torch.Tensor, p: dict, n_head: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention probabilities [B, H, L, L] of one block, given its
    ln_1 output."""
    qkv = dense(xln, p["w_qkv"], p["b_qkv"])
    q, k, _ = qkv.chunk(3, dim=-1)
    q, k = split_heads(q, n_head), split_heads(k, n_head)
    scores = matmul_f32(q, k.transpose(-1, -2)) * (xln.shape[-1] // n_head) ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    return torch.softmax(scores, dim=-1)


def run_blocks_with_attention(x: torch.Tensor, blocks: dict, n_head: int,
                              mask: Optional[torch.Tensor] = None, attn_fn=attention_plain):
    """The stacked blocks, also returning each layer's attention
    probabilities (reference ``forward_with_attention`` model.py:352-358 /
    :254-259). Returns ``(x, attn [layers, B, H, L, L])``: keep sequences
    short."""
    probs_all = []
    for i in range(blocks["ln_1_scale"].shape[0]):
        p = {k: leaf[i] for k, leaf in blocks.items()}
        xln = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
        probs_all.append(_attention_probs(xln, p, n_head, mask))
        x = x + multi_head_attention(xln, p, n_head, mask, attn_fn)
        x = x + mlp_block(layer_norm(x, p["ln_2_scale"], p["ln_2_bias"]), p)
    return x, torch.stack(probs_all)


def get_avg_patch_embed(params: dict, cfg: CLIPConfig, images: torch.Tensor,
                        attn_fn=attention_plain) -> torch.Tensor:
    """The raw patch embeddings weighted by the last block's per-head
    CLS -> patch attention, averaged over heads (reference
    ``get_avg_patch_embed`` model.py:390-409, whose body cannot run: it
    unpacks two values from a block that returns one). Quirks kept: no
    ln_pre before the blocks, and a second softmax over the already
    softmaxed CLS -> patch probabilities. [B, D]."""
    v = params["visual"]
    x = prepare_tokens(params, cfg, images)
    patch_tokens = x[:, 1:, :]
    front, last = _split_last(v["blocks"])
    x = _blocks(x, front, cfg.vision_heads, attn_fn=attn_fn)
    xln = layer_norm(x, last["ln_1_scale"], last["ln_1_bias"])
    probs = _attention_probs(xln, last, cfg.vision_heads)
    cls_to_patch = torch.softmax(probs[:, :, 0, 1:], dim=-1)
    weighted = torch.einsum("bnc,bhn->bhc", patch_tokens.float(), cls_to_patch.float())
    return weighted.mean(dim=1).to(patch_tokens.dtype)


# --------------------------------------------------------------------------
# block-level adapter variants
# --------------------------------------------------------------------------

def residual_block_with_qk(x: torch.Tensor, p: dict, n_head: int, q_adapt: torch.Tensor,
                           k_adapt: torch.Tensor, mask: torch.Tensor,
                           attn_fn=attention_plain) -> torch.Tensor:
    """Adapter-biased block (reference ``forward_with_qk`` /
    ``attention_with_qk`` model.py:196-212): the lower triangle of the
    adapter q/k scores (``q_adapt``/``k_adapt`` [B, L, D], the adapters'
    outputs on the ln_1 output) adds to the additive mask, and the block
    runs under that combined mask."""
    xln = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
    q = split_heads(q_adapt.to(x.dtype), n_head)
    k = split_heads(k_adapt.to(x.dtype), n_head)
    scores = matmul_f32(q, k.transpose(-1, -2)) * (x.shape[-1] // n_head) ** -0.5
    combined = mask.float()[None, None] + torch.tril(scores)
    x = x + multi_head_attention(xln, p, n_head, combined, attn_fn)
    return x + mlp_block(layer_norm(x, p["ln_2_scale"], p["ln_2_bias"]), p)


def init_feat_map_adapter(generator: torch.Generator, width: int,
                          dtype=torch.float32) -> dict:
    """Params of :func:`block_with_image_feat_map`'s cross-attention adapter,
    leaf for leaf the reference's (``ResidualAttentionBlockWithDropoutATTN``
    model.py:289-300): ``img_proj`` width -> 2 width -> width with
    QuickGELU, four LayerNorms, a packed-qkv MHA. Values from
    ``generator``, not the JAX package's RNG."""
    std = width ** -0.5

    def normal(shape, s):
        return (torch.randn(shape, generator=generator) * s).to(dtype)

    out = {}
    for ln in ("ln_q", "ln_k", "ln_v", "ln_out"):
        out[f"{ln}_scale"] = torch.ones(width, dtype=dtype)
        out[f"{ln}_bias"] = torch.zeros(width, dtype=dtype)
    out.update({
        "img_proj_fc_w": normal((width, 2 * width), (2 * width) ** -0.5),
        "img_proj_fc_b": torch.zeros(2 * width, dtype=dtype),
        "img_proj_out_w": normal((2 * width, width), std),
        "img_proj_out_b": torch.zeros(width, dtype=dtype),
        "w_qkv": normal((width, 3 * width), std),
        "b_qkv": torch.zeros(3 * width, dtype=dtype),
        "w_out": normal((width, width), std),
        "b_out": torch.zeros(width, dtype=dtype),
    })
    return out


def block_with_image_feat_map(x: torch.Tensor, p: dict, adapter: dict,
                              image_feats: torch.Tensor, n_head: int, n_ctx: int = 2,
                              mask: Optional[torch.Tensor] = None,
                              attn_fn=attention_plain) -> torch.Tensor:
    """Context tokens cross-attend into an image feature map, and the pooled
    result adds to the other tokens (reference
    ``forward_with_image_feat_map`` model.py:311-325, whose MHA call mixes
    batch sizes and cannot run; the evident intent: every context token
    queries the map, the n_ctx outputs average, and the pooled [B, D] adds
    to every non-context token). ``x`` [B, L, D], ``image_feats`` [B, N,
    D]."""
    x = residual_attention_block(x, p, n_head, mask, attn_fn)
    q = layer_norm(x[:, :n_ctx, :], adapter["ln_q_scale"], adapter["ln_q_bias"])
    img = dense(image_feats.to(x.dtype), adapter["img_proj_fc_w"], adapter["img_proj_fc_b"])
    img = dense(quick_gelu(img), adapter["img_proj_out_w"], adapter["img_proj_out_b"])
    k = layer_norm(img, adapter["ln_k_scale"], adapter["ln_k_bias"])
    v = layer_norm(img, adapter["ln_v_scale"], adapter["ln_v_bias"])
    out = _cross_attention(q, k, v, adapter, n_head)
    pooled = layer_norm(out.mean(dim=1, keepdim=True), adapter["ln_out_scale"],
                        adapter["ln_out_bias"])
    return torch.cat([x[:, :n_ctx], x[:, n_ctx:] + pooled], dim=1)


def _cross_attention(q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
                     adapter: dict, n_head: int) -> torch.Tensor:
    """MHA cross-attention with packed qkv weights: the q slice projects the
    queries, the k and v slices the keys and values."""
    wq, wk, wv = adapter["w_qkv"].chunk(3, dim=-1)
    bq, bk, bv = adapter["b_qkv"].chunk(3)
    q = split_heads(dense(q_in, wq, bq), n_head)
    k = split_heads(dense(k_in, wk, bk), n_head)
    v = split_heads(dense(v_in, wv, bv), n_head)
    out = attention_plain(q, k, v)
    b, h, l, dh = out.shape
    return dense(out.permute(0, 2, 1, 3).reshape(b, l, h * dh), adapter["w_out"],
                 adapter["b_out"])
