"""CLIP ViT towers (image encoder + causal text encoder) in PyTorch.

Counterpart of ``ovmr_tpu/models/clip.py`` (reference ``clip/model.py``
VisionTransformer and CLIP.encode_text):

- pure functions over a nested dict of tensors with the JAX package's key
  names; transformer blocks are stacked along a leading layer axis and run
  by :func:`run_blocks`, a Python loop over layers with a pluggable
  ``block_fn`` (the hand-written kernels of
  :mod:`ovmr_tpu_torch.ops.block_fused` on the serving path);
- patch embedding is a reshape plus one fp32 matrix product (a stride-p
  convolution with kernel p is exactly that), so no cuDNN convolution and
  its default TF32 arithmetic is involved;
- activations are batch-major ``[B, L, D]``; weights right-multiply
  (``x @ W``, W stored ``[in, out]``).

ModifiedResNet image towers (``RN*`` configs) dispatch to
:mod:`ovmr_tpu_torch.models.resnet`; their text towers are these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import causal_mask, l2_normalize, layer_norm, matmul_f32
from ovmr_tpu_torch.ops.quant import QUANT_KEYS
from ovmr_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision: int layer count = ViT; 4-tuple of stage depths = ModifiedResNet
    image_resolution: int = 224
    vision_layers: object = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, tuple)

    @property
    def vision_heads(self) -> int:
        if self.is_resnet:
            # reference: vision_heads = vision_width * 32 // 64
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


VIT_B16 = CLIPConfig()
VIT_B32 = CLIPConfig(vision_patch_size=32)
VIT_L14 = CLIPConfig(
    embed_dim=768,
    vision_layers=24,
    vision_width=1024,
    vision_patch_size=14,
    transformer_width=768,
    transformer_heads=12,
    transformer_layers=12,
)
VIT_L14_336 = CLIPConfig(
    embed_dim=768,
    image_resolution=336,
    vision_layers=24,
    vision_width=1024,
    vision_patch_size=14,
    transformer_width=768,
    transformer_heads=12,
    transformer_layers=12,
)
# test-scale configs of the JAX package (same shapes)
TINY_TP = CLIPConfig(
    embed_dim=64,
    image_resolution=32,
    vision_layers=2,
    vision_width=128,
    vision_patch_size=16,
    transformer_width=64,
    transformer_heads=2,
    transformer_layers=2,
)
TINY = CLIPConfig(
    embed_dim=64,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    transformer_width=64,
    transformer_heads=2,
    transformer_layers=2,
)

# test-scale ModifiedResNet: the vision tower of the golden fixture
# ``tests/fixtures/clip_rn_tiny_golden.npz`` (layers (1,1,1,1), width 8,
# 64 px), a TINY text tower with the real vocabulary
TINY_RN = CLIPConfig(
    embed_dim=64,
    image_resolution=64,
    vision_layers=(1, 1, 1, 1),
    vision_width=8,
    vision_patch_size=0,
    transformer_width=64,
    transformer_heads=2,
    transformer_layers=2,
)

# the ModifiedResNet family (the public OpenAI CLIP hyperparameters, as
# the checkpoints' shapes give them; reference ``clip/model.py:870-886``)
RN50 = CLIPConfig(
    embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64, vision_patch_size=0,
)
RN101 = CLIPConfig(
    embed_dim=512, vision_layers=(3, 4, 23, 3), vision_width=64, vision_patch_size=0,
)
RN50x4 = CLIPConfig(
    embed_dim=640, image_resolution=288, vision_layers=(4, 6, 10, 6), vision_width=80,
    vision_patch_size=0, transformer_width=640, transformer_heads=10,
)
RN50x16 = CLIPConfig(
    embed_dim=768, image_resolution=384, vision_layers=(6, 8, 18, 8), vision_width=96,
    vision_patch_size=0, transformer_width=768, transformer_heads=12,
)
RN50x64 = CLIPConfig(
    embed_dim=1024, image_resolution=448, vision_layers=(3, 15, 36, 10), vision_width=128,
    vision_patch_size=0, transformer_width=1024, transformer_heads=16,
)

CONFIGS = {
    "ViT-B/16": VIT_B16,
    "ViT-B/32": VIT_B32,
    "ViT-L/14": VIT_L14,
    "ViT-L/14@336px": VIT_L14_336,
    "RN50": RN50,
    "RN101": RN101,
    "RN50x4": RN50x4,
    "RN50x16": RN50x16,
    "RN50x64": RN50x64,
    "TINY": TINY,
    "TINY_TP": TINY_TP,
    "TINY_RN": TINY_RN,
}


# --------------------------------------------------------------------------
# parameter init (reference CLIP.initialize_parameters scales)
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) * std).to(dtype)


def _init_blocks(gen: torch.Generator, n_layers: int, width: int, dtype) -> dict:
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    zeros = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    ones = lambda *s: torch.ones(s, dtype=dtype)  # noqa: E731
    return {
        "w_qkv": _normal(gen, (n_layers, width, 3 * width), attn_std, dtype),
        "b_qkv": zeros(n_layers, 3 * width),
        "w_out": _normal(gen, (n_layers, width, width), proj_std, dtype),
        "b_out": zeros(n_layers, width),
        "ln_1_scale": ones(n_layers, width),
        "ln_1_bias": zeros(n_layers, width),
        "c_fc_w": _normal(gen, (n_layers, width, 4 * width), fc_std, dtype),
        "c_fc_b": zeros(n_layers, 4 * width),
        "c_proj_w": _normal(gen, (n_layers, 4 * width, width), proj_std, dtype),
        "c_proj_b": zeros(n_layers, width),
        "ln_2_scale": ones(n_layers, width),
        "ln_2_bias": zeros(n_layers, width),
    }


def init_params(
    cfg: CLIPConfig,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cpu",
) -> dict:
    """Seeded random towers with the reference init scales. Values are
    drawn on the CPU from ``generator`` (or a CPU generator seeded with
    ``seed``), so one seed gives the same weights on every device; they do
    not equal the JAX package's ``init_params`` values (another RNG)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    vw, tw = cfg.vision_width, cfg.transformer_width
    vscale = vw ** -0.5
    if cfg.is_resnet:
        from ovmr_tpu_torch.models.resnet import init_resnet_visual

        visual = init_resnet_visual(gen, cfg, dtype)
    else:
        visual = {
            "patch_embed_w": _normal(gen, (3 * cfg.vision_patch_size ** 2, vw), vscale, dtype),
            "class_embedding": _normal(gen, (vw,), vscale, dtype),
            "positional_embedding": _normal(gen, (cfg.num_patches + 1, vw), vscale, dtype),
            "ln_pre_scale": torch.ones(vw, dtype=dtype),
            "ln_pre_bias": torch.zeros(vw, dtype=dtype),
            "blocks": _init_blocks(gen, cfg.vision_layers, vw, dtype),
            "ln_post_scale": torch.ones(vw, dtype=dtype),
            "ln_post_bias": torch.zeros(vw, dtype=dtype),
            "proj": _normal(gen, (vw, cfg.embed_dim), vscale, dtype),
        }
    text = {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02, dtype),
        "positional_embedding": _normal(gen, (cfg.context_length, tw), 0.01, dtype),
        "blocks": _init_blocks(gen, cfg.transformer_layers, tw, dtype),
        "ln_final_scale": torch.ones(tw, dtype=dtype),
        "ln_final_bias": torch.zeros(tw, dtype=dtype),
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5, dtype),
    }
    params = {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32),
    }
    return tree_to(params, device=device)


def tree_to(tree, device=None, dtype=None):
    """Move (and optionally cast) every tensor leaf of a nested dict (the
    ResNet towers' stages are lists)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def run_blocks(
    x: torch.Tensor,
    blocks: dict,
    n_head: int,
    mask: Optional[torch.Tensor] = None,
    block_fn=fused_residual_block,
) -> torch.Tensor:
    """Loop over the stacked transformer blocks ([n_layers, ...] leaves),
    each one ``block_fn(h, layer_params, n_head, mask)``: the kernels K1 and
    K2 by default (their plain versions for a CPU tensor), or the
    torch-math :func:`ovmr_tpu_torch.ops.layers.residual_attention_block`,
    or on towers placed for a model axis the TP block of
    :func:`ovmr_tpu_torch.ops.block_fused_tp.make_tp_block` (each layer's
    slice then holds its shards)."""
    for i in range(blocks["ln_1_scale"].shape[0]):
        x = block_fn(x, {k: v[i] for k, v in blocks.items()}, n_head, mask)
    return x


def patch_embed_grid(images: torch.Tensor, w: torch.Tensor, patch: int,
                     layout: str = "NCHW") -> torch.Tensor:
    """Images (NCHW, or NHWC as the augmentation emits them) -> [B, gh, gw,
    width] patch embeddings, fp32 accumulation. ``w`` is [3*p*p, width]
    with rows in (channel, row, column) order; both layouts patchify into
    that order, so the NHWC batch needs no relayout before this."""
    if layout == "NCHW":
        b, c, hgt, wid = images.shape
        gh, gw = hgt // patch, wid // patch
        x = images[:, :, : gh * patch, : gw * patch]
        x = x.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    elif layout == "NHWC":
        b, hgt, wid, c = images.shape
        gh, gw = hgt // patch, wid // patch
        x = images[:, : gh * patch, : gw * patch, :]
        x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    else:
        raise ValueError(f"layout {layout!r}: expected NCHW or NHWC")
    x = x.reshape(b, gh, gw, c * patch * patch)
    return matmul_f32(x, w.to(images.dtype)).to(images.dtype)


def _resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """[in, out] weights of ``jax.image.resize``'s bilinear (triangle)
    kernel with antialiasing, half-pixel centres and edge renormalisation."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = (1.0 - dist / kernel_scale).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_pos_embed(pe: torch.Tensor, grid: int, gh: int, gw: int) -> torch.Tensor:
    """Bilinear-resize a [1+grid^2, D] positional table to [1+gh*gw, D]
    (CLS row untouched), as ``jax.image.resize(..., "bilinear")`` does;
    identity at the native grid."""
    if (gh, gw) == (grid, grid):
        return pe
    cls_row, spatial = pe[:1], pe[1:].reshape(grid, grid, -1).float()
    wh = _resize_weights(grid, gh).to(pe.device)
    ww = _resize_weights(grid, gw).to(pe.device)
    resized = torch.einsum("hH,wW,hwd->HWd", wh, ww, spatial)
    return torch.cat([cls_row, resized.reshape(gh * gw, -1).to(pe.dtype)], dim=0)


def encode_image(
    params: dict,
    cfg: CLIPConfig,
    images: torch.Tensor,
    block_fn=fused_residual_block,
    layout: str = "NCHW",
) -> torch.Tensor:
    """Image tower forward: patchify -> +cls/pos -> ln_pre -> blocks ->
    ln_post[0] @ proj (reference ``clip/model.py:411-428``). [B, embed_dim].
    ``images`` is NCHW, or NHWC with ``layout="NHWC"``."""
    if cfg.is_resnet:
        from ovmr_tpu_torch.models.resnet import encode_image_resnet

        if layout == "NHWC":
            images = images.permute(0, 3, 1, 2)
        return encode_image_resnet(params, images, cfg.vision_heads)
    v = params["visual"]
    dtype = v["patch_embed_w"].dtype
    xg = patch_embed_grid(images.to(dtype), v["patch_embed_w"], cfg.vision_patch_size,
                          layout)
    b, gh, gw, width = xg.shape
    cls = v["class_embedding"].to(dtype).expand(b, 1, width)
    x = torch.cat([cls, xg.reshape(b, gh * gw, width)], dim=1)
    x = x + resize_pos_embed(v["positional_embedding"], cfg.grid_size, gh, gw).to(dtype)
    x = layer_norm(x, v["ln_pre_scale"], v["ln_pre_bias"])
    x = run_blocks(x, v["blocks"], cfg.vision_heads, block_fn=block_fn)
    pooled = layer_norm(x[:, 0, :], v["ln_post_scale"], v["ln_post_bias"])
    return matmul_f32(pooled, v["proj"].to(dtype)).to(dtype)


def encode_text(
    params: dict, cfg: CLIPConfig, tokens: torch.Tensor, block_fn=fused_residual_block
) -> torch.Tensor:
    """Text forward on token ids [B, 77]; EOT feature via argmax gather
    (reference ``clip/model.py:820-833``)."""
    x = embed_tokens(params, tokens)
    eos_index = tokens.argmax(dim=-1)
    return encode_text_embeds(params, cfg, x, eos_index, block_fn=block_fn)


def encode_text_embeds(
    params: dict,
    cfg: CLIPConfig,
    embeds: torch.Tensor,
    eos_index: torch.Tensor,
    block_fn=fused_residual_block,
) -> torch.Tensor:
    """Prompt-side text forward on embeddings [B, L, D]: positional
    embedding sliced to L, causal mask, explicit EOT gather index
    (reference ``trainers/mm_classifier_one_prompt.py:63-91``)."""
    with trace.span("text_tower"):
        t = params["text"]
        dtype = embeds.dtype
        length = embeds.shape[1]
        x = embeds + t["positional_embedding"][:length].to(dtype)
        mask = causal_mask(length, device=x.device)
        x = run_blocks(x, t["blocks"], cfg.transformer_heads, mask=mask, block_fn=block_fn)
        x = layer_norm(x, t["ln_final_scale"], t["ln_final_bias"])
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_index.long()]
        return matmul_f32(pooled, t["text_projection"].to(dtype)).to(dtype)


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding lookup [B, L] -> [B, L, D]."""
    return params["text"]["token_embedding"][tokens.long()]


def clip_forward(params: dict, cfg: CLIPConfig, images: torch.Tensor, tokens: torch.Tensor,
                 block_fn=fused_residual_block, out_dtype=None):
    """Contrastive forward (reference ``clip/model.py:835-849``): returns
    (logits_per_image [B, N], logits_per_text [N, B]) in the towers' dtype,
    or in ``out_dtype`` where given (the normalised features are cast to it
    before the product)."""
    img = l2_normalize(encode_image(params, cfg, images, block_fn=block_fn))
    txt = l2_normalize(encode_text(params, cfg, tokens, block_fn=block_fn))
    if out_dtype is not None:
        img, txt = img.to(out_dtype), txt.to(out_dtype)
    scale = params["logit_scale"].exp().to(img.dtype)
    logits_per_image = scale * img @ txt.T
    return logits_per_image, logits_per_image.T


# the int8 dequantization scales, not LayerNorm's ``*_scale``
QUANT_SCALE_KEYS = frozenset(key + "_scale" for key in QUANT_KEYS)


def cast_params(params: dict, dtype) -> dict:
    """Cast floating leaves to ``dtype``, keeping ``logit_scale`` and the
    int8 dequantization scales fp32 (``ovmr_tpu/models/clip.py:482-500``;
    LayerNorm upcasts its params itself)."""

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        if not tree.is_floating_point() or key in QUANT_SCALE_KEYS:
            return tree
        return tree.to(dtype)

    out = {k: cast(v) for k, v in params.items() if k != "logit_scale"}
    out["logit_scale"] = params["logit_scale"]
    return out
