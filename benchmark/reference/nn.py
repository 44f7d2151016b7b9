"""Plain PyTorch CLIP ViT towers and OVMR's visual token generator.

The equations of OpenAI CLIP's ``clip/model.py`` (``VisionTransformer``,
``CLIP.encode_text``, pre-LN ``ResidualAttentionBlock`` with QuickGELU) and
of OVMR's ``TransformerDropout`` aggregator, written once in float32 with
ordinary torch operations: no kernel, cache or batching of the program under
test, which this package never imports. Weights are the nested dicts the
benchmark makes (``[in, out]`` matrices, blocks stacked on a leading layer
axis), read in float32.

Every matrix product goes through :func:`mm`. Under ``precision("fp8")`` its
operands are rounded to float8 e4m3 first (per row of the left operand and per
column of the right one, each scaled to the format's range, with a
straight-through gradient): the precision below the configurations' bf16, the
control that a sound comparison has to fail.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_FP8 = contextvars.ContextVar("reference_fp8", default=False)
_E4M3_MAX = 448.0


@contextlib.contextmanager
def precision(name: str):
    """``"fp32"`` (the reference) or ``"fp8"`` (the control) inside the block."""
    if name not in ("fp32", "fp8"):
        raise ValueError(f"precision {name!r}")
    token = _FP8.set(name == "fp8")
    try:
        yield
    finally:
        _FP8.reset(token)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.float(), b.float()
    if _FP8.get():
        a, b = _fp8(a, -1), _fp8(b, -2)
    return a @ b


def layer_norm(x, g, b):
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), 1e-5)


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True)


def block(x, p, heads, causal=False, dropout=0.0, rand=None):
    """One pre-LN residual block. ``rand(shape)`` gives the U[0, 1) draws of
    the dropout masks, taken in the order attention probabilities, MLP hidden,
    MLP output; dropout keeps a value where its draw is below ``1 - dropout``
    and scales it by ``1 / (1 - dropout)``."""
    n, length, d = x.shape
    dh = d // heads

    def drop(t):
        if rand is None or dropout <= 0.0:
            return t
        keep = 1.0 - dropout
        return torch.where(rand(t.shape) < keep, t / keep, torch.zeros_like(t))

    h = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
    qkv = mm(h, p["w_qkv"]) + p["b_qkv"].float()
    q, k, v = (t.reshape(n, length, heads, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    s = mm(q * dh ** -0.5, k.transpose(-1, -2))
    if causal:
        s = s + torch.full((length, length), float("-inf"), device=x.device).triu(1)
    a = drop(torch.softmax(s, dim=-1))
    o = mm(a, v).transpose(1, 2).reshape(n, length, d)
    x = x + mm(o, p["w_out"]) + p["b_out"].float()
    h = layer_norm(x, p["ln_2_scale"], p["ln_2_bias"])
    h = mm(h, p["c_fc_w"]) + p["c_fc_b"].float()
    h = drop(h * torch.sigmoid(1.702 * h))
    h = drop(mm(h, p["c_proj_w"]) + p["c_proj_b"].float())
    return x + h


def layers(blocks):
    return [{k: v[i] for k, v in blocks.items()} for i in range(blocks["w_qkv"].shape[0])]


def encode_image(visual: dict, cfg: dict, images: torch.Tensor, chunk: int = 128):
    """NCHW float images -> unit image features [B, embed_dim], ``chunk``
    images at a time."""
    p = cfg["vision_patch_size"]
    heads = cfg["vision_width"] // 64
    outs = []
    for s in range(0, images.shape[0], chunk):
        x = images[s:s + chunk].float()
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        x = mm(x.reshape(b, (h // p) * (w // p), c * p * p), visual["patch_embed_w"])
        cls = visual["class_embedding"].float().expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + visual["positional_embedding"].float()
        x = layer_norm(x, visual["ln_pre_scale"], visual["ln_pre_bias"])
        for lp in layers(visual["blocks"]):
            x = block(x, lp, heads)
        x = layer_norm(x[:, 0], visual["ln_post_scale"], visual["ln_post_bias"])
        outs.append(l2n(mm(x, visual["proj"])))
    return torch.cat(outs)


def text_tower(text: dict, cfg: dict, embeds: torch.Tensor, eos: torch.Tensor):
    """Embeddings [N, 77, D] -> features at the ``eos`` positions [N, embed]."""
    x = embeds.float() + text["positional_embedding"].float()[: embeds.shape[1]]
    for lp in layers(text["blocks"]):
        x = block(x, lp, cfg["transformer_heads"], causal=True)
    x = layer_norm(x, text["ln_final_scale"], text["ln_final_bias"])
    return mm(x[torch.arange(x.shape[0], device=x.device), eos], text["text_projection"])


def aggregator(agg: dict, feats: torch.Tensor, dropout=0.0, rand=None):
    """Unit exemplar features [N, K, D] -> vokens [N, n_ctx, D]: the learned
    queries prepended, the blocks, the first n_ctx positions."""
    cls = agg["cls_token"].float()
    n_ctx, d = cls.shape
    x = torch.cat([cls.expand(feats.shape[0], n_ctx, d), feats.float()], dim=1)
    for lp in layers(agg["blocks"]):
        x = block(x, lp, d // 64, dropout=dropout, rand=rand)
    return x[:, :n_ctx]
