"""OVMR classifier generation: prompt splicing, classifier heads, fusion.

Counterpart of ``ovmr_tpu/models/ovmr.py`` (reference
``trainers/mm_classifier_one_prompt.py``):

1. tokenize ``"a {classname}."`` per class and the visual template ``"a ."``;
2. compress K normalized exemplar features per class into ``n_ctx`` vokens;
3. splice the vokens after the first two prompt positions:
   ``[tok[:, :2], vokens, tok[:, 2:77-n_ctx]]`` (reference ``:156-157``);
4. run the frozen text tower over the spliced embeddings, gathering at
   ``eot_idx + n_ctx`` for the multi-modal prompt and at ``1 + n_ctx`` for
   the vision prompt — the last voken, not the EOT: a reference quirk
   (``:165``) kept as is;
5. L2-normalize (twice, as the reference's prompt-group mean does) ->
   per-class classifier rows.

Fusion: per-class F1 of each classifier on the exemplars ->
``softmax(tau * F1)`` with column order (mm, v, t).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models.aggregator import generate_vokens
from ovmr_tpu_torch.ops.fusion import (
    fuse_probs,
    fusion_weights_from_f1,
    multiclass_f1,
    streaming_fusion_weights,
)
from ovmr_tpu_torch.ops.attention import fused_attention
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import l2_normalize

# The reference skips the frozen zero-shot text classifier at >= 5000
# classes (``mm_…:118-126``); ``max_text_classes`` overrides it upward.
TEXT_CLS_MAX_CLASSES = 5000


def build_prompt_tokens(classnames) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize ``"a {name}."`` per class plus the ``"a ."`` visual template.
    Returns (prompt_tokens [N,77] int32, eot_idx [N] int32, vis_tokens [77]
    int32); underscores become spaces (reference ``mm_…:109``)."""
    from ovmr_tpu_torch.text import eot_indices, tokenize

    names = [str(n).replace("_", " ") for n in classnames]
    prompt_tokens = tokenize([f"a {n}." for n in names])
    eot_idx = eot_indices(prompt_tokens).astype(np.int32)
    vis_tokens = tokenize(["a ."])[0]
    return prompt_tokens, eot_idx, vis_tokens


def splice_prompts(prompt_embeds: torch.Tensor, vokens: torch.Tensor) -> torch.Tensor:
    """[N, 77, D] embeddings + [N, n_ctx, D] vokens -> [N, 77, D] spliced."""
    n_ctx = vokens.shape[1]
    return torch.cat(
        [
            prompt_embeds[:, :2],
            vokens.to(prompt_embeds.dtype),
            prompt_embeds[:, 2 : prompt_embeds.shape[1] - n_ctx],
        ],
        dim=1,
    )


def classifier_heads(
    clip_params: dict,
    clip_cfg: tclip.CLIPConfig,
    agg_params: dict,
    exemplar_feats: torch.Tensor,
    prompt_embeds: torch.Tensor,
    vis_embeds: torch.Tensor,
    eot_idx: torch.Tensor,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attn_fn=fused_attention,
    block_fn=fused_residual_block,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """L2-normalized exemplar features [N, K, D] -> (mm_classifier [N,D],
    v_classifier [N,D], vokens [N, n_ctx, D]). ``dropout`` with a
    ``generator`` is the training path's aggregator dropout; serving leaves
    both at their defaults."""
    vokens = generate_vokens(
        agg_params, exemplar_feats, dropout=dropout, generator=generator, attn_fn=attn_fn
    )
    n_ctx = vokens.shape[1]
    mm_eos = eot_idx.long() + n_ctx
    v_eos = torch.full_like(mm_eos, 1 + n_ctx)  # reference quirk: last voken
    mm_feats = tclip.encode_text_embeds(
        clip_params, clip_cfg, splice_prompts(prompt_embeds, vokens), mm_eos,
        block_fn=block_fn,
    )
    v_feats = tclip.encode_text_embeds(
        clip_params, clip_cfg, splice_prompts(vis_embeds, vokens), v_eos,
        block_fn=block_fn,
    )
    return (
        l2_normalize(l2_normalize(mm_feats)),
        l2_normalize(l2_normalize(v_feats)),
        vokens,
    )


def text_classifier(
    clip_params: dict,
    clip_cfg: tclip.CLIPConfig,
    prompt_tokens: torch.Tensor,
    block_fn=fused_residual_block,
) -> torch.Tensor:
    """Frozen zero-shot text classifier: encode ``"a {name}."`` per class
    and L2-normalize (reference ``mm_…:118-125``)."""
    return l2_normalize(tclip.encode_text(clip_params, clip_cfg, prompt_tokens, block_fn=block_fn))


def prompt_embeddings(clip_params, feats, prompt_tokens, vis_tokens):
    """Prompt and visual-template token embeddings in the features' dtype.
    The vokens are spliced into these rows, so the image features must be
    as wide as the text tower: a backbone whose embed_dim differs (RN50:
    1024 against 512) raises here, as the JAX package's broadcast of the
    template row to ``[N, 77, D]`` does (``ovmr_tpu/models/ovmr.py:187``)."""
    pe = tclip.embed_tokens(clip_params, prompt_tokens).to(feats.dtype)
    ve = tclip.embed_tokens(clip_params, vis_tokens[None]).to(feats.dtype)
    want = (feats.shape[0], vis_tokens.shape[0], feats.shape[-1])
    if ve.shape[-1] != want[-1]:
        raise ValueError(f"Incompatible shapes for broadcasting: {tuple(ve.shape)} and "
                         f"requested shape {want}")
    return pe, ve.expand(want)


def generate_classifiers_from_feats(
    clip_params: dict,
    clip_cfg: tclip.CLIPConfig,
    agg_params: dict,
    exemplar_feats: torch.Tensor,
    prompt_tokens: torch.Tensor,
    eot_idx: torch.Tensor,
    vis_tokens: torch.Tensor,
    zero_shot_classifier: torch.Tensor,
    eval_tau: float,
    class_mask: Optional[torch.Tensor] = None,
    attn_fn=fused_attention,
    block_fn=fused_residual_block,
) -> dict:
    """All-class classifier generation + preference fusion. Returns
    ``mm_classifier``/``vision_classifier``/``text_classifier`` [N, D],
    ``fusion_weight`` [N, 3] (mm, v, t) and ``visual_tokens`` [N, n_ctx, D];
    ``class_mask`` False rows are padding classes."""
    prompt_embeds, vis_embeds = prompt_embeddings(
        clip_params, exemplar_feats, prompt_tokens, vis_tokens
    )
    mm_cls, v_cls, vokens = classifier_heads(
        clip_params, clip_cfg, agg_params, exemplar_feats, prompt_embeds,
        vis_embeds, eot_idx, attn_fn=attn_fn, block_fn=block_fn,
    )
    logit_scale = clip_params["logit_scale"].float().exp()
    fusion_weight = fusion_from_classifiers(
        exemplar_feats, mm_cls, v_cls, zero_shot_classifier, logit_scale, eval_tau,
        class_mask=class_mask,
    )
    if class_mask is not None:
        mm_cls = torch.where(class_mask[:, None], mm_cls, 0.0)
        v_cls = torch.where(class_mask[:, None], v_cls, 0.0)
    return {
        "mm_classifier": mm_cls,
        "vision_classifier": v_cls,
        "text_classifier": zero_shot_classifier,
        "fusion_weight": fusion_weight,
        "visual_tokens": vokens,
    }


def fusion_from_classifiers(
    exemplar_feats: torch.Tensor,
    mm_cls: torch.Tensor,
    v_cls: torch.Tensor,
    t_cls: torch.Tensor,
    logit_scale,
    eval_tau: float,
    class_mask: Optional[torch.Tensor] = None,
    row_chunk: int = 8192,
    mesh=None,
) -> torch.Tensor:
    """Preference-fusion weights from precomputed classifiers [N, 3]. Above
    ``row_chunk`` exemplar rows the logits stream over row chunks; per-row
    argmax does not depend on chunking, so both paths give the same F1.
    With a ``mesh`` whose data axis is > 1 the streamed rows shard over it
    (:func:`ovmr_tpu_torch.ops.fusion.streaming_fusion_weights_sharded`,
    JAX :242-281): the same bits."""
    n, k, d = exemplar_feats.shape
    m = n * k
    labels = torch.arange(n, device=exemplar_feats.device).repeat_interleave(k)
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=exemplar_feats.device)
    if mesh is not None and mesh.data.size > 1 and m > row_chunk:
        from ovmr_tpu_torch.ops.fusion import streaming_fusion_weights_sharded

        return streaming_fusion_weights_sharded(
            mesh.data, exemplar_feats.reshape(m, d), labels, (mm_cls, v_cls, t_cls), scale,
            eval_tau, class_mask=class_mask, row_chunk=row_chunk,
        )
    if m > row_chunk:
        return streaming_fusion_weights(
            exemplar_feats.reshape(m, d), labels, (mm_cls, v_cls, t_cls), scale,
            eval_tau, class_mask=class_mask, row_chunk=row_chunk,
        )
    flat = exemplar_feats.reshape(m, d).float()

    def cls_logits(cls_matrix):
        logits = scale * flat @ cls_matrix.float().T
        if class_mask is not None:
            logits = torch.where(class_mask[None, :], logits, float("-inf"))
        return logits

    return fusion_weights_from_f1(
        multiclass_f1(cls_logits(mm_cls), labels, n),
        multiclass_f1(cls_logits(v_cls), labels, n),
        multiclass_f1(cls_logits(t_cls), labels, n),
        eval_tau,
    )


def generate_classifiers_chunked(
    exemplar_feats: torch.Tensor,
    prompt_tokens: np.ndarray,
    eot_idx: np.ndarray,
    vis_tokens: np.ndarray,
    chunk: int,
    heads_fn: Callable,
    text_fn: Optional[Callable] = None,
    mesh=None,
) -> dict:
    """The chunked classifier-generation recipe: pads the class axis to a
    multiple of ``chunk`` with the visual-template row, runs the per-chunk
    callables and concatenates back to N rows (fp32 tensors on the device,
    so nothing waits for the device). Fusion is the caller's job (it needs
    the full class set).

    ``exemplar_feats`` [N, K, D] is a device tensor in the compute dtype;
    ``heads_fn(feats [c,K,D], ptok [c,77], eot [c]) -> (mm, v, vokens)``;
    ``text_fn(ptok [c,77]) -> [c, D]`` or None to skip the text head.
    With a ``mesh`` (:class:`ovmr_tpu_torch.parallel.mesh.Mesh`; ``chunk`` a
    multiple of its data axis) each chunk's classes shard over 'data' and
    the callables' outputs gather to every rank (JAX :323-340)."""
    from ovmr_tpu_torch.text import eot_indices

    device = exemplar_feats.device
    n_cls = exemplar_feats.shape[0]
    vis = np.asarray(vis_tokens)
    pad_n = -chunk * (-n_cls // chunk)
    ptok_p = np.tile(vis, (pad_n, 1)).astype(np.int32)
    ptok_p[:n_cls] = np.asarray(prompt_tokens)
    eot_p = np.full(pad_n, int(eot_indices(vis[None])[0]), np.int32)
    eot_p[:n_cls] = np.asarray(eot_idx)
    feats_p = exemplar_feats
    if pad_n > n_cls:
        feats_p = torch.nn.functional.pad(
            feats_p, (0, 0) * (feats_p.dim() - 1) + (0, pad_n - n_cls)
        )

    def run(fn, *arrays):
        if mesh is None:
            return fn(*arrays)
        from ovmr_tpu_torch.parallel.mesh import map_data_shards

        return map_data_shards(mesh, fn, *arrays)

    mm_parts, v_parts, vt_parts, t_parts = [], [], [], []
    for start in range(0, pad_n, chunk):
        sl = slice(start, start + chunk)
        ptok_c = torch.as_tensor(ptok_p[sl], device=device)
        if text_fn is not None:
            t_parts.append(run(text_fn, ptok_c))
        mm_c, v_c, vt_c = run(
            heads_fn, feats_p[sl], ptok_c, torch.as_tensor(eot_p[sl], device=device)
        )
        mm_parts.append(mm_c)
        v_parts.append(v_c)
        vt_parts.append(vt_c)

    def cat(parts):
        return torch.cat(parts).float()[:n_cls]

    out = {
        "mm_classifier": cat(mm_parts),
        "vision_classifier": cat(v_parts),
        "visual_tokens": cat(vt_parts),
    }
    if text_fn is not None:
        out["text_classifier"] = cat(t_parts)
    return out


def _require_text_head(classifiers: dict, mode: str) -> None:
    """Refuse text/fusion eval against an artifact whose text head was
    skipped by the >=5000-class guard, instead of a raw KeyError."""
    needed = {"text": ("text_classifier",),
              "fusion": ("text_classifier", "fusion_weight")}.get(mode, ())
    missing = [k for k in needed if k not in classifiers]
    if missing:
        raise ValueError(
            f"eval mode {mode!r} needs {', '.join(missing)}, which this "
            "artifact omits (generated at >= TEXT_CLS_MAX_CLASSES classes "
            "— the reference >=5000-class guard). Use vision/multimodal, or "
            "regenerate with a higher max_text_classes."
        )


def eval_logits_np(
    image_feats: np.ndarray, classifiers: dict, logit_scale: float, mode: str
) -> np.ndarray:
    """Host-side numpy twin of :func:`eval_logits` for [B, D] features."""
    _require_text_head(classifiers, mode)

    def probs(cls):
        logits = float(logit_scale) * image_feats.astype(np.float32) @ np.asarray(
            cls, np.float32
        ).T
        logits -= logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(axis=-1, keepdims=True)

    if mode == "text":
        return probs(classifiers["text_classifier"])
    if mode == "vision":
        return probs(classifiers["vision_classifier"])
    if mode == "multimodal":
        return probs(classifiers["mm_classifier"])
    if mode == "fusion":
        three = np.stack(
            [
                probs(classifiers["mm_classifier"]),
                probs(classifiers["vision_classifier"]),
                probs(classifiers["text_classifier"]),
            ],
            axis=-1,
        )
        return (three * np.asarray(classifiers["fusion_weight"], np.float32)[None]).sum(-1)
    raise ValueError(f"unknown EVAL_MODE {mode!r}")


def eval_logits(
    image_feats: torch.Tensor, classifiers: dict, logit_scale, mode: str
) -> torch.Tensor:
    """Per-mode softmaxed scores over normalized image features [B, D]
    (reference ``mm_…:348-363``)."""
    _require_text_head(classifiers, mode)
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=image_feats.device)
    feats = image_feats.float()

    def probs(cls):
        return torch.softmax(scale * feats @ cls.float().T, dim=-1)

    if mode == "text":
        return probs(classifiers["text_classifier"])
    if mode == "vision":
        return probs(classifiers["vision_classifier"])
    if mode == "multimodal":
        return probs(classifiers["mm_classifier"])
    if mode == "fusion":
        return fuse_probs(
            probs(classifiers["mm_classifier"]),
            probs(classifiers["vision_classifier"]),
            probs(classifiers["text_classifier"]),
            classifiers["fusion_weight"],
        )
    raise ValueError(f"unknown EVAL_MODE {mode!r}")
