"""The OVMR training step.

Counterpart of ``ovmr_tpu/engine/train_step.py`` ``make_train_step`` :53-149
(reference ``forward_backward``, ``trainers/mm_classifier_one_prompt.py:294-338,
421-452``):

- a class-grouped batch [num_cls, n_ins, 3, H, W] is split at
  ``split_point`` into query and exemplar instances;
- both halves run through the frozen CLIP image tower, and the prompt
  tokens through the token embedding, under ``torch.no_grad()``;
- exemplar features -> vokens (dropout active) -> mm/v classifiers through
  the frozen text tower: gradients flow through the text tower (its dx
  kernels K4 and K3) into the vokens and the aggregator, and nowhere else;
- loss = CE(mm_logits) + CE(v_logits) in fp32, with within-batch labels
  ``arange(num_cls)`` repeated per query instance;
- one optimizer update of the aggregator leaves, in place.

The aggregator leaves are ``requires_grad`` tensors owned by the
``torch.optim`` optimizer, which also holds the moments, so the step takes
the optimizer where the JAX step takes ``opt_state`` and returns the loss
only. The on-device augmentation branch (``DEVICE_AUGS``) and the
multi-device step are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.ops.attention import fused_attention
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import (
    l2_normalize,
    residual_attention_block,
    residual_block_remat,
)


def _text_tower_block_fn(block_fn):
    """Block fn for the differentiated text tower: the kernel block
    rematerialises per layer by construction; the torch-math block gets a
    per-layer checkpoint so 12 layers of intermediates are not kept
    (``_text_tower_block_fn`` :39-50)."""
    if block_fn is residual_attention_block:
        return residual_block_remat
    return block_fn


def frozen_features(clip_params, clip_cfg, images, prompt_tokens, vis_tokens, split_point,
                    block_fn=fused_residual_block):
    """The step's part without gradients (:94-122): normalized query
    features [num_cls * split, D], exemplar features [num_cls, n_ins - split,
    D], prompt and visual-template embeddings, labels and the logit scale."""
    num_cls, n_ins = images.shape[:2]
    img_shape = images.shape[2:]
    with torch.no_grad():
        query = images[:, :split_point].reshape(num_cls * split_point, *img_shape)
        exemplar = images[:, split_point:].reshape(num_cls * (n_ins - split_point), *img_shape)
        q_feats = l2_normalize(tclip.encode_image(clip_params, clip_cfg, query, block_fn=block_fn))
        e_feats = l2_normalize(
            tclip.encode_image(clip_params, clip_cfg, exemplar, block_fn=block_fn)
        ).reshape(num_cls, n_ins - split_point, -1)
        prompt_embeds, vis_embeds = ovmr.prompt_embeddings(
            clip_params, e_feats, prompt_tokens, vis_tokens
        )
        labels = torch.arange(num_cls, device=images.device).repeat_interleave(split_point)
        logit_scale = clip_params["logit_scale"].float().exp()
    return q_feats, e_feats, prompt_embeds, vis_embeds, labels, logit_scale


def classifier_loss(clip_params, clip_cfg, agg_params, frozen, eot_idx, dropout=0.0,
                    generator: Optional[torch.Generator] = None,
                    attn_fn=fused_attention, block_fn=fused_residual_block):
    """CE(mm) + CE(v) of the query features against the classifiers the
    aggregator generates from the exemplar features (:124-142); the only
    differentiated part of the step."""
    q_feats, e_feats, prompt_embeds, vis_embeds, labels, logit_scale = frozen
    mm_cls, v_cls, _ = ovmr.classifier_heads(
        clip_params, clip_cfg, agg_params, e_feats, prompt_embeds, vis_embeds, eot_idx,
        dropout=dropout, generator=generator, attn_fn=attn_fn,
        block_fn=_text_tower_block_fn(block_fn),
    )
    qf = q_feats.float()
    mm_logits = logit_scale * qf @ mm_cls.float().T
    v_logits = logit_scale * qf @ v_cls.float().T
    return F.cross_entropy(mm_logits, labels) + F.cross_entropy(v_logits, labels)


def make_train_step(
    clip_cfg: tclip.CLIPConfig,
    dropout: float = 0.1,
    attn_fn=fused_attention,
    block_fn=fused_residual_block,
):
    """Returns ``train_step(agg_params, optimizer, clip_params, images,
    prompt_tokens, eot_idx, vis_tokens, generator, split_point) -> loss``.
    ``images`` is [num_cls, n_ins, 3, H, W]; ``generator`` seeds the dropout
    masks (on the tensors' device; None switches dropout off);
    ``agg_params`` holds the leaves ``optimizer`` updates in place."""

    def train_step(agg_params, optimizer, clip_params, images, prompt_tokens, eot_idx,
                   vis_tokens, generator, split_point: int):
        frozen = frozen_features(
            clip_params, clip_cfg, images, prompt_tokens, vis_tokens, split_point,
            block_fn=block_fn,
        )
        optimizer.zero_grad(set_to_none=True)
        loss = classifier_loss(
            clip_params, clip_cfg, agg_params, frozen, eot_idx, dropout=dropout,
            generator=generator, attn_fn=attn_fn, block_fn=block_fn,
        )
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def sample_split_point(py_rng, n_ins: int) -> int:
    """split_point ~ U[n_ins//4, 3*n_ins//4) (reference ``mm_…:300``), drawn
    on the host from a numpy ``Generator`` or a ``random.Random``."""
    lo, hi = n_ins // 4, (3 * n_ins) // 4
    return int(py_rng.integers(lo, hi)) if hasattr(py_rng, "integers") else int(
        py_rng.randint(lo, hi - 1)
    )
