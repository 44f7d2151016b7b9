"""The serving seams of the MM_CLS_OP trainer, with an optional model axis.

Counterparts of the module-level seams of ``ovmr_tpu/engine/trainer.py``
and of the body of ``MM_CLS_OP.generate_classifiers`` (the trainer class
itself comes with the trainer work):

- :func:`tp_seam_tools` (``:221-232``): the TP block and the towers placed
  for a :class:`ovmr_tpu_torch.parallel.ModelAxis`;
- :func:`make_feature_extractor` (``:235-371``): the eval encode, float and
  uint8 batches, ragged batches padded to the batch size;
- :func:`mm_generate_classifiers` (``:957-1031``): classifier generation
  from exemplar features, class-chunked, with the text-head guard, the
  preference fusion and the export.

:func:`encode_features` and :func:`mm_generate_classifiers` are also the
bodies of :class:`ovmr_tpu_torch.api.OVMRGenerator`'s encode and
generation, with the single-device block.

Under a model axis the JAX package runs its seams inside ``shard_map`` over
'model' and swaps the aggregator's Pallas attention for ``attention_xla``
(``:195``, ``:269``) because ``pallas_call`` has no SPMD partitioning rule.
Nothing here is partitioned by a compiler: the TP block calls the per-shard
kernels itself, so the aggregator keeps its kernel (K6) under TP too.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import l2_normalize
from ovmr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, normalize_u8
from ovmr_tpu_torch.parallel.mesh import pad_to_multiple


def tp_seam_tools(axis, clip_params: dict, clip_cfg: tclip.CLIPConfig):
    """``(tp_block_fn, seam_params)`` for the seams below. With a model axis
    of size > 1: the TP block over this process's shards
    (:func:`ovmr_tpu_torch.ops.block_fused_tp.make_tp_block`) and the towers
    split, head-padded where the heads do not divide the axis, and placed as
    this process's shards; the placed towers take the place of the JAX
    package's PartitionSpec tree. Without one: ``(None, clip_params)``."""
    if axis is None or axis.size <= 1:
        return None, clip_params
    from ovmr_tpu_torch.ops.block_fused_tp import make_tp_block, split_clip_qkv
    from ovmr_tpu_torch.parallel.mesh import place_tower_params

    placed = place_tower_params(axis, split_clip_qkv(clip_params, axis.size, clip_cfg))
    return make_tp_block(axis), placed


def encode_features(
    clip_params: dict,
    clip_cfg: tclip.CLIPConfig,
    images: torch.Tensor,
    dtype,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
    block_fn=fused_residual_block,
) -> torch.Tensor:
    """Unit image features [n, D] in ``dtype``, on the device of
    ``images``: a float NCHW batch is cast to ``dtype``, a uint8 NHWC batch
    normalised with ``mean``/``std`` first."""
    if images.dtype == torch.uint8:
        x = normalize_u8(images, tuple(mean), tuple(std), dtype).permute(0, 3, 1, 2)
    else:
        x = images.to(dtype)
    return l2_normalize(tclip.encode_image(clip_params, clip_cfg, x, block_fn=block_fn))


def make_feature_extractor(
    clip_cfg: tclip.CLIPConfig,
    dtype,
    mean: Sequence[float],
    std: Sequence[float],
    batch_size: int,
    device="cuda",
    u8_normalize: bool = True,
    tp_block_fn=None,
):
    """Returns ``encode(clip_params, images) -> L2-normalised fp32 features
    [n, D]`` (numpy), by :func:`encode_features`.

    ``images`` (numpy or tensor) is a float NCHW batch or a uint8 NHWC one,
    normalised on the device; with ``u8_normalize=False`` a uint8 batch is
    only scaled to [0, 1], as a config whose transforms omit "normalize"
    does on the float path. A batch of fewer than ``batch_size`` images is
    padded with zeros to ``batch_size``, so the kernels run at one shape.
    With ``tp_block_fn`` (:func:`tp_seam_tools`) the vision tower runs the
    TP block on towers placed for its model axis."""
    from ovmr_tpu_torch.api import resolve_device

    device = resolve_device(device)
    if not u8_normalize:
        mean, std = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    block_fn = fused_residual_block if tp_block_fn is None else tp_block_fn

    @torch.inference_mode()
    def encode(clip_params: dict, images) -> np.ndarray:
        images = torch.as_tensor(images)
        n = images.shape[0]
        if n < batch_size:
            pad = images.new_zeros((batch_size - n, *images.shape[1:]))
            images = torch.cat([images, pad])
        feats = encode_features(clip_params, clip_cfg, images.to(device), dtype, mean, std,
                                block_fn=block_fn)
        return feats.float().cpu().numpy()[:n]

    return encode


@torch.inference_mode()
def mm_generate_classifiers(
    clip_params: dict,
    clip_cfg: tclip.CLIPConfig,
    agg_params: dict,
    exemplar_feats,
    prompt_tokens: np.ndarray,
    eot_idx: np.ndarray,
    vis_tokens: np.ndarray,
    eval_tau: float,
    class_chunk: int = 2048,
    class_pad_multiple: int = 8,
    text_cls_max_classes: int = ovmr.TEXT_CLS_MAX_CLASSES,
    block_fn=fused_residual_block,
    output_dir: Optional[str] = None,
) -> dict:
    """Exemplar features [N, K, D] -> the classifier artifact, as
    ``MM_CLS_OP.generate_classifiers`` makes it from its features.

    The class axis is padded to a multiple of the chunk, ``min(class_chunk,
    N padded to class_pad_multiple)``, and the heads (and the frozen text
    classifier) run one chunk at a time
    (:func:`ovmr_tpu_torch.models.ovmr.generate_classifiers_chunked`); the
    preference fusion then runs once over the full set. At
    ``text_cls_max_classes`` classes or more the text head and the fusion
    are skipped (the reference's >=5000-class guard). The features go to the
    device once, in the towers' dtype (the reference stores its
    cross-validation features in half precision too). ``block_fn`` is the
    TP block under a model axis (:func:`tp_seam_tools`); ``output_dir``
    writes ``mm_classifiers.pt`` and ``visual_tokens.pt``. Returns numpy
    fp32 arrays."""
    n_cls = exemplar_feats.shape[0]
    chunk = min(int(class_chunk), pad_to_multiple(n_cls, int(class_pad_multiple)))
    include_text = n_cls < int(text_cls_max_classes)
    if not include_text:
        warnings.warn(
            f"Skipping frozen text classifier: {n_cls} classes >= text_cls_max_classes "
            f"({text_cls_max_classes}, the reference >=5000-class guard). text/fusion eval "
            "modes are unavailable; mm_classifiers.pt will omit text_classifier and "
            "fusion_weight."
        )
    token_embedding = clip_params["text"]["token_embedding"]
    device = token_embedding.device
    feats = torch.as_tensor(exemplar_feats, device=device).to(token_embedding.dtype)
    vis = torch.as_tensor(np.asarray(vis_tokens), device=device)

    def heads_fn(f, pt, et):
        pe, ve = ovmr.prompt_embeddings(clip_params, f, pt, vis)
        return ovmr.classifier_heads(clip_params, clip_cfg, agg_params, f, pe, ve, et,
                                     block_fn=block_fn)

    def text_fn(pt):
        return ovmr.text_classifier(clip_params, clip_cfg, pt, block_fn=block_fn)

    out = ovmr.generate_classifiers_chunked(
        feats, prompt_tokens, eot_idx, vis_tokens, chunk, heads_fn,
        text_fn=text_fn if include_text else None,
    )
    if include_text:
        out["fusion_weight"] = ovmr.fusion_from_classifiers(
            feats, out["mm_classifier"], out["vision_classifier"], out["text_classifier"],
            clip_params["logit_scale"].float().exp(), float(eval_tau),
        ).float()
    out = {k: v.cpu().numpy() for k, v in out.items()}
    if output_dir is not None:
        from ovmr_tpu_torch.engine.checkpoint import export_classifiers_torch

        export_classifiers_torch(out, output_dir)
    return out
