"""Per-class F1 and preference-based fusion math (single device).

Counterpart of ``ovmr_tpu/ops/fusion.py`` (reference
``trainers/mm_classifier_one_prompt.py:261-274, 357-363``): per-class
multiclass F1 of each classifier on the exemplar set itself ->
``softmax(tau * F1)`` over the (mm, v, t) classifiers -> a per-class blend
of the softmaxed logits. F1 semantics match ``torcheval``'s
``multiclass_f1_score(average=None)``: 0 where a class has neither support
nor predictions.

Everything is computed from [C] count vectors, never an [M, C] one-hot;
the exemplar-row logits are the one [rows, C] tensor, and
:func:`streaming_fusion_weights` bounds it to ``row_chunk`` rows at a time;
:func:`streaming_fusion_weights_sharded` splits the rows over a data axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def f1_from_counts(
    tp: torch.Tensor, pred_count: torch.Tensor, label_count: torch.Tensor
) -> torch.Tensor:
    """Per-class F1 from [C] count vectors: 2tp / (2tp + fp + fn)."""
    denom = pred_count + label_count  # == 2tp + fp + fn
    f1 = 2.0 * tp.float() / torch.clamp(denom, min=1.0)
    return torch.where(denom > 0, f1, torch.zeros_like(f1)).float()


def _weighted_count(idx: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.bincount(idx, w, length=n)``: indices >= n are dropped.
    ``torch.bincount`` grows instead of clamping, so count into n + 1
    bins (n = the padding/miss marker) and keep the first n."""
    idx = torch.clamp(idx.long(), max=n)
    return torch.bincount(idx, weights=w, minlength=n + 1)[:n].float()


def f1_counts_from_preds(
    preds: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tp, pred_count, label_count) [C] from argmax predictions.
    ``weights`` marks row validity (0.0 for padding rows); labels equal to
    ``num_classes`` (padding markers) are dropped."""
    w = (
        torch.ones(preds.shape, dtype=torch.float32, device=preds.device)
        if weights is None
        else weights.float()
    )
    correct = torch.where(preds == labels, labels, torch.full_like(labels, num_classes))
    tp = _weighted_count(correct, w, num_classes)
    pred_count = _weighted_count(preds, w, num_classes)
    label_count = _weighted_count(labels, w, num_classes)
    return tp, pred_count, label_count


def multiclass_f1(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class F1 from argmax predictions. logits [M, C], labels [M] -> [C]."""
    preds = logits.argmax(dim=-1)
    return f1_from_counts(*f1_counts_from_preds(preds, labels, num_classes))


def fusion_weights_from_f1(
    f1_mm: torch.Tensor, f1_v: torch.Tensor, f1_t: torch.Tensor, tau: float
) -> torch.Tensor:
    """Stack per-class F1 of (mm, vision, text) -> softmax(tau * F1) [C, 3].
    Column order (mm, v, t) is the reference's (``mm_…:272``)."""
    stacked = torch.stack([f1_mm, f1_v, f1_t], dim=-1).float()
    return torch.softmax(tau * stacked, dim=-1)


def _pad_rows(
    flat_feats: torch.Tensor, labels: torch.Tensor, n: int, pad_m: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad exemplar rows to ``pad_m``: label marker ``n`` + zero validity
    weight, so padding rows contribute nothing to the counts."""
    m = flat_feats.shape[0]
    feats_p = torch.nn.functional.pad(flat_feats, (0, 0, 0, pad_m - m))
    labels_p = torch.nn.functional.pad(labels.long(), (0, pad_m - m), value=n)
    valid_p = torch.nn.functional.pad(
        torch.ones(m, dtype=torch.float32, device=flat_feats.device), (0, pad_m - m)
    )
    return feats_p, labels_p, valid_p


def _f1_count_scan(
    feats_p: torch.Tensor,
    labels_p: torch.Tensor,
    valid_p: torch.Tensor,
    cls3: Sequence[torch.Tensor],
    scale: torch.Tensor,
    class_mask: Optional[torch.Tensor],
):
    """Loop over [steps, row_chunk, ...] exemplar rows, accumulating the
    (tp, pred_count, label_count) [C] fp32 count tuple per classifier.
    Counts are integers (< 2^24 at any realistic scale), so fp32 sums are
    exact and chunking cannot change them."""
    n = cls3[0].shape[0]
    carry = [
        tuple(torch.zeros(n, dtype=torch.float32, device=feats_p.device) for _ in range(3))
        for _ in cls3
    ]
    for f, lab, w in zip(feats_p, labels_p, valid_p):
        f = f.float()
        for i, cls_matrix in enumerate(cls3):
            logits = scale * f @ cls_matrix.T
            if class_mask is not None:
                logits = torch.where(class_mask[None, :], logits, float("-inf"))
            counts = f1_counts_from_preds(logits.argmax(dim=-1), lab, n, weights=w)
            carry[i] = tuple(a + c for a, c in zip(carry[i], counts))
    return carry


def streaming_fusion_weights(
    flat_feats: torch.Tensor,
    labels: torch.Tensor,
    classifiers: Sequence[torch.Tensor],
    logit_scale,
    tau: float,
    class_mask: Optional[torch.Tensor] = None,
    row_chunk: int = 8192,
) -> torch.Tensor:
    """Preference-fusion weights without materializing [M, C] anything:
    flat_feats [M, D], labels [M], classifiers (mm, v, t) each [C, D]; the
    fp32 logits working set is [row_chunk, C]. Returns [C, 3] fp32."""
    m, d = flat_feats.shape
    n = classifiers[0].shape[0]
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=flat_feats.device)
    cls3 = [c.float() for c in classifiers]
    steps = max(1, -(-m // row_chunk))
    feats_p, labels_p, valid_p = _pad_rows(flat_feats, labels, n, steps * row_chunk)
    mm_c, v_c, t_c = _f1_count_scan(
        feats_p.reshape(steps, row_chunk, d),
        labels_p.reshape(steps, row_chunk),
        valid_p.reshape(steps, row_chunk),
        cls3,
        scale,
        class_mask,
    )
    return fusion_weights_from_f1(
        f1_from_counts(*mm_c), f1_from_counts(*v_c), f1_from_counts(*t_c), tau
    )


def streaming_fusion_weights_sharded(
    axis,
    flat_feats: torch.Tensor,
    labels: torch.Tensor,
    classifiers: Sequence[torch.Tensor],
    logit_scale,
    tau: float,
    class_mask: Optional[torch.Tensor] = None,
    row_chunk: int = 8192,
) -> torch.Tensor:
    """:func:`streaming_fusion_weights` with the exemplar rows sharded over
    a data axis (:class:`ovmr_tpu_torch.parallel.mesh.DataAxis`; JAX
    ``streaming_fusion_weights_sharded`` :180-265). The rows pad to
    ``steps * row_chunk * shards`` (padding rows weigh 0); each shard scans
    its contiguous block of ``steps`` chunks against the whole classifiers,
    and the fp32 counts of the shards this process holds are added, then
    all-reduced over the group; the F1 -> softmax epilogue runs on every
    rank. The counts are integers, exact in fp32, so the result is
    :func:`streaming_fusion_weights`'s bit for bit."""
    shards = axis.size
    m, d = flat_feats.shape
    n = classifiers[0].shape[0]
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=flat_feats.device)
    cls3 = [c.float() for c in classifiers]
    steps = max(1, -(-m // (row_chunk * shards)))
    feats_p, labels_p, valid_p = _pad_rows(flat_feats, labels, n, steps * row_chunk * shards)
    rows = steps * row_chunk
    total = None
    for s in axis.shards:
        block = slice(s * rows, (s + 1) * rows)
        counts = _f1_count_scan(
            feats_p[block].reshape(steps, row_chunk, d),
            labels_p[block].reshape(steps, row_chunk),
            valid_p[block].reshape(steps, row_chunk),
            cls3,
            scale,
            class_mask,
        )
        flat = torch.stack([c for triple in counts for c in triple])  # [9, C]
        total = flat if total is None else total + flat
    total = axis.sum_(total)
    mm_c, v_c, t_c = total[0:3], total[3:6], total[6:9]
    return fusion_weights_from_f1(
        f1_from_counts(*mm_c), f1_from_counts(*v_c), f1_from_counts(*t_c), tau
    )


def fuse_probs(
    mm_probs: torch.Tensor,
    v_probs: torch.Tensor,
    t_probs: torch.Tensor,
    fusion_weight: torch.Tensor,
) -> torch.Tensor:
    """Per-class blend: probs [B, C] each, fusion_weight [C, 3] -> [B, C]."""
    three = torch.stack([mm_probs, v_probs, t_probs], dim=-1)
    return (three * fusion_weight[None, :, :]).sum(dim=-1)
