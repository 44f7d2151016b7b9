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
only. With ``augment`` (``DEVICE_AUGS``, :58-92) the step takes the raw
uint8 class-grouped batch and runs the augmentation on its device first.

:func:`make_sharded_train_step` is the multi-shard step
(``make_sharded_train_step`` :152-290) over a
:class:`ovmr_tpu_torch.parallel.mesh.Mesh`: each data shard runs the step's
body on its contiguous class block, the mm/v classifiers are all-gathered
over 'data' (whose backward reduce-scatters the cotangents to their
owners), and the aggregator's gradients are averaged over 'data' before one
replicated optimizer step. There is no ``DistributedDataParallel``: its own
averaging on top of the gather's backward would count the cross-shard
classifier gradients twice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ovmr_tpu_torch.engine.optimizers import param_leaves
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.ops.augment import augment_batch, sample_augment_draws
from ovmr_tpu_torch.ops.attention import fused_attention
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import (
    l2_normalize,
    residual_attention_block,
    residual_block_remat,
)
from ovmr_tpu_torch.utils import trace


def _text_tower_block_fn(block_fn):
    """Block fn for the differentiated text tower: the kernel blocks
    rematerialise per layer by construction; the torch-math blocks (the
    single-device one and the GSPMD route's) get a per-layer checkpoint so
    12 layers of intermediates are not kept (``_text_tower_block_fn``
    :39-50)."""
    if block_fn is residual_attention_block:
        return residual_block_remat
    if getattr(block_fn, "torch_math", False):
        from torch.utils.checkpoint import checkpoint

        def remat_block(x, p, n_head, mask=None):
            return checkpoint(lambda x_: block_fn(x_, p, n_head, mask), x, use_reentrant=False)

        return remat_block
    return block_fn


def frozen_features(clip_params, clip_cfg, images, prompt_tokens, vis_tokens, split_point,
                    block_fn=fused_residual_block, layout: str = "NCHW", label_offset: int = 0):
    """The step's part without gradients (:94-122): normalized query
    features [num_cls * split, D], exemplar features [num_cls, n_ins - split,
    D], prompt and visual-template embeddings, labels and the logit scale.
    ``images`` is [num_cls, n_ins, 3, H, W], or [num_cls, n_ins, H, W, 3]
    with ``layout="NHWC"``. ``label_offset`` is a data shard's first class
    in the whole batch (its labels are global)."""
    num_cls, n_ins = images.shape[:2]
    img_shape = images.shape[2:]
    with torch.no_grad():
        query = images[:, :split_point].reshape(num_cls * split_point, *img_shape)
        exemplar = images[:, split_point:].reshape(num_cls * (n_ins - split_point), *img_shape)
        q_feats = l2_normalize(tclip.encode_image(clip_params, clip_cfg, query,
                                                  block_fn=block_fn, layout=layout))
        e_feats = l2_normalize(
            tclip.encode_image(clip_params, clip_cfg, exemplar, block_fn=block_fn, layout=layout)
        ).reshape(num_cls, n_ins - split_point, -1)
        prompt_embeds, vis_embeds = ovmr.prompt_embeddings(
            clip_params, e_feats, prompt_tokens, vis_tokens
        )
        labels = (torch.arange(num_cls, device=images.device) + label_offset).repeat_interleave(
            split_point)
        logit_scale = clip_params["logit_scale"].float().exp()
    return q_feats, e_feats, prompt_embeds, vis_embeds, labels, logit_scale


def _heads(clip_params, clip_cfg, agg_params, frozen, eot_idx, dropout, generator, attn_fn,
           block_fn):
    _, e_feats, prompt_embeds, vis_embeds, _, _ = frozen
    mm_cls, v_cls, _ = ovmr.classifier_heads(
        clip_params, clip_cfg, agg_params, e_feats, prompt_embeds, vis_embeds, eot_idx,
        dropout=dropout, generator=generator, attn_fn=attn_fn,
        block_fn=_text_tower_block_fn(block_fn),
    )
    return mm_cls, v_cls


def _ce_pair(frozen, mm_cls, v_cls):
    q_feats, _, _, _, labels, logit_scale = frozen
    qf = q_feats.float()
    mm_logits = logit_scale * qf @ mm_cls.float().T
    v_logits = logit_scale * qf @ v_cls.float().T
    return F.cross_entropy(mm_logits, labels) + F.cross_entropy(v_logits, labels)


def classifier_loss(clip_params, clip_cfg, agg_params, frozen, eot_idx, dropout=0.0,
                    generator: Optional[torch.Generator] = None,
                    attn_fn=fused_attention, block_fn=fused_residual_block):
    """CE(mm) + CE(v) of the query features against the classifiers the
    aggregator generates from the exemplar features (:124-142); the only
    differentiated part of the step."""
    mm_cls, v_cls = _heads(clip_params, clip_cfg, agg_params, frozen, eot_idx, dropout,
                           generator, attn_fn, block_fn)
    return _ce_pair(frozen, mm_cls, v_cls)


# the keys of an ``augment`` dict that the draws take, and those that the
# draw-free augmentation takes
_DRAW_KEYS = ("out_size", "scale", "jitter", "gn_std")
_APPLY_KEYS = ("out_size", "mean", "std", "out_dtype")


def augment_images(images_u8, augment: dict, generator=None, draws=None):
    """A uint8 class-grouped batch [num_cls, n_ins, S, S, 3] -> the
    augmented NHWC batch [num_cls, n_ins, out, out, 3] (:82-92), on the
    batch's device: flattened, augmented with ``draws`` (by default drawn
    from ``generator``, :func:`ovmr_tpu_torch.ops.augment.sample_augment_draws`)
    and reshaped. ``augment`` holds the JAX step's keys: ``out_size``,
    ``scale``, ``jitter``, ``gn_std``, ``mean``, ``std``, ``out_dtype``."""
    num_cls, n_ins, s = images_u8.shape[:3]
    flat = images_u8.reshape(num_cls * n_ins, *images_u8.shape[2:])
    if draws is None:
        if generator is None:
            raise ValueError("the augmenting step needs a generator or injected draws")
        draws = sample_augment_draws(generator, flat.shape[0], s,
                                     **{k: augment[k] for k in _DRAW_KEYS if k in augment})
    out = augment_batch(flat, draws, out_layout="NHWC",
                        **{k: augment[k] for k in _APPLY_KEYS if k in augment})
    return out.reshape(num_cls, n_ins, *out.shape[1:])


def make_train_step(
    clip_cfg: tclip.CLIPConfig,
    dropout: float = 0.1,
    attn_fn=fused_attention,
    block_fn=fused_residual_block,
    augment: Optional[dict] = None,
):
    """Returns ``train_step(agg_params, optimizer, clip_params, images,
    prompt_tokens, eot_idx, vis_tokens, generator, split_point,
    augment_draws=None) -> loss``. ``images`` is [num_cls, n_ins, 3, H, W];
    ``generator`` seeds the dropout masks (on the tensors' device; None
    switches dropout off); ``agg_params`` holds the leaves ``optimizer``
    updates in place.

    With ``augment`` (:func:`augment_images`' dict) ``images`` is the raw
    uint8 batch [num_cls, n_ins, S, S, 3]: it is augmented on its device,
    with draws from ``generator`` taken before the dropout masks, or with
    ``augment_draws`` when given, and the towers read it as NHWC."""

    def train_step(agg_params, optimizer, clip_params, images, prompt_tokens, eot_idx,
                   vis_tokens, generator, split_point: int, augment_draws=None):
        with trace.span("step"):
            layout = "NCHW"
            if augment is not None:
                with torch.no_grad(), trace.span("augment"):
                    images = augment_images(images, augment, generator, augment_draws)
                layout = "NHWC"
            with trace.span("frozen"):
                frozen = frozen_features(
                    clip_params, clip_cfg, images, prompt_tokens, vis_tokens, split_point,
                    block_fn=block_fn, layout=layout,
                )
            with trace.span("optimizer"):
                optimizer.zero_grad(set_to_none=True)
            with trace.span("heads"):
                loss = classifier_loss(
                    clip_params, clip_cfg, agg_params, frozen, eot_idx, dropout=dropout,
                    generator=generator, attn_fn=attn_fn, block_fn=block_fn,
                )
            with trace.span("backward"):
                loss.backward()
            with trace.span("optimizer"):
                optimizer.step()
            return loss.detach()

    return train_step


def shard_seed(seed: int, shard: int) -> int:
    """A data shard's seed from the step's (JAX's ``fold_in(rng, dev)``
    :197-199): distinct streams per shard, the same on every rank; the
    model shards of one data row share it."""
    return (int(seed) * 0x9E3779B1 + 0x85EBCA77 * (int(shard) + 1)) % (1 << 63)


def slice_draws(draws: dict, n: int) -> list:
    """Augment draws of a whole batch (:func:`ops.augment.sample_augment_draws`)
    cut into ``n`` contiguous blocks, one a data shard, in shard order."""
    b = next(v.shape[0] for v in draws.values() if v is not None)
    step = b // n
    return [{k: None if v is None else v[i * step:(i + 1) * step] for k, v in draws.items()}
            for i in range(n)]


def make_sharded_train_step(
    clip_cfg: tclip.CLIPConfig,
    mesh,
    dropout: float = 0.1,
    attn_fn=fused_attention,
    block_fn=fused_residual_block,
    augment: Optional[dict] = None,
):
    """The step over ``mesh`` (:class:`ovmr_tpu_torch.parallel.mesh.Mesh`):
    ``step(agg_params, optimizer, clip_params, images, prompt_tokens,
    eot_idx, vis_tokens, seed, split_point, augment_draws=None) -> loss``.

    ``images``, ``prompt_tokens`` and ``eot_idx`` are this process's rows
    of the class-grouped batch (:func:`ovmr_tpu_torch.parallel.mesh.shard_batch`,
    or the sliced loader's rows), split evenly over its local data shards;
    the other arguments are replicated. Each shard d runs the local class
    block: the augmentation, the query/exemplar split, both towers, the
    heads, with global labels ``arange(local_cls) + d * local_cls``; its
    dropout and augment draws come from a generator seeded by
    :func:`shard_seed` (``seed`` None: dropout off, and an augmenting step
    then needs ``augment_draws``, a list of one draws dict a local shard).
    With a model axis, ``clip_params`` are this process's tower shards and
    ``block_fn`` the TP block (:func:`ovmr_tpu_torch.ops.block_fused_tp.make_tp_block`)
    or the GSPMD route's block. The mm/v classifiers of every shard are
    gathered over 'data'; each shard's CE over the whole class set is
    differentiated once, the gather's backward returning each shard's
    classifier cotangents to it; the aggregator's gradients are summed over
    'data' and divided by its size; then one optimizer step, the same on
    every rank. Returns the loss averaged over 'data'."""
    data = mesh.data

    def step(agg_params, optimizer, clip_params, images, prompt_tokens, eot_idx, vis_tokens,
             seed, split_point: int, augment_draws=None):
        with trace.span("step"):
            return _step(agg_params, optimizer, clip_params, images, prompt_tokens, eot_idx,
                         vis_tokens, seed, split_point, augment_draws)

    def _step(agg_params, optimizer, clip_params, images, prompt_tokens, eot_idx, vis_tokens,
              seed, split_point, augment_draws):
        n_local = len(data.shards)
        local_cls = images.shape[0] // n_local
        blocks = list(zip(data.split(images), data.split(prompt_tokens), data.split(eot_idx)))
        gens, frozen = [], []
        for i, (d, (imgs, ptok, _)) in enumerate(zip(data.shards, blocks)):
            gen = None
            if seed is not None:
                gen = torch.Generator(device=images.device).manual_seed(shard_seed(seed, d))
            gens.append(gen)
            layout = "NCHW"
            if augment is not None:
                draws = None if augment_draws is None else augment_draws[i]
                with torch.no_grad(), trace.span("augment"):
                    imgs = augment_images(imgs, augment, gen, draws)
                layout = "NHWC"
            with trace.span("frozen"):
                frozen.append(frozen_features(
                    clip_params, clip_cfg, imgs, ptok, vis_tokens, split_point,
                    block_fn=block_fn, layout=layout, label_offset=d * local_cls,
                ))
        with trace.span("optimizer"):
            optimizer.zero_grad(set_to_none=True)
        # the dropout masks of a shard follow its augment draws, as in the
        # single-program step
        with trace.span("heads"):
            heads = [_heads(clip_params, clip_cfg, agg_params, fr, eot, dropout, gen, attn_fn,
                            block_fn)
                     for fr, gen, (_, _, eot) in zip(frozen, gens, blocks)]
        width = heads[0][0].shape[-1]
        both = data.gather([torch.cat(h, dim=-1) for h in heads])
        mm_all, v_all = both[:, :width], both[:, width:]
        loss = sum(_ce_pair(fr, mm_all, v_all) for fr in frozen)
        with trace.span("backward"):
            loss.backward()
        with torch.no_grad():
            for leaf in param_leaves(agg_params):
                if leaf.grad is not None:
                    data.sum_(leaf.grad).div_(data.size)
        with trace.span("optimizer"):
            optimizer.step()
        return data.sum_(loss.detach().clone()) / data.size

    return step


def sample_split_point(py_rng, n_ins: int) -> int:
    """split_point ~ U[n_ins//4, 3*n_ins//4) (reference ``mm_…:300``), drawn
    on the host from a numpy ``Generator`` or a ``random.Random``."""
    lo, hi = n_ins // 4, (3 * n_ins) // 4
    return int(py_rng.integers(lo, hi)) if hasattr(py_rng, "integers") else int(
        py_rng.randint(lo, hi - 1)
    )
