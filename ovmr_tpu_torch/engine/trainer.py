"""Trainer hierarchy, the MM_CLS_OP trainer, and its serving seams.

Counterpart of ``ovmr_tpu/engine/trainer.py`` (reference
``dassl/engine/trainer.py`` + ``trainers/mm_classifier_one_prompt.py``):

- :data:`TRAINER_REGISTRY`, :func:`build_trainer` (``:48``; it also
  reaches ``CoOp``/``MM_CLS`` of :mod:`ovmr_tpu_torch.engine.coop`, the
  zero-shot trainers of :mod:`ovmr_tpu_torch.engine.zsclip` and the Dassl
  DG trainers of :mod:`ovmr_tpu_torch.engine.dg`),
  :func:`load_or_init_clip` (``:61``), :func:`collect_exemplar_features`
  (``:81``);
- :class:`TrainerBase` (``:384``): epoch loop, checkpoint cadence,
  auto-resume, logging and meters, the ``test()`` loop;
- :class:`MM_CLS_OP` (``:602``): frozen CLIP towers at ``CUDA.DTYPE`` on
  ``CUDA.DEVICE``, the aggregator as the only trained state (``requires_grad``
  leaves updated by a ``torch.optim`` optimizer), the train step of
  :mod:`ovmr_tpu_torch.engine.train_step` at dropout 0.1, classifier
  generation, per-mode evaluation and the ``mm_classifiers.pt`` export;
- the serving seams: :func:`tp_seam_tools` (``:221-232``), the TP block and
  the towers placed for a :class:`ovmr_tpu_torch.parallel.ModelAxis`;
  :func:`make_feature_extractor` (``:235-371``), the eval encode, float and
  uint8 batches, ragged batches padded to the batch size;
  :func:`mm_generate_classifiers` (``:957-1031``), classifier generation
  from exemplar features, class-chunked, with the text-head guard, the
  preference fusion and the export.

:func:`encode_features` and :func:`mm_generate_classifiers` are also the
bodies of :class:`ovmr_tpu_torch.api.OVMRGenerator`'s encode and
generation, with the single-device block.

The mesh (:func:`setup_trainer_mesh`, JAX ``:107-218``): ``CUDA.MESH.DATA``
and ``CUDA.MESH.MODEL`` make a ``data x model``
:class:`ovmr_tpu_torch.parallel.mesh.Mesh`, of local shards on one process
or one rank a shard under ``torch.distributed``. The data axis shards the
training batch by classes (:func:`ovmr_tpu_torch.engine.train_step.make_sharded_train_step`),
the eval encode by rows and classifier generation and the fusion by
classes. Under a model axis the JAX package runs its seams inside
``shard_map`` over 'model' and swaps the aggregator's Pallas attention for
``attention_xla`` (``:195``, ``:269``) because ``pallas_call`` has no SPMD
partitioning rule. Nothing here is partitioned by a compiler: the TP block
calls the per-shard kernels itself, so the aggregator keeps its kernel (K6)
under TP too; the GSPMD route (int8 towers, ``CUDA.TP_SPLIT_QKV False``)
is torch math with the MLP split over 'model'.
With ``CUDA.INT8`` the eval's encode, classifier generation and test pass
run the int8 towers of :attr:`MM_CLS_OP.serving_params` (their blocks take
the torch-math route of ``ops/block_fused.fused_residual_block``);
training never quantizes. ``CUDA.DEVICE_AUGS`` trains from the
decode-once uint8 cache (:mod:`ovmr_tpu_torch.data.cache`) with the
augmentation in the step, on the trainer's device.
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.data.prefetch import prefetch_batches
from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine.optimizers import build_optimizer, set_lr
from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
from ovmr_tpu_torch.engine.train_step import (
    make_sharded_train_step,
    make_train_step,
    sample_split_point,
)
from ovmr_tpu_torch.evaluation import build_evaluator
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.models.aggregator import init_aggregator
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import l2_normalize
from ovmr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, normalize_u8
from ovmr_tpu_torch.ops.block_fused_tp import make_gspmd_block
from ovmr_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    map_data_shards,
    pad_to_multiple,
    place_local_batch,
    place_packed_mlp,
    shard_batch,
)
from ovmr_tpu_torch.parallel.multihost import is_primary, world
from ovmr_tpu_torch.utils import AverageMeter, MetricMeter, Registry, trace

TRAINER_REGISTRY = Registry("TRAINER")


def tp_seam_tools(axis, clip_params: dict, clip_cfg: tclip.CLIPConfig):
    """``(tp_block_fn, seam_params)`` for the seams below. With a model axis
    of size > 1 (a :class:`ovmr_tpu_torch.parallel.ModelAxis`, or a
    :class:`ovmr_tpu_torch.parallel.Mesh`'s): the TP block over this
    process's shards (:func:`ovmr_tpu_torch.ops.block_fused_tp.make_tp_block`)
    and the towers split, head-padded where the heads do not divide the
    axis, and placed as this process's shards; the placed towers take the
    place of the JAX package's PartitionSpec tree. Without one:
    ``(None, clip_params)``."""
    if isinstance(axis, Mesh):
        axis = axis.model
    if axis is None or axis.size <= 1:
        return None, clip_params
    from ovmr_tpu_torch.ops.block_fused_tp import make_tp_block, split_clip_qkv
    from ovmr_tpu_torch.parallel.mesh import place_tower_params

    placed = place_tower_params(axis, split_clip_qkv(clip_params, axis.size, clip_cfg))
    return make_tp_block(axis), placed


def setup_trainer_mesh(cfg, clip_params: dict, clip_cfg=None, label: str = ""):
    """The mesh and the tensor-parallel route shared by MM_CLS_OP, CoOp and
    the zero-shot trainers (JAX ``setup_trainer_mesh`` :107-218). Returns
    ``(mesh, tp, clip_params, block_fn)``, ``tp`` one of ``False`` (no
    model axis), ``"pallas"`` and ``"gspmd"``:

    - one process, ``CUDA.MESH.DATA`` -1 or 1 and no model axis: no mesh
      (JAX runs one device without one); ``DATA 1`` with no model axis opts
      out on many ranks too (each runs the whole program);
    - otherwise the ``data x model`` mesh (:func:`ovmr_tpu_torch.parallel.mesh.build_mesh`):
      local shards on one process (an explicit ``DATA n > 1`` runs n data
      shards there, where JAX's one device warns and runs unsharded), one
      shard a rank under a process group;
    - ``"pallas"`` (model axis > 1, float towers, ``CUDA.TP_SPLIT_QKV``,
      MLP hidden widths the axis divides): split-qkv towers, head-padded
      where needed, placed as this process's shards, and the TP block of
      K7/K8 (:func:`tp_seam_tools`);
    - ``"gspmd"`` (int8, ``TP_SPLIT_QKV False``, a hidden width the axis
      does not divide, or no ``clip_cfg``): packed towers with their MLP
      split (:func:`ovmr_tpu_torch.parallel.mesh.place_packed_mlp`) and
      the torch-math block of :func:`ovmr_tpu_torch.ops.block_fused_tp.make_gspmd_block`.

    ``clip_params`` are the towers on the trainer's device in its dtype."""
    prefix = f"{label} " if label else ""
    data, model = int(cfg.CUDA.MESH.DATA), int(cfg.CUDA.MESH.MODEL)
    if model <= 1 and (data == 1 or (data == -1 and world() == 1)):
        return None, False, clip_params, fused_residual_block
    mesh = build_mesh(data, model)
    if mesh.model.size <= 1:
        print(f"{prefix}data-parallel mesh: {mesh.shape}")
        return mesh, False, clip_params, fused_residual_block

    msize = mesh.model.size
    pallas_tp = (
        clip_cfg is not None
        and not cfg.CUDA.INT8
        and cfg.CUDA.TP_SPLIT_QKV
        and (4 * clip_cfg.transformer_width) % msize == 0
        and (clip_cfg.is_resnet or (4 * clip_cfg.vision_width) % msize == 0)
    )
    if pallas_tp:
        block_fn, placed = tp_seam_tools(mesh, clip_params, clip_cfg)
        pads = [
            f"{name} {heads}->{heads + (-heads) % msize}"
            for name, heads in (
                ("visual", None if clip_cfg.is_resnet else clip_cfg.vision_heads),
                ("text", clip_cfg.transformer_heads),
            )
            if heads is not None and heads % msize
        ]
        pad_note = f" (head-padded: {', '.join(pads)})" if pads else ""
        print(
            f"{prefix}tensor-parallel mesh {mesh.shape}: split-QKV towers{pad_note}; every "
            "seam runs the per-shard kernels K7/K8 (head-split attention + hidden-split MLP, "
            "fp32 sum over 'model')"
        )
        return mesh, "pallas", placed, block_fn

    print(
        f"{prefix}model-parallel mesh (model={msize}): routing the towers to the torch-math "
        "block (packed towers, the MLP split over 'model'; no kernel on this route)"
    )
    print(f"{prefix}tensor-parallel mesh: {mesh.shape} (GSPMD route)")
    return mesh, "gspmd", place_packed_mlp(mesh.model, clip_params), make_gspmd_block(mesh.model)


def encode_features(
    clip_params: dict,
    clip_cfg: tclip.CLIPConfig,
    images: torch.Tensor,
    dtype,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
    block_fn=fused_residual_block,
    unit_norm: bool = True,
) -> torch.Tensor:
    """Image features [n, D] in ``dtype``, on the device of ``images``,
    L2-normalised unless ``unit_norm=False``: a float NCHW batch is cast to
    ``dtype``, a uint8 NHWC batch normalised with ``mean``/``std`` first."""
    if images.dtype == torch.uint8:
        x = normalize_u8(images, tuple(mean), tuple(std), dtype).permute(0, 3, 1, 2)
    else:
        x = images.to(dtype)
    feats = tclip.encode_image(clip_params, clip_cfg, x, block_fn=block_fn)
    return l2_normalize(feats) if unit_norm else feats


def make_feature_extractor(
    clip_cfg: tclip.CLIPConfig,
    dtype,
    mean: Sequence[float],
    std: Sequence[float],
    batch_size: int,
    device="cuda",
    u8_normalize: bool = True,
    tp_block_fn=None,
    mesh=None,
    unit_norm: bool = True,
):
    """Returns ``encode(clip_params, images) -> fp32 features [n, D]``
    (numpy), by :func:`encode_features`: L2-normalised unless
    ``unit_norm=False`` (the lpclip dump keeps the reference's raw features).

    ``images`` (numpy or tensor) is a float NCHW batch or a uint8 NHWC one,
    normalised on the device; with ``u8_normalize=False`` a uint8 batch is
    only scaled to [0, 1], as a config whose transforms omit "normalize"
    does on the float path. A batch of fewer than ``batch_size`` images is
    padded with zeros to ``batch_size``, so the kernels run at one shape.
    With ``tp_block_fn`` (:func:`tp_seam_tools`, or the GSPMD route's block)
    the vision tower runs it on towers placed for its model axis. With a
    ``mesh`` the batch pads to a multiple of its data axis (JAX
    ``:289-353``), each data shard encodes its block of rows and the
    features are gathered to every rank."""
    from ovmr_tpu_torch.api import resolve_device

    device = resolve_device(device)
    if not u8_normalize:
        mean, std = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    block_fn = fused_residual_block if tp_block_fn is None else tp_block_fn
    if mesh is not None and batch_size % mesh.data.size:
        padded = pad_to_multiple(batch_size, mesh.data.size)
        print(f"WARNING: eval batch {batch_size} not divisible by the data axis "
              f"({mesh.data.size}); padding the batch to {padded}")
        batch_size = padded

    @torch.inference_mode()
    def encode(clip_params: dict, images) -> np.ndarray:
        images = torch.as_tensor(images)
        n = images.shape[0]
        if n < batch_size:
            pad = images.new_zeros((batch_size - n, *images.shape[1:]))
            images = torch.cat([images, pad])

        def enc(x):
            return encode_features(clip_params, clip_cfg, x.to(device), dtype, mean, std,
                                   block_fn=block_fn, unit_norm=unit_norm)

        feats = enc(images) if mesh is None else map_data_shards(mesh, enc, images)
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
    mesh=None,
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
    writes ``mm_classifiers.pt`` and ``visual_tokens.pt``. With a ``mesh``
    each chunk pads to a multiple of its data axis and its classes shard
    over 'data' (JAX ``_shard_over_classes``/``_place_classes``
    :963-966, :1033-1075), and the fusion's exemplar rows shard too above
    its streaming threshold. Returns numpy fp32 arrays."""
    n_cls = exemplar_feats.shape[0]
    chunk = min(int(class_chunk), pad_to_multiple(n_cls, int(class_pad_multiple)))
    if mesh is not None:
        chunk = pad_to_multiple(chunk, mesh.data.size)
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
    # a blocking copy from pageable host memory waits for the stream: here,
    # for the whole encode queued before it
    with trace.span("tokens", wait=True):
        vis = torch.as_tensor(np.asarray(vis_tokens), device=device)

    def heads_fn(f, pt, et):
        pe, ve = ovmr.prompt_embeddings(clip_params, f, pt, vis)
        return ovmr.classifier_heads(clip_params, clip_cfg, agg_params, f, pe, ve, et,
                                     block_fn=block_fn)

    def text_fn(pt):
        return ovmr.text_classifier(clip_params, clip_cfg, pt, block_fn=block_fn)

    out = ovmr.generate_classifiers_chunked(
        feats, prompt_tokens, eot_idx, vis_tokens, chunk, heads_fn,
        text_fn=text_fn if include_text else None, mesh=mesh,
    )
    if include_text:
        out["fusion_weight"] = ovmr.fusion_from_classifiers(
            feats, out["mm_classifier"], out["vision_classifier"], out["text_classifier"],
            clip_params["logit_scale"].float().exp(), float(eval_tau), mesh=mesh,
        ).float()
    with trace.span("result", wait=True):
        out = {k: v.cpu().numpy() for k, v in out.items()}
    if output_dir is not None:
        from ovmr_tpu_torch.engine.checkpoint import export_classifiers_torch

        export_classifiers_torch(out, output_dir)
    return out


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------

def build_trainer(cfg):
    # the trainers of other modules register themselves when imported (the
    # counterpart of the JAX package's ``register_all_trainers``)
    from ovmr_tpu_torch.engine import coop, da, dg, ssl, zsclip  # noqa: F401

    return TRAINER_REGISTRY.get(cfg.TRAINER.NAME)(cfg)


def load_or_init_clip(cfg):
    """Returns (CLIP params fp32 on the CPU, CLIPConfig): the local
    checkpoint of ``MODEL.BACKBONE.NAME`` ($OVMR_CLIP_CKPT, then
    ~/.cache/clip), else random towers from seed 0 (accuracy-meaningless,
    but every pipeline runs end to end)."""
    from ovmr_tpu_torch.models.import_torch import load_clip
    from ovmr_tpu_torch.models.zoo import resolve

    name = cfg.MODEL.BACKBONE.NAME or "ViT-B/16"
    path = resolve(name)
    if path is not None:
        print(f"Loading CLIP (backbone: {name}) from {path}")
        return load_clip(path)
    print(f"WARNING: no local CLIP checkpoint for {name}; using RANDOM weights (smoke-run mode)")
    clip_cfg = tclip.CONFIGS.get(name, tclip.VIT_B16)
    return tclip.init_params(clip_cfg, seed=0), clip_cfg


def collect_exemplar_features(eval_set_loader, features_fn, clip_params, n_cls, shots, dim):
    """Gather ``[n_cls, shots, dim]`` fp32 exemplar features from the
    eval_set_loader contract (RandomClassSampler with n_ins = shots;
    reference ``mm_…:214-231``)."""
    feats = np.zeros((n_cls, shots, dim), np.float32)
    filled = np.zeros(n_cls, bool)
    for batch in prefetch_batches(eval_set_loader):
        images, labels = batch["img"], batch["label"]
        usable = (images.shape[0] // shots) * shots
        if usable == 0:
            continue
        f = features_fn(clip_params, images[:usable]).reshape(-1, shots, dim)
        lab = labels[:usable].reshape(-1, shots)[:, 0]
        feats[lab] = f
        filled[lab] = True
    if not filled.all():
        raise RuntimeError(f"classes missing exemplars: {np.where(~filled)[0]}")
    return feats


_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
    "float32": torch.float32,
    "fp32": torch.float32,
}


class TrainerBase:
    """Generic epoch-loop trainer (reference ``TrainerBase``/``SimpleTrainer``
    /``TrainerX``, ``dassl/engine/trainer.py:77-674``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.output_dir = cfg.OUTPUT_DIR
        self.start_epoch = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.epoch = 0
        self.best_result = -np.inf
        self._writer = None
        # the last epoch's meters, and the profile of the first epoch a
        # run trains when OVMR_PROFILE_DIR is set (torch.profiler)
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self.epoch_profile = None

        self.dm = self.build_data_manager()
        self.dm.show_dataset_summary()
        self.evaluator = build_evaluator(cfg, lab2cname=self.dm.lab2cname)
        self.build_model()

    # subclass hooks ------------------------------------------------------
    def build_data_manager(self):
        return DataManager(self.cfg)

    def build_model(self):
        raise NotImplementedError

    def forward_backward(self, batch):
        raise NotImplementedError

    def before_epoch(self):
        pass

    def after_epoch(self):
        last = (self.epoch + 1) == self.max_epoch
        do_test = not self.cfg.TEST.NO_TEST
        # best-val model selection (reference SimpleTrainer.after_epoch,
        # ``dassl/engine/trainer.py:437-455``)
        if do_test and self.cfg.TEST.FINAL_MODEL == "best_val":
            curr_result = self.test(split="val")
            if curr_result > self.best_result:
                self.best_result = curr_result
                self.save_model(self.epoch + 1, model_name="model-best")
        freq = self.cfg.TRAIN.CHECKPOINT_FREQ
        if last or (freq > 0 and (self.epoch + 1) % freq == 0):
            self.save_model(self.epoch + 1)

    def save_model(self, epoch, model_name=""):
        pass

    def resume_model_if_exist(self, directory) -> int:
        """Restore state from `directory` when a checkpoint exists; return
        the epoch to resume from (reference ``before_train``,
        ``dassl/engine/trainer.py:403-407``)."""
        return 0

    def init_writer(self):
        if self._writer is None:
            from ovmr_tpu_torch.utils.tensorboard import SummaryWriter

            tb_dir = osp.join(self.output_dir, "tensorboard")
            os.makedirs(tb_dir, exist_ok=True)
            self._writer = SummaryWriter(tb_dir)
        return self._writer

    def write_scalar(self, tag, value, global_step):
        self.init_writer().add_scalar(tag, float(value), global_step)

    def train(self):
        self.before_train()
        # optional device trace: OVMR_PROFILE_DIR=<dir> captures the first
        # epoch this run trains with torch.profiler (a chrome trace there,
        # and the profile in ``epoch_profile``)
        profile_dir = os.environ.get("OVMR_PROFILE_DIR")
        for self.epoch in range(self.start_epoch, self.max_epoch):
            prof = None
            if profile_dir and self.epoch == self.start_epoch:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                prof = profile(activities=activities)
                prof.start()
                t = time.perf_counter()
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
            if prof is not None:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                epoch_s = time.perf_counter() - t  # the epoch's, without the export
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(osp.join(profile_dir, f"epoch-{self.epoch + 1}.json"))
                self.epoch_profile = (prof, epoch_s)
        self.after_train()

    def before_train(self):
        # automatic resume from OUTPUT_DIR, no flag needed (reference
        # ``before_train``, ``dassl/engine/trainer.py:403-407``)
        directory = self.cfg.RESUME or self.output_dir
        self.start_epoch = self.resume_model_if_exist(directory)
        self.time_start = time.time()
        self.init_writer()

    def after_train(self):
        print("Finish training")
        if not self.cfg.TEST.NO_TEST:
            if self.cfg.TEST.FINAL_MODEL == "best_val":
                print("Deploy the model with the best val performance")
                self.load_model(self.output_dir)
            else:
                print("Deploy the last-epoch model")
            self.test()
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")
        self._writer.flush()

    def run_epoch(self):
        losses = MetricMeter()
        self.batch_time = batch_time = AverageMeter()
        self.data_time = data_time = AverageMeter()
        self.num_batches = len(self.train_loader)
        end = time.time()
        # host decode of batch N+1 overlaps the device's step N (the
        # torch-DataLoader-workers equivalent)
        for self.batch_idx, batch in enumerate(prefetch_batches(self.train_loader)):
            data_time.update(time.time() - end)
            loss_summary = self.forward_backward(batch)
            batch_time.update(time.time() - end)
            if loss_summary:
                # NaN/Inf guard (reference detect_anomaly, trainer.py:236-238)
                loss_val = loss_summary.get("loss")
                if loss_val is not None and not np.isfinite(loss_val):
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at epoch {self.epoch} "
                        f"batch {self.batch_idx}"
                    )
                losses.update(loss_summary)
                global_step = self.epoch * self.num_batches + self.batch_idx
                for name, value in loss_summary.items():
                    self.write_scalar(f"train/{name}", value, global_step)
            if (
                (self.batch_idx + 1) % self.cfg.TRAIN.PRINT_FREQ == 0
                or self.num_batches < self.cfg.TRAIN.PRINT_FREQ
            ):
                nb_remain = (self.num_batches - self.batch_idx - 1) + (
                    self.max_epoch - self.epoch - 1
                ) * self.num_batches
                eta = datetime.timedelta(seconds=int(batch_time.avg * nb_remain))
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}]"
                    f"[{self.batch_idx + 1}/{self.num_batches}]\t"
                    f"time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                    f"data {data_time.val:.3f} ({data_time.avg:.3f})\t"
                    f"{losses}\t"
                    f"eta {eta}"
                )
            end = time.time()

    @property
    def train_loader(self):
        return self.dm.train_loader_x

    def load_model(self, directory, epoch=None):
        pass

    # ---- generic test pipeline ------------------------------------------
    # (reference SimpleTrainer.test, ``dassl/engine/trainer.py:461-507``)
    def prepare_test(self):
        """One-time setup before the eval passes (classifier generation)."""

    def model_inference(self, batch, scale_no=0):
        """Per-batch inference -> class scores [B, n_cls] (numpy)."""
        raise NotImplementedError

    def test(self, split: Optional[str] = None):
        cfg = self.cfg
        split = split or cfg.TEST.SPLIT
        if split == "val" and self.dm.val_loader is not None:
            loader = self.dm.val_loader
        else:
            split = "test"  # in case val_loader is None (reference :470-473)
            loader = self.dm.test_loader
        self.prepare_test()
        print(f"Evaluate on the *{split}* set")

        def eval_pass(scale_no):
            self.evaluator.reset()
            for batch in prefetch_batches(loader):
                output = self.model_inference(batch, scale_no=scale_no)
                self.evaluator.process(output, batch["label"])
            results = self.evaluator.evaluate()
            for k, v in results.items():
                self.write_scalar(f"{split}/{k}", v, self.epoch)
            return results

        if not cfg.DATASET.REGION_AUG:
            results = eval_pass(0)
        else:
            # multi-scale region eval: each scale twice, the single text
            # embedding then the mean text embeddings (reference :488-505)
            scales = list(cfg.DATASET.REGION_SCALE)
            for test_no in range(len(scales) * 2):
                kind = ("mean text embeddings" if test_no >= len(scales)
                        else "corresponding single text embedding")
                print("## eval region scale %d using %s" % (scales[test_no % len(scales)], kind))
                results = eval_pass(test_no)
        return list(results.values())[0]


@TRAINER_REGISTRY.register()
class MM_CLS_OP(TrainerBase):
    """OVMR visual-token-generator trainer + classifier-generation eval
    (reference ``trainers/mm_classifier_one_prompt.py:367-493``)."""

    def build_data_manager(self):
        # under a process group each rank decodes its data shard's class
        # groups of every training batch (JAX :606-618)
        return DataManager(self.cfg, allow_local_batches="class",
                           local_model_axis=self.cfg.CUDA.MESH.MODEL)

    def build_model(self):
        from ovmr_tpu_torch.api import resolve_device
        from ovmr_tpu_torch.models.import_torch import load_prompt_learner

        cfg = self.cfg
        self.device = resolve_device(cfg.CUDA.DEVICE)
        self.dtype = _DTYPES[cfg.CUDA.DTYPE]

        clip_params, self.clip_cfg = load_or_init_clip(cfg)
        if self.clip_cfg.embed_dim != self.clip_cfg.transformer_width:
            raise ValueError(
                "MM_CLS_OP requires a backbone with embed_dim == transformer_width (got "
                f"{self.clip_cfg.embed_dim} vs {self.clip_cfg.transformer_width})")
        self.clip_params = tclip.cast_params(
            tclip.tree_to(clip_params, device=self.device), self.dtype)
        # int8 is for serving only (round and clip have no useful gradient):
        # training keeps the float towers, and serving_params quantizes the
        # float CPU params once, when an eval first asks for them
        self._fp_clip_params = clip_params if cfg.CUDA.INT8 else None
        self._serving_params_cache = None
        # the mesh and its towers: split-qkv shards with the TP block, or the
        # packed towers' MLP split with the GSPMD route's block (JAX :697-709)
        self.mesh, self._tp, self.clip_params, self.block_fn = setup_trainer_mesh(
            cfg, self.clip_params, clip_cfg=self.clip_cfg)

        classnames = self.dm.dataset.classnames
        self.n_cls = len(classnames)
        self.n_ctx = cfg.TRAINER.COCOOP.N_CTX
        self._prompt_np = ovmr.build_prompt_tokens(classnames)
        self.prompt_tokens, self.eot_idx, self.vis_tokens = (
            torch.as_tensor(a, device=self.device) for a in self._prompt_np)

        if cfg.MODEL.INIT_WEIGHTS:
            agg, _ = load_prompt_learner(cfg.MODEL.INIT_WEIGHTS)
        else:
            agg = init_aggregator(width=self.clip_cfg.embed_dim, layers=4, n_ctx=self.n_ctx,
                                  seed=max(cfg.SEED, 0))
        self.agg_params = tclip.tree_to(agg, device=self.device, dtype=torch.float32)
        for _, leaf in ckpt.named_leaves(self.agg_params):
            leaf.requires_grad_(True)

        self.optimizer = build_optimizer(cfg.OPTIM, self.agg_params)
        self.lr_table = lr_schedule_from_cfg(cfg.OPTIM)
        augment = None
        self._cached_train_loader = None
        if cfg.CUDA.DEVICE_AUGS:
            augment = dict(
                out_size=cfg.INPUT.SIZE[0],
                scale=tuple(cfg.INPUT.RRCROP_SCALE),
                jitter=(cfg.INPUT.COLORJITTER_B, cfg.INPUT.COLORJITTER_C,
                        cfg.INPUT.COLORJITTER_S, cfg.INPUT.COLORJITTER_H),
                gn_std=cfg.INPUT.GN_STD if "gaussian_noise" in cfg.INPUT.TRANSFORMS else 0.0,
                mean=tuple(cfg.INPUT.PIXEL_MEAN),
                std=tuple(cfg.INPUT.PIXEL_STD),
                out_dtype=self.dtype,
            )
        # the sharded step on a mesh; the single-program step without one,
        # and for a batch whose class count the data axis does not divide
        # (JAX :710-742)
        self.train_step_sharded = None
        if self.mesh is not None:
            self.train_step_sharded = make_sharded_train_step(
                self.clip_cfg, self.mesh, dropout=0.1, block_fn=self.block_fn, augment=augment)
        self.train_step = make_train_step(self.clip_cfg, dropout=0.1, augment=augment,
                                          block_fn=self.block_fn)
        self._features = make_feature_extractor(
            self.clip_cfg, self.dtype, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
            cfg.DATALOADER.TEST.BATCH_SIZE, device=self.device,
            u8_normalize="normalize" in cfg.INPUT.TRANSFORMS, tp_block_fn=self.block_fn,
            mesh=self.mesh)
        # dropout masks from the device's generator, split points from the
        # host's; the sharded step's per-shard seeds from a host stream that
        # every rank draws alike
        self.generator = torch.Generator(device=self.device).manual_seed(max(cfg.SEED, 0) + 1)
        self.py_rng = np.random.default_rng(max(cfg.SEED, 0))
        self.seed_rng = np.random.default_rng([max(cfg.SEED, 0), 1])
        self.classifiers = None

    def resume_model_if_exist(self, directory) -> int:
        return ckpt.resume_from_checkpoint(directory, "prompt_learner", self.agg_params,
                                           self.optimizer,
                                           backend=self.cfg.CUDA.CHECKPOINT_BACKEND)

    # ---- training -----------------------------------------------------
    @property
    def train_loader(self):
        """With ``CUDA.DEVICE_AUGS``: class-grouped uint8 batches from the
        decode-once cache at ``CUDA.CACHE_SIDE``, built on first use
        (JAX :771-796)."""
        if not self.cfg.CUDA.DEVICE_AUGS:
            return self.dm.train_loader_x
        if self._cached_train_loader is None:
            from ovmr_tpu_torch.data.cache import CachedClassBatchLoader, ImageArrayCache
            from ovmr_tpu_torch.data.samplers import build_sampler

            cfg = self.cfg
            cache = ImageArrayCache(self.dm.dataset.train_x, side=cfg.CUDA.CACHE_SIDE)
            sampler = build_sampler(cfg.DATALOADER.TRAIN_X.SAMPLER, self.dm.dataset.train_x,
                                    cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                                    cfg.DATALOADER.TRAIN_X.N_INS)
            self._cached_train_loader = CachedClassBatchLoader(
                cache, sampler, cfg.DATALOADER.TRAIN_X.BATCH_SIZE, seed=max(cfg.SEED, 0))
        return self._cached_train_loader

    def before_epoch(self):
        set_lr(self.optimizer, self.lr_table[self.epoch])

    def forward_backward(self, batch):
        cfg = self.cfg
        # K_TRANSFORMS>1 expands every instance into K adjacent augmented
        # copies, scaling the per-class group size
        n_ins = cfg.DATALOADER.TRAIN_X.N_INS * max(cfg.DATALOADER.K_TRANSFORMS, 1)
        # a cached batch is uint8 NHWC: it goes to the device as uint8 and
        # the step augments it there
        images = batch["img_u8"] if "img_u8" in batch else batch["img"]
        labels = batch["label"]
        num_cls = images.shape[0] // n_ins
        if num_cls == 0:
            return None
        usable = num_cls * n_ins
        images = torch.as_tensor(images[:usable].reshape(num_cls, n_ins, *images.shape[1:]))
        exemplar_label = torch.as_tensor(labels[:usable].reshape(num_cls, n_ins)[:, 0],
                                         dtype=torch.long)
        split_point = sample_split_point(self.py_rng, n_ins)
        mesh = self.mesh
        # a sliced batch holds this rank's class groups only (the loader
        # keeps the whole batch's class count a multiple of the data axis)
        local = bool(batch.get("_local", False)) and mesh is not None
        sharded = local or (mesh is not None and num_cls % mesh.data.size == 0)
        if mesh is not None and not sharded and not getattr(self, "_warned_unsharded", False):
            # ragged batches run the single-program step, loudly: padding
            # the class axis would corrupt the arange labels (JAX :860-873)
            self._warned_unsharded = True
            print(
                f"WARNING: batch with {num_cls} classes not divisible by the data axis "
                f"({mesh.data.size}) runs replicated; choose BATCH_SIZE so classes-per-batch "
                "divides the mesh"
            )
        if local:
            images, exemplar_label = place_local_batch(mesh, images, exemplar_label)
        elif sharded:
            images, exemplar_label = shard_batch(mesh, images), shard_batch(mesh, exemplar_label)
        images_dev = images.to(self.device)
        if images_dev.dtype != torch.uint8:
            images_dev = images_dev.to(self.dtype)
        exemplar_label = exemplar_label.to(self.device)
        ptok, eot = self.prompt_tokens[exemplar_label], self.eot_idx[exemplar_label]
        if sharded:
            loss = self.train_step_sharded(
                self.agg_params, self.optimizer, self.clip_params, images_dev, ptok, eot,
                self.vis_tokens, int(self.seed_rng.integers(1 << 62)), split_point,
            )
        else:
            loss = self.train_step(
                self.agg_params, self.optimizer, self.clip_params, images_dev, ptok, eot,
                self.vis_tokens, self.generator, split_point,
            )
        # generator weights changed: any cached classifiers are stale
        # (matters for best-val testing between epochs)
        self.classifiers = None
        return {"loss": float(loss), "lr": self.lr_table[self.epoch]}

    def save_model(self, epoch, model_name=""):
        ckpt.save_checkpoint(self.output_dir, "prompt_learner", epoch, self.agg_params,
                             self.optimizer, model_name=model_name,
                             backend=self.cfg.CUDA.CHECKPOINT_BACKEND)
        if is_primary():
            ckpt.save_torch_checkpoint(self.output_dir, "prompt_learner", epoch,
                                       self.agg_params, model_name=model_name)

    def load_model(self, directory, epoch=None):
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given")
            return
        params, _, ep = ckpt.load_checkpoint(directory, "prompt_learner", self.agg_params,
                                             epoch=epoch,
                                             backend=self.cfg.CUDA.CHECKPOINT_BACKEND)
        ckpt.copy_into(self.agg_params, params)
        self.classifiers = None  # invalidate any cache from previous weights
        print(f'Loaded prompt_learner weights from "{directory}" (epoch = {ep})')

    # ---- evaluation -----------------------------------------------------
    @property
    def serving_params(self):
        """The CLIP params of the eval paths: with ``CUDA.INT8`` the towers'
        block matmuls quantized to int8 (built once, on first use, from the
        float CPU params, then cast and moved; JAX ``:925-940``), else the
        float training params."""
        if self._fp_clip_params is None:
            return self.clip_params
        if self._serving_params_cache is None:
            from ovmr_tpu_torch.ops.quant import quantize_params

            print("Quantizing frozen tower block matmuls to int8 (serving)")
            params = tclip.cast_params(
                tclip.tree_to(quantize_params(self._fp_clip_params), device=self.device),
                self.dtype)
            if self._tp:  # int8 on a model axis is the GSPMD route: the MLP split
                params = place_packed_mlp(self.mesh.model, params)
            self._serving_params_cache = params
        return self._serving_params_cache

    def generate_classifiers(self):
        """Exemplar features from eval_set_loader, then the classifier heads
        over the padded class set in chunks, the fusion and the export."""
        cfg = self.cfg
        shots = max(cfg.DATASET.NUM_SHOTS, 1)
        feats = collect_exemplar_features(
            self.dm.eval_set_loader, self._features, self.serving_params, self.n_cls, shots,
            self.clip_cfg.embed_dim,
        )
        self.classifiers = mm_generate_classifiers(
            self.serving_params, self.clip_cfg, self.agg_params, feats, *self._prompt_np,
            float(cfg.EVAL_TAU), class_chunk=cfg.CUDA.CLASS_CHUNK,
            class_pad_multiple=cfg.CUDA.CLASS_PAD_MULTIPLE,
            text_cls_max_classes=cfg.CUDA.TEXT_CLS_MAX_CLASSES, block_fn=self.block_fn,
            output_dir=self.output_dir if is_primary() else None, mesh=self.mesh,
        )
        return self.classifiers

    def prepare_test(self):
        cfg = self.cfg
        if cfg.EVAL_MODE not in ("text", "vision", "multimodal", "fusion"):
            # validate before the (expensive) classifier generation
            raise ValueError(
                f"unknown EVAL_MODE {cfg.EVAL_MODE!r}; expected "
                "text | vision | multimodal | fusion"
            )
        if self.classifiers is None:
            self.generate_classifiers()
        if cfg.EVAL_MODE in ("text", "fusion") and "text_classifier" not in self.classifiers:
            raise ValueError(
                f"EVAL_MODE {cfg.EVAL_MODE!r} needs the frozen text classifier, which was "
                f"skipped at {self.n_cls} classes (the reference >=5000-class guard). Use "
                "vision/multimodal, or raise CUDA.TEXT_CLS_MAX_CLASSES to force the text head."
            )
        print(f"(eval mode: {cfg.EVAL_MODE})")

    def model_inference(self, batch, scale_no=0):
        # scale_no accepted-and-ignored, like the reference model (mm_…:294)
        logit_scale = float(self.clip_params["logit_scale"].float().exp())
        feats = self._features(self.serving_params, batch["img"])
        return ovmr.eval_logits_np(feats, self.classifiers, logit_scale, self.cfg.EVAL_MODE)
