"""CoOp trainer with frozen pretrained vokens: OVMR's stage 2 ("OVMR†").

Counterpart of ``ovmr_tpu/engine/coop.py`` (reference
``trainers/coop_mm_classifier.py``):

- learnable context vectors ``ctx`` (generic ``[n_ctx, D]`` or
  class-specific ``[n_cls, n_ctx, D]`` with ``TRAINER.COOP.CSC``),
  optionally initialised from ``CTX_INIT`` words, as the only trained
  state (a ``requires_grad`` tensor updated by a ``torch.optim`` optimizer);
- per-class frozen visual tokens from a stage-1 ``visual_tokens.pt``
  (``VISUAL_TOKEN_PATH``), or zero vokens with a warning;
- three prompt variants built by concatenating embeddings
  (``coop_…:158-219``)::

      mm = [prefix, ctx, vokens, suffix[:-2]]
      v  = [prefix, ctx, vokens, vis_tail]
      t  = [prefix, ctx, suffix]

  with the EOT gather at ``argmax + voken_len`` for mm and v (the inserted
  vokens shift the EOT) and at ``argmax`` for t;
- the train loss CE(mm) + CE(v) + CE(t), accuracy on the mm logits; above
  400 classes CE of ONE prompt a step, drawn from
  ``np.random.default_rng(max(SEED, 0))`` (``coop_…:317-337``): numpy's
  stream is the JAX package's, so the port draws what JAX draws, and only
  the drawn prompt's tower runs;
- eval is always the preference fusion at tau 10 (``coop_…:299``), with the
  fusion weight computed once and kept (``coop_…:348-349``).

The text tower is differentiated into ``ctx`` through
``train_step._text_tower_block_fn(fused_residual_block)``: on the card the
kernels K1/K2 forward and K4/K3 backward. The image tower runs K1/K2 without
gradients. The step takes ``prompt_ind`` as an argument, so tests inject
it. On a mesh (``CUDA.MESH``, :func:`ovmr_tpu_torch.engine.trainer.setup_trainer_mesh`;
JAX ``:241-352``) the image batch shards over 'data': each shard encodes
its rows and runs the text features itself, its CE over its own rows; the
loss, the accuracy and the ``ctx`` gradients are averaged over 'data'.
A model axis runs the towers as the mesh's block (the TP block of K7/K8, or
the GSPMD route). A batch the data axis does not divide runs the
single-program step, with one warning.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine.optimizers import build_optimizer, set_lr
from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
from ovmr_tpu_torch.engine.train_step import _text_tower_block_fn
from ovmr_tpu_torch.engine.trainer import (
    _DTYPES,
    TRAINER_REGISTRY,
    TrainerBase,
    collect_exemplar_features,
    load_or_init_clip,
    make_feature_extractor,
    setup_trainer_mesh,
)
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.fusion import fusion_weights_from_f1, multiclass_f1
from ovmr_tpu_torch.ops.layers import l2_normalize
from ovmr_tpu_torch.parallel.mesh import place_local_batch, shard_batch
from ovmr_tpu_torch.text import tokenize

# above this many classes a step trains one random prompt (``coop_…:317``)
ONE_PROMPT_ABOVE = 400


@TRAINER_REGISTRY.register()
class CoOp(TrainerBase):
    # the towers' block and the mesh, until build_model sets them
    block_fn = staticmethod(fused_residual_block)
    mesh = None

    def build_data_manager(self):
        # stage-2 batches are plain image rows: each rank may decode its own
        return DataManager(self.cfg, allow_local_batches=True,
                           local_model_axis=self.cfg.CUDA.MESH.MODEL)

    def build_model(self):
        from ovmr_tpu_torch.api import resolve_device

        cfg = self.cfg
        self.device = resolve_device(cfg.CUDA.DEVICE)
        self.dtype = _DTYPES[cfg.CUDA.DTYPE]
        clip_params, self.clip_cfg = load_or_init_clip(cfg)
        self.clip_params = tclip.cast_params(
            tclip.tree_to(clip_params, device=self.device), self.dtype)
        self.mesh, self._tp, self.clip_params, self.block_fn = setup_trainer_mesh(
            cfg, self.clip_params, clip_cfg=self.clip_cfg, label="CoOp")
        dim = self.clip_cfg.transformer_width

        classnames = [c.replace("_", " ") for c in self.dm.dataset.classnames]
        self.n_cls = len(classnames)
        n_ctx = cfg.TRAINER.COOP.N_CTX
        ctx_init = cfg.TRAINER.COOP.CTX_INIT
        if ctx_init:
            ctx_init = ctx_init.replace("_", " ").strip()
            n_ctx = len(ctx_init.split(" "))
            emb = self._embed([ctx_init])
            ctx = emb[0, 1 : 1 + n_ctx, :].float()
            prompt_prefix = ctx_init
        else:
            shape = (self.n_cls, n_ctx, dim) if cfg.TRAINER.COOP.CSC else (n_ctx, dim)
            gen = torch.Generator().manual_seed(max(cfg.SEED, 0))
            ctx = 0.02 * torch.randn(shape, generator=gen)
            prompt_prefix = " ".join(["X"] * n_ctx)
        self.n_ctx = n_ctx
        print(f'Initial context: "{prompt_prefix}" (n_ctx={n_ctx})')

        tokenized = tokenize([f"{prompt_prefix} {name}." for name in classnames])
        self.eot_idx = torch.as_tensor(tokenized.argmax(-1).astype(np.int64), device=self.device)
        emb = self._embed(tokenized)
        self.token_prefix = emb[:, :1, :]
        self.token_suffix = emb[:, 1 + n_ctx :, :]
        vis_emb = self._embed([f"{prompt_prefix}."])
        # tail of the visual template after [SOT, ctx...]: [".", EOT, pad...]
        self.vis_tail = vis_emb[:, 1 + n_ctx : vis_emb.shape[1] - 2, :]

        # frozen stage-1 vokens
        vt_path = cfg.TRAINER.COOP.VISUAL_TOKEN_PATH
        if vt_path:
            vt = torch.load(vt_path, map_location="cpu", weights_only=False)["visual_tokens"]
            self.visual_tokens = vt.float().to(self.device)
        else:
            print("WARNING: no VISUAL_TOKEN_PATH; using zero vokens (CoOp-only mode)")
            self.visual_tokens = torch.zeros((self.n_cls, 2, dim), device=self.device)
        self.voken_len = int(self.visual_tokens.shape[1])

        self.params = {"ctx": ctx.to(self.device).requires_grad_(True)}
        self.optimizer = build_optimizer(cfg.OPTIM, self.params)
        self.lr_table = lr_schedule_from_cfg(cfg.OPTIM)
        self.py_rng = np.random.default_rng(max(cfg.SEED, 0))
        self.classifiers = None
        self._fusion_weight_cache = None
        # the data-only mesh keeps the single-program encode (stage-2 eval
        # sets are small, JAX :274-286); a model axis encodes on the mesh
        self._features = make_feature_extractor(
            self.clip_cfg, self.dtype, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
            cfg.DATALOADER.TEST.BATCH_SIZE, device=self.device,
            u8_normalize="normalize" in cfg.INPUT.TRANSFORMS, tp_block_fn=self.block_fn,
            mesh=self.mesh if self._tp else None)

    def _embed(self, texts) -> torch.Tensor:
        """Token embeddings [N, 77, D] of texts (or token rows) in the
        towers' dtype, on the device."""
        tokens = tokenize(texts) if isinstance(texts, list) else texts
        return tclip.embed_tokens(self.clip_params, torch.as_tensor(tokens, device=self.device))

    def resume_model_if_exist(self, directory) -> int:
        return ckpt.resume_from_checkpoint(directory, "prompt_learner", self.params,
                                           self.optimizer,
                                           backend=self.cfg.CUDA.CHECKPOINT_BACKEND)

    # ------------------------------------------------------------------
    def _prompt(self, ind: int):
        """Prompt ``ind`` (0 mm, 1 v, 2 t) as ``(embeddings [n_cls, 77, D],
        EOT index [n_cls])`` from the current ``ctx``."""
        ctx = self.params["ctx"]
        if ctx.ndim == 2:
            ctx = ctx[None].expand(self.n_cls, *ctx.shape)
        ctx = ctx.to(self.dtype)
        prefix, suffix = self.token_prefix, self.token_suffix
        vokens = self.visual_tokens.to(self.dtype)
        if ind == 0:
            parts = [prefix, ctx, vokens, suffix[:, :-2]]
        elif ind == 1:
            tail = self.vis_tail.expand(self.n_cls, *self.vis_tail.shape[1:])
            parts = [prefix, ctx, vokens, tail]
        else:
            parts = [prefix, ctx, suffix]
        eot = self.eot_idx + (self.voken_len if ind < 2 else 0)
        return torch.cat(parts, dim=1), eot

    def text_features(self, which: Sequence[int] = (0, 1, 2)):
        """Unit text features [n_cls, D] of the prompts ``which`` (0 mm, 1 v,
        2 t), in the towers' dtype; differentiable in ``ctx``."""
        block_fn = _text_tower_block_fn(self.block_fn)
        return [
            l2_normalize(tclip.encode_text_embeds(self.clip_params, self.clip_cfg, x, eot,
                                                  block_fn=block_fn))
            for x, eot in (self._prompt(i) for i in which)
        ]

    def _shard_loss(self, images, labels, which):
        """CE of one shard's rows over the prompts ``which`` (summed) and
        its mm logits (the accuracy's basis)."""
        with torch.no_grad():
            feats = l2_normalize(tclip.encode_image(self.clip_params, self.clip_cfg, images,
                                                    block_fn=self.block_fn)).float()
            scale = self.clip_params["logit_scale"].float().exp()
        loss, acc_logits = 0.0, None
        for f in self.text_features(which):
            logits = scale * feats @ f.float().T
            if acc_logits is None:
                acc_logits = logits  # mm: the reference's accuracy basis
            loss = loss + F.cross_entropy(logits, labels)
        return loss, (acc_logits.argmax(1) == labels).float().mean() * 100.0

    def train_step(self, images: torch.Tensor, labels: torch.Tensor, prompt_ind: int = 0,
                   mesh=None):
        """One optimizer step of ``ctx`` on a batch on the device; returns
        (loss, accuracy in percent) as tensors. Above 400 classes only prompt
        ``prompt_ind`` is trained, else all three. With a ``mesh`` the rows
        are this process's, split over its local data shards: each shard's
        loss is differentiated, the gradients summed over 'data' and divided
        by its size, and the loss and accuracy averaged likewise."""
        which = (prompt_ind,) if self.n_cls > ONE_PROMPT_ABOVE else (0, 1, 2)
        self.optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss, acc = self._shard_loss(images, labels, which)
            loss.backward()
            self.optimizer.step()
            return loss.detach(), acc
        data = mesh.data
        parts = [self._shard_loss(x, y, which)
                 for x, y in zip(data.split(images), data.split(labels))]
        loss = sum(p[0] for p in parts)
        loss.backward()
        with torch.no_grad():
            grad = self.params["ctx"].grad
            if grad is not None:
                data.sum_(grad).div_(data.size)
        self.optimizer.step()
        both = torch.stack([loss.detach(), sum(p[1] for p in parts)])
        loss, acc = data.sum_(both) / data.size
        return loss, acc

    def before_epoch(self):
        set_lr(self.optimizer, self.lr_table[self.epoch])

    def forward_backward(self, batch):
        prompt_ind = int(self.py_rng.integers(0, 3)) if self.n_cls > ONE_PROMPT_ABOVE else 0
        images = torch.as_tensor(batch["img"])
        labels = torch.as_tensor(batch["label"])
        mesh = self.mesh
        local = bool(batch.get("_local", False)) and mesh is not None
        sharded = local or (mesh is not None and images.shape[0] % mesh.data.size == 0)
        if mesh is not None and not sharded and not getattr(self, "_warned_unsharded", False):
            self._warned_unsharded = True
            print(
                f"WARNING: CoOp batch {images.shape[0]} not divisible by the data axis "
                f"({mesh.data.size}) runs replicated over 'data'; choose BATCH_SIZE divisible "
                "by the mesh"
            )
        if local:
            images, labels = place_local_batch(mesh, images, labels)
        elif sharded:
            images, labels = shard_batch(mesh, images), shard_batch(mesh, labels)
        args = (images.to(self.device, self.dtype), labels.to(self.device, torch.long),
                prompt_ind)
        loss, acc = self.train_step(*args, mesh=mesh) if sharded else self.train_step(*args)
        return {"loss": float(loss), "acc": float(acc), "lr": self.lr_table[self.epoch]}

    def save_model(self, epoch, model_name=""):
        ckpt.save_checkpoint(self.output_dir, "prompt_learner", epoch, self.params,
                             self.optimizer, model_name=model_name,
                             backend=self.cfg.CUDA.CHECKPOINT_BACKEND)

    def load_model(self, directory, epoch=None):
        if not directory:
            return
        params, _, ep = ckpt.load_checkpoint(directory, "prompt_learner", self.params,
                                             epoch=epoch, torch_converter=_ctx_from_torch,
                                             backend=self.cfg.CUDA.CHECKPOINT_BACKEND)
        ckpt.copy_into(self.params, params)
        print(f'Loaded ctx vectors from "{directory}" (epoch = {ep})')

    # ------------------------------------------------------------------
    def get_fusion_weight(self, mm_f, v_f, t_f) -> np.ndarray:
        """Per-class F1 on the exemplar set -> softmax(10 * F1) [n_cls, 3]
        (reference ``coop_…:235-305``; tau hard-coded 10), grouping by the
        loader's per-class group size (``DATASET.NUM_SHOTS``) as the JAX
        trainer does."""
        shots = max(self.cfg.DATASET.NUM_SHOTS, 1)
        dim = self.clip_cfg.embed_dim
        feats = collect_exemplar_features(self.dm.eval_set_loader, self._features,
                                          self.clip_params, self.n_cls, shots, dim)
        # rounded through the compute dtype, as the reference stores them
        # half precision (``mm_…:224``)
        feats = torch.from_numpy(feats).to(self.dtype).float().numpy()
        scale = self._logit_scale()
        flat = feats.reshape(-1, dim)
        labels = torch.as_tensor(np.repeat(np.arange(self.n_cls), shots))
        f1s = [multiclass_f1(torch.from_numpy(scale * flat @ np.asarray(c, np.float32).T),
                             labels, self.n_cls) for c in (mm_f, v_f, t_f)]
        return fusion_weights_from_f1(*f1s, 10.0).numpy()

    def prepare_test(self):
        with torch.no_grad():
            mm_f, v_f, t_f = (f.float().cpu().numpy() for f in self.text_features())
        if self._fusion_weight_cache is None:
            self._fusion_weight_cache = self.get_fusion_weight(mm_f, v_f, t_f)
        self.classifiers = {
            "mm_classifier": mm_f,
            "vision_classifier": v_f,
            "text_classifier": t_f,
            "fusion_weight": self._fusion_weight_cache,
        }
        print("(eval mode: CoOp fusion)")

    def _logit_scale(self) -> float:
        return float(np.exp(self.clip_params["logit_scale"].float().cpu().numpy()))

    def model_inference(self, batch, scale_no=0):
        # scale_no accepted-and-ignored, like the reference (coop_…:307)
        scale = self._logit_scale()
        feats = self._features(self.clip_params, batch["img"])
        return ovmr.eval_logits_np(feats, self.classifiers, scale, "fusion")


# reachable under the reference's config-directory name too: scripts that
# pair TRAINER=MM_CLS with configs/trainers/MM_CLS/*.yaml resolve here
TRAINER_REGISTRY.register_alias("MM_CLS", CoOp)


def _ctx_from_torch(path):
    """Reference CoOp ``model.pth.tar-*`` -> ``({"ctx"}, epoch)``."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)
    return {"ctx": sd["ctx"].float()}, int(payload.get("epoch", 0))
