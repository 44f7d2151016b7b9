"""Zero-shot CLIP trainers.

Counterpart of ``ovmr_tpu/engine/zsclip.py`` (reference ``trainers/zsclip.py``,
the paper's baseline):

- ``ZeroshotCLIP``: the dataset's hand-crafted prompt template
  (``CUSTOM_TEMPLATES``), one text feature per class;
- ``ZeroshotCLIP2``: prompt ensembling over ``IMAGENET_TEMPLATES_SELECT``
  (7 templates) plus the dataset's custom template, except for ImageNet,
  which the reference skips (``zsclip.py:67-83``). Features are averaged
  over templates, then normalised.

The text classifier is built once in ``build_model``; ``train()`` runs
``test()``. Both towers run the kernels K1/K2 on the card (their plain
twins on the CPU). On a mesh (``CUDA.MESH``, JAX ``:55-67``) the towers run
the mesh's block (K7/K8 on a model axis, or the GSPMD route) and the eval
encode shards its rows over 'data'.
"""

from __future__ import annotations

import numpy as np
import torch

from ovmr_tpu_torch.engine.trainer import (
    _DTYPES,
    TRAINER_REGISTRY,
    TrainerBase,
    load_or_init_clip,
    make_feature_extractor,
    setup_trainer_mesh,
)
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.ops.layers import l2_normalize
from ovmr_tpu_torch.text import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES_SELECT, tokenize


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(TrainerBase):
    def get_templates(self):
        return [CUSTOM_TEMPLATES.get(self.cfg.DATASET.NAME, "a photo of a {}.")]

    def build_model(self):
        from ovmr_tpu_torch.api import resolve_device

        cfg = self.cfg
        self.device = resolve_device(cfg.CUDA.DEVICE)
        self.dtype = _DTYPES[cfg.CUDA.DTYPE]
        clip_params, self.clip_cfg = load_or_init_clip(cfg)
        self.clip_params = tclip.cast_params(
            tclip.tree_to(clip_params, device=self.device), self.dtype)
        self.mesh, self._tp, self.clip_params, self.block_fn = setup_trainer_mesh(
            cfg, self.clip_params, clip_cfg=self.clip_cfg, label="ZeroshotCLIP")

        classnames = [c.replace("_", " ") for c in self.dm.dataset.classnames]
        templates = self.get_templates()
        feats_sum = None
        with torch.inference_mode():
            for template in templates:
                tokens = torch.as_tensor(tokenize([template.format(c) for c in classnames]),
                                         device=self.device)
                f = l2_normalize(tclip.encode_text(self.clip_params, self.clip_cfg, tokens,
                                                   block_fn=self.block_fn).float())
                feats_sum = f if feats_sum is None else feats_sum + f
            self.text_classifier = l2_normalize(feats_sum / len(templates)).cpu().numpy()
        self._features = None

    def train(self):
        print("ZeroshotCLIP has nothing to train; running test()")
        self.init_writer()
        return self.test()

    def prepare_test(self):
        if self._features is None:
            cfg = self.cfg
            self._features = make_feature_extractor(
                self.clip_cfg, self.dtype, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                cfg.DATALOADER.TEST.BATCH_SIZE, device=self.device,
                u8_normalize="normalize" in cfg.INPUT.TRANSFORMS, tp_block_fn=self.block_fn,
                mesh=self.mesh)
        print("(eval mode: zero-shot)")

    def model_inference(self, batch, scale_no=0):
        logit_scale = float(np.exp(self.clip_params["logit_scale"].float().cpu().numpy()))
        feats = self._features(self.clip_params, batch["img"])
        return logit_scale * feats @ self.text_classifier.T

    def load_model(self, directory, epoch=None):
        pass  # nothing to load


@TRAINER_REGISTRY.register()
class ZeroshotCLIP2(ZeroshotCLIP):
    """Prompt-ensembling variant: the SELECT templates plus the dataset's
    template (reference ``zsclip.py:63-99``), except for ImageNet
    (``zsclip.py:82-83``)."""

    def get_templates(self):
        templates = list(IMAGENET_TEMPLATES_SELECT)
        if self.cfg.DATASET.NAME != "ImageNet":
            templates.append(CUSTOM_TEMPLATES.get(self.cfg.DATASET.NAME, "a photo of a {}."))
        return templates
