"""OpenAI-clip-shaped compatibility API on PyTorch/CUDA.

Counterpart of ``ovmr_tpu/clip_compat.py``. Downstream reference users
import the vendored ``clip`` package directly (``from clip import clip;
model, preprocess = clip.load("ViT-B/16")``, reference
``clip/clip.py:79-186``); this module mirrors that surface on the port's
towers so such call sites port one for one:

    from ovmr_tpu_torch import clip_compat as clip

    model, preprocess = clip.load("ViT-B/16")
    image = preprocess(Image.open("cat.png"))[None]
    text = clip.tokenize(["a cat", "a dog"])
    image_features = model.encode_image(image)
    text_features = model.encode_text(text)
    logits_per_image, logits_per_text = model(image, text)

``load`` resolves checkpoints like the trainers (``$OVMR_CLIP_CKPT``, then
the cache) and falls back to seeded random weights where there is none
(smoke mode, loudly). The model runs on the CUDA card unless the caller
passes ``device="cpu"``. On the card both towers run the kernels K1/K2
through :func:`ovmr_tpu_torch.models.clip.run_blocks`' default block in
every dtype, fp16 included (the JAX class sends fp16 to XLA because its
Pallas blocks do not take it; K1/K2 do); on the CPU that block runs their
plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models.zoo import available_models, resolve
from ovmr_tpu_torch.text.tokenize_fn import tokenize

__all__ = ["available_models", "load", "tokenize", "CLIPModel"]


class CLIPModel:
    """Functional stand-in for the reference ``CLIP`` nn.Module: params and
    config on a device, with encode and logit methods (no gradients)."""

    def __init__(self, params, cfg: tclip.CLIPConfig, dtype=torch.bfloat16, device="cuda"):
        from ovmr_tpu_torch.api import resolve_device

        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = tclip.cast_params(tclip.tree_to(params, device=self.device), dtype)

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.params["logit_scale"]

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device, self.dtype)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device)

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        """images [B, 3, H, W] (CHW float, the preprocess output) -> [B, D]."""
        return tclip.encode_image(self.params, self.cfg, self._images(images))

    @torch.inference_mode()
    def encode_text(self, tokens) -> torch.Tensor:
        """tokens [B, 77] int -> [B, D]."""
        return tclip.encode_text(self.params, self.cfg, self._tokens(tokens))

    @torch.inference_mode()
    def __call__(self, images, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image [B, N], logits_per_text [N, B]) in fp32: the
        reference ``CLIP.forward`` contract (both sides L2-normalised,
        scaled by exp(logit_scale))."""
        return tclip.clip_forward(self.params, self.cfg, self._images(images),
                                  self._tokens(tokens), out_dtype=torch.float32)


def _preprocess(resolution: int):
    """The published CLIP eval transform (resize shorter side -> center
    crop -> CLIP-normalised CHW float32), PIL-bicubic-faithful."""
    from ovmr_tpu_torch.data.transforms import (
        BICUBIC,
        CLIP_MEAN,
        CLIP_STD,
        center_crop,
        normalize,
        resize_smaller_edge,
        to_chw_float,
    )

    def fn(img) -> np.ndarray:
        img = resize_smaller_edge(img.convert("RGB"), resolution, BICUBIC)
        img = center_crop(img, (resolution, resolution))
        return normalize(to_chw_float(img), CLIP_MEAN, CLIP_STD)

    return fn


def load(name: str, download_root: Optional[str] = None, dtype=torch.bfloat16, seed: int = 0,
         device="cuda"):
    """Returns ``(CLIPModel, preprocess)`` for a zoo name or checkpoint path
    (reference ``clip.load``; its ``jit`` argument has no counterpart)."""
    import os.path as osp

    fname = osp.expanduser(name)
    path = fname if osp.isfile(fname) else resolve(name, download_root)
    if path is not None:
        from ovmr_tpu_torch.models.import_torch import load_clip

        params, cfg = load_clip(path)
    else:
        if name not in tclip.CONFIGS:
            raise KeyError(f"unknown model {name!r}; available: {available_models()}")
        print(f"WARNING: no local checkpoint for {name}; using RANDOM weights (smoke-run mode)")
        cfg = tclip.CONFIGS[name]
        params = tclip.init_params(cfg, seed=seed)
    return CLIPModel(params, cfg, dtype=dtype, device=device), _preprocess(cfg.image_resolution)
