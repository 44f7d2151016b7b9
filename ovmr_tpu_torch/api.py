"""High-level plug-and-play API on PyTorch/CUDA.

Counterpart of ``ovmr_tpu/api.py``. The reference's product is the
exported classifier artifact (``mm_classifiers.pt``) that drops into other
projects' open-vocabulary heads; this module runs the same flow:

    from ovmr_tpu_torch.api import OVMRGenerator

    gen = OVMRGenerator.from_checkpoints("~/.cache/clip/ViT-B-16.pt",
                                         "checkpoints/prompt_learner/model.pth.tar-30")
    out = gen.generate(classnames, exemplar_images)   # images [N, K, 3, H, W]
    # out: text/vision/mm classifiers [N, D], fusion_weight [N, 3]
    probs = gen.classify(images, out, mode="fusion")
    gen.export(out, "output_dir")

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit ``"cpu"`` they raise. On the
card the CLIP towers' transformer blocks run the hand-written kernels K1/K2
(:func:`ovmr_tpu_torch.ops.block_fused.fused_residual_block`; a ResNet
image tower is cuDNN convolutions, as XLA computes it in the JAX package)
and the aggregator runs K6 (:func:`ovmr_tpu_torch.ops.attention.fused_attention`),
the models' defaults; on the CPU the same wrappers take their plain
PyTorch versions. A backbone whose image features are wider than its text
tower (RN50: 1024 against 512) builds, and ``generate()`` refuses it where
the JAX package's does: the vokens cannot be spliced into the prompts.
"""

from __future__ import annotations

import os.path as osp
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ovmr_tpu_torch.engine.trainer import encode_features, mm_generate_classifiers
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.models.aggregator import init_aggregator


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (there is no quiet fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "OVMRGenerator: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"OVMRGenerator runs on 'cuda' or 'cpu', not {dev}")
    return dev


class OVMRGenerator:
    def __init__(
        self,
        clip_params: dict,
        clip_cfg: tclip.CLIPConfig,
        agg_params: dict,
        dtype=torch.bfloat16,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.clip_cfg = clip_cfg
        self.dtype = dtype
        self.clip_params = tclip.cast_params(
            tclip.tree_to(clip_params, device=self.device), dtype
        )
        self.agg_params = tclip.tree_to(agg_params, device=self.device)

    @classmethod
    def from_checkpoints(
        cls,
        clip_ckpt: str,
        generator_ckpt: Optional[str] = None,
        n_ctx: int = 2,
        dtype=torch.bfloat16,
        device="cuda",
        seed: int = 0,
    ) -> "OVMRGenerator":
        """``clip_ckpt`` is a torch checkpoint path or a backbone name
        ("ViT-B/16", "RN101", "TINY", ...) looked up locally
        (:func:`ovmr_tpu_torch.models.zoo.resolve`). With no local
        checkpoint the towers are random, seeded from ``seed`` (smoke mode),
        as the JAX package does; so is the aggregator without
        ``generator_ckpt``."""
        from ovmr_tpu_torch.models.import_torch import load_clip, load_prompt_learner
        from ovmr_tpu_torch.models.zoo import resolve

        resolve_device(device)
        path = osp.expanduser(clip_ckpt)
        if not osp.exists(path):
            path = resolve(clip_ckpt)
        if path is None:
            warnings.warn(
                f"no local CLIP checkpoint for {clip_ckpt!r}; using RANDOM "
                "weights (smoke-run mode)"
            )
            clip_cfg = tclip.CONFIGS.get(clip_ckpt, tclip.VIT_B16)
            clip_params = tclip.init_params(clip_cfg, seed=seed)
        else:
            clip_params, clip_cfg = load_clip(path)
        if generator_ckpt:
            agg_params, _ = load_prompt_learner(osp.expanduser(generator_ckpt))
        else:
            agg_params = init_aggregator(width=clip_cfg.embed_dim, n_ctx=n_ctx, seed=seed)
        return cls(clip_params, clip_cfg, agg_params, dtype=dtype, device=device)

    # ------------------------------------------------------------------
    def _encode(self, images, batch_size: int) -> torch.Tensor:
        """Unit image features [B, D] in the compute dtype, on the device,
        encoded ``batch_size`` images at a time."""
        images = torch.as_tensor(images)
        parts = [
            encode_features(self.clip_params, self.clip_cfg,
                            images[s : s + batch_size].to(self.device), self.dtype)
            for s in range(0, images.shape[0], batch_size)
        ]
        return torch.cat(parts)

    @torch.inference_mode()
    def encode_images(self, images, batch_size: int = 1024) -> np.ndarray:
        """images [B, 3, H, W] float (CLIP-normalized; numpy or tensor) ->
        unit features [B, D] float32."""
        return self._encode(images, batch_size).float().cpu().numpy()

    @torch.inference_mode()
    def generate(
        self, classnames: Sequence[str], exemplar_images, eval_tau: float = 10.0
    ) -> Dict[str, np.ndarray]:
        """classnames [N] + exemplar images [N, K, 3, H, W] -> classifiers."""
        exemplar_images = torch.as_tensor(exemplar_images)
        n, k = exemplar_images.shape[:2]
        feats = self._encode(
            exemplar_images.reshape(n * k, *exemplar_images.shape[2:]), 1024
        ).reshape(n, k, -1)
        return self.generate_from_features(classnames, feats, eval_tau=eval_tau)

    @torch.inference_mode()
    def generate_from_features(
        self,
        classnames: Sequence[str],
        exemplar_feats,
        eval_tau: float = 10.0,
        chunk_size: int = 2048,
        max_text_classes: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Exemplar features [N, K, D] (numpy or tensor) -> classifiers, by
        :func:`ovmr_tpu_torch.engine.trainer.mm_generate_classifiers`.

        Class counts above ``chunk_size`` run the class axis in chunks
        (:func:`ovmr.generate_classifiers_chunked`, bounding text-tower
        activations); the preference fusion then runs once over the full
        set. ``max_text_classes`` mirrors the reference's >=5000-class
        guard: at or above it the frozen text head and the fusion are
        skipped (keys absent from the result)."""
        ptok, eot, vtok = ovmr.build_prompt_tokens(classnames)
        limit = ovmr.TEXT_CLS_MAX_CLASSES if max_text_classes is None else int(max_text_classes)
        return mm_generate_classifiers(
            self.clip_params, self.clip_cfg, self.agg_params, exemplar_feats, ptok, eot, vtok,
            eval_tau, class_chunk=chunk_size, class_pad_multiple=1, text_cls_max_classes=limit,
        )

    @torch.inference_mode()
    def classify(
        self, images, classifiers: Dict[str, np.ndarray], mode: str = "fusion"
    ) -> np.ndarray:
        """Query images [B, 3, H, W] -> softmaxed scores [B, N] for ``mode``
        (text, vision, multimodal or fusion)."""
        feats = self._encode(images, 1024)
        scale = float(self.clip_params["logit_scale"].float().exp())
        dev = {k: torch.as_tensor(v, device=self.device) for k, v in classifiers.items()}
        return ovmr.eval_logits(feats, dev, scale, mode).cpu().numpy()

    def export(self, classifiers: Dict[str, np.ndarray], output_dir: str) -> None:
        """Write reference-compatible mm_classifiers.pt / visual_tokens.pt."""
        from ovmr_tpu_torch.engine.checkpoint import export_classifiers_torch

        export_classifiers_torch(classifiers, output_dir)


def load_exported_classifiers(path: str) -> Dict[str, np.ndarray]:
    """Read a (reference or ours) ``mm_classifiers.pt`` artifact: a dict of
    tensors, loaded without unpickling arbitrary objects."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in data.items()}
