"""Multi-resolution batch collate (``DATALOADER.MULTI_RES_COLLATE True``).

Counterpart of ``ovmr_tpu/data/multires.py`` (reference
``Dassl.pytorch/dassl/data/data_manager.py:15-67``,
``RandomAspectRatioCropResize`` + ``collate_fn_custom``, defined there and
never wired to a loader; the JAX package wires it as an opt-in batch
transform). Per batch, not per image, it draws one aspect ratio and one
short side, center-crops every image to that ratio, bilinear-resizes it to
the patch-multiple target, tosses one horizontal-flip coin for the whole
batch and normalises with CLIP's constants. The dim math is the
reference's:

- ``short_size`` from {112, 224, 336, 448, 560, 672}, floored to the patch
  multiple (identity for p in {14, 16});
- ratio > 1: height = short, width = int((height * ratio // p) * p);
  ratio <= 1: width = short, height = int((width / ratio // p) * p);
- crop: if ``orig_w / orig_h > ratio`` the width shrinks to
  ``int(orig_h * ratio)``, else the height to ``int(orig_w / ratio)``
  (PIL center crop);
- the reference's argless ``ColorJitter()`` is the identity and is left
  out.

The ratio comes from the JAX package's log-uniform grid (9 bins over
[1/2, 2]; ``ratio_bins=0`` draws the reference's continuous uniform), so
the port draws what JAX draws from the same ``random.Random`` and its
batches are the JAX package's bit for bit on the same images. On the card
the grid bounds the set of token counts the kernels meet; the ViT towers
take any grid through ``models/clip.resize_pos_embed``. PIL is imported
inside the functions that decode.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np

# CLIP normalisation (the reference collate hard-codes it)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class MultiResCollate:
    """Batch-level random-aspect-ratio crop and resize."""

    # batch-level: the loader draws one rng per batch and hands it in
    stochastic = True

    def __init__(
        self,
        patch_size: int = 14,
        short_sizes: Sequence[int] = (112, 224, 336, 448, 560, 672),
        ratio_range: tuple = (0.5, 2.0),
        ratio_bins: int = 9,
        mean: Sequence[float] = CLIP_MEAN,
        std: Sequence[float] = CLIP_STD,
        flip_p: float = 0.5,
    ):
        self.patch_size = patch_size
        # the short side feeds the stride-p patchify too, so it is floored
        # to a patch multiple (p = 32 floors 112 to 96)
        self.short_sizes = tuple(
            sorted({max(patch_size, (s // patch_size) * patch_size) for s in short_sizes})
        )
        self.ratio_range = ratio_range
        # log-uniform, so 1/r is on the grid whenever r is
        if not ratio_bins:
            self.ratio_grid = None
        elif ratio_bins == 1:
            self.ratio_grid = (math.sqrt(ratio_range[0] * ratio_range[1]),)
        else:
            lo, hi = math.log(ratio_range[0]), math.log(ratio_range[1])
            self.ratio_grid = tuple(
                math.exp(lo + (hi - lo) * i / (ratio_bins - 1)) for i in range(ratio_bins)
            )
        self.mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(3, 1, 1)
        self.flip_p = flip_p

    def draw_shape(self, rng: random.Random):
        """One ``(ratio, resized_h, resized_w)`` draw for a batch."""
        if self.ratio_grid is not None:
            ratio = rng.choice(self.ratio_grid)
        else:
            ratio = rng.uniform(*self.ratio_range)
        short = rng.choice(self.short_sizes)
        p = self.patch_size
        if ratio > 1:
            h = short
            w = int((h * ratio // p) * p)
        else:
            w = short
            h = int((w / ratio // p) * p)
        return ratio, h, w

    def _crop_resize(self, img, ratio: float, h: int, w: int) -> np.ndarray:
        from PIL import Image

        ow, oh = img.size
        if ow / oh > ratio:
            tw, th = int(oh * ratio), oh
        else:
            tw, th = ow, int(ow / ratio)
        left = int(round((ow - tw) / 2.0))
        top = int(round((oh - th) / 2.0))
        img = img.crop((left, top, left + tw, top + th))
        img = img.resize((w, h), Image.BILINEAR)
        return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0

    def __call__(self, images, rng: random.Random) -> np.ndarray:
        """PIL images -> one normalised ``[B, 3, H, W]`` float32 batch at the
        batch's drawn shape."""
        ratio, h, w = self.draw_shape(rng)
        batch = np.stack([self._crop_resize(img, ratio, h, w) for img in images])
        if rng.random() < self.flip_p:  # one coin for the whole batch
            batch = batch[..., ::-1]
        batch = (batch - self.mean) / self.std
        return np.ascontiguousarray(batch, np.float32)
