"""Local lookup of published CLIP checkpoints.

Counterpart of ``ovmr_tpu/models/zoo.py`` ``resolve`` as a local lookup
only: ``$OVMR_CLIP_CKPT``, then the reference cache ``~/.cache/clip``
(``clip/clip.py:29-70`` file names). Downloading is not ported yet.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

# checkpoint file names of the published OpenAI CLIP models
_FILES = {
    "RN50": "RN50.pt",
    "RN101": "RN101.pt",
    "RN50x4": "RN50x4.pt",
    "RN50x16": "RN50x16.pt",
    "RN50x64": "RN50x64.pt",
    "ViT-B/32": "ViT-B-32.pt",
    "ViT-B/16": "ViT-B-16.pt",
    "ViT-L/14": "ViT-L-14.pt",
    "ViT-L/14@336px": "ViT-L-14-336px.pt",
}


def available_models():
    """The published model names (reference ``clip.available_models``)."""
    return list(_FILES)


def resolve(name: str, root: Optional[str] = None) -> Optional[str]:
    """Local path of checkpoint ``name`` ($OVMR_CLIP_CKPT, then the cache
    file), or None when neither exists (the caller decides the fallback)."""
    env = os.environ.get("OVMR_CLIP_CKPT")
    if env and osp.exists(env):
        return env
    if name in _FILES:
        cached = osp.join(root or osp.expanduser("~/.cache/clip"), _FILES[name])
        if osp.exists(cached):
            return cached
    return None
