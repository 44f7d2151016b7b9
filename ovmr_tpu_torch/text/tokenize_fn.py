"""Fixed-shape tokenization for device consumption.

``tokenize()`` mirrors the reference wrapper (``clip/clip.py:187-223``):
SOT/EOT framing into a zero-padded ``[N, context_length]`` matrix with
optional truncation — but emits an int32 numpy array (TPU-friendly; token
ids < 49408 fit comfortably and int32 avoids an int64 device upcast).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from .tokenizer import get_tokenizer

CONTEXT_LENGTH = 77


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    if isinstance(texts, str):
        texts = [texts]

    tok = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids: List[int] = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot_token
        result[i, : len(ids)] = ids
    return result


def eot_indices(token_matrix: np.ndarray) -> np.ndarray:
    """Index of the EOT token per row. The reference uses ``argmax(-1)``
    because EOT is the largest id in any sequence; same trick here."""
    return np.asarray(token_matrix).argmax(axis=-1)
