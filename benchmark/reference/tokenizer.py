"""Plain CLIP byte-level BPE tokenizer for ASCII text.

A frozen copy of the semantics of OpenAI CLIP's ``SimpleTokenizer``
(``clip/simple_tokenizer.py``), kept with the benchmark so that the
reference works out the token ids of every prompt on its own: the same
byte-to-unicode alphabet, the merge table of the public
``bpe_simple_vocab_16e6.txt.gz`` (copied beside this file), the same vocab
order and the same pre-tokenisation pattern. It takes ASCII text only (every
LVIS v1 name is ASCII), where ``ftfy.fix_text`` changes nothing and the
pattern's ``\\p{L}`` and ``\\p{N}`` are ``[a-z]`` and ``[0-9]`` after
lower-casing; other text is refused.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re

import numpy as np

BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77
_N_MERGES = 49152 - 256 - 2
_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def _bytes_to_unicode() -> dict:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class Tokenizer:
    def __init__(self, bpe_path: str = BPE_PATH):
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")[1:1 + _N_MERGES]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.cache = {}

    def bpe(self, token: str) -> list:
        if token in self.cache:
            return self.cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.cache[token] = word
        return word

    def encode(self, text: str) -> list:
        if not text.isascii():
            raise ValueError(f"the reference tokenizer takes ASCII text only: {text!r}")
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()
        ids = []
        for piece in _PATTERN.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(mapped))
        return ids


@functools.lru_cache()
def tokenizer() -> Tokenizer:
    return Tokenizer()


def tokenize(texts) -> np.ndarray:
    """SOT + ids + EOT, zero-padded to [N, 77] int64."""
    tok = tokenizer()
    out = np.zeros((len(texts), CONTEXT_LENGTH), np.int64)
    for i, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > CONTEXT_LENGTH:
            raise ValueError(f"{text!r} is longer than {CONTEXT_LENGTH} tokens")
        out[i, :len(ids)] = ids
    return out


def prompt_tokens(classnames):
    """OVMR's prompts: ``"a {name}."`` with underscores as spaces, their EOT
    positions, and the visual template ``"a ."``."""
    names = [str(n).replace("_", " ") for n in classnames]
    tokens = tokenize([f"a {n}." for n in names])
    return tokens, tokens.argmax(axis=1), tokenize(["a ."])[0]
