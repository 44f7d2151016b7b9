"""CLIP byte-level BPE tokenizer.

A from-scratch implementation producing token ids identical to OpenAI CLIP's
``SimpleTokenizer`` (reference ``clip/simple_tokenizer.py:62-132``): same
byte<->unicode alphabet, same merge table (loaded from the public
``bpe_simple_vocab_16e6.txt.gz`` asset), same vocab ordering and the same
pre-tokenization regex. Tokenization is host-side, setup-time work; the
device only ever sees fixed-shape int32 id matrices (see :mod:`.tokenize_fn`).

The reference cleans text with ``ftfy.fix_text``; when ftfy is absent we
fall back to the vendored minimal subset (:mod:`.fix_text` — mojibake
repair, ligatures, width, quotes, NFC), so byte-mangled inputs tokenize
to the same ids the reference produces.

A copy of ``ovmr_tpu/text/tokenizer.py`` that needs no third-party
module: the reference's pre-tokenization pattern uses the ``regex``
module's ``\\p{L}``/``\\p{N}`` classes, which the standard ``re`` lacks, so
:func:`pretokenize` walks the same alternation by hand over
``unicodedata`` categories. The two agree on every character that both
Unicode databases assign (``regex`` may ship a newer Unicode version than
the interpreter's ``unicodedata``).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, List, Tuple

from ovmr_tpu_torch.utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BPE_PATH = os.path.join(_HERE, "assets", "bpe_simple_vocab_16e6.txt.gz")

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"

# number of merge rules in the CLIP vocab; the final vocab is
# 2*256 byte units + _N_MERGES merged tokens + 2 specials = 49408
_N_MERGES = 49152 - 256 - 2


@functools.lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte -> printable-unicode mapping."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


# the Unicode White_Space property: what the reference pattern's ``\s``
# matches (str.isspace additionally accepts U+001C-001F)
_WHITESPACE_CLASS = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
)
_WHITESPACE_RUN = re.compile("[" + _WHITESPACE_CLASS + "]+")
_WHITESPACE = frozenset(
    chr(c) for c in range(0x3001) if _WHITESPACE_RUN.fullmatch(chr(c))
)
_SPECIALS = (SOT_TEXT, EOT_TEXT)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _fold(ch: str) -> str:
    """Simple case folding of one character (the pattern's IGNORECASE)."""
    folded = ch.casefold()
    return folded if len(folded) == 1 else ch


def _starts_with_folded(text: str, i: int, lit: str) -> bool:
    if len(text) - i < len(lit):
        return False
    return all(_fold(text[i + j]) == c for j, c in enumerate(lit))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


# matched by no branch of the pattern under IGNORECASE (U+0345, a
# combining mark whose case fold is a letter), so findall skips it
_UNMATCHED = frozenset("\u0345")


def pretokenize(text: str) -> List[str]:
    """The reference pattern, tried left to right at each position exactly
    as ``regex.findall`` does with IGNORECASE:
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``."""
    pieces: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        lit = next(
            (s for s in _SPECIALS + _CONTRACTIONS if _starts_with_folded(text, i, s)),
            None,
        )
        if lit is not None:
            j = i + len(lit)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif ch in _WHITESPACE or ch in _UNMATCHED:
            i += 1
            continue
        else:
            j = i + 1
            while j < n and not (
                text[j] in _WHITESPACE
                or text[j] in _UNMATCHED
                or _is_letter(text[j])
                or _is_number(text[j])
            ):
                j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


def _clean_text(text: str) -> str:
    try:  # real ftfy when present (the reference's exact dependency)
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        from ovmr_tpu_torch.text.fix_text import fix_text

        text = fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE_RUN.sub(" ", text)
    return text.strip()


class ClipTokenizer:
    """Byte-level BPE with the CLIP 49152-entry vocabulary."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self._b2u = byte_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a header; then one merge rule per line
        merge_lines = lines[1 : 1 + _N_MERGES]
        merges: List[Tuple[str, str]] = []
        for ln in merge_lines:
            a, b = ln.split()
            merges.append((a, b))
        self._rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}

        units = list(self._b2u.values())
        vocab: List[str] = units + [u + "</w>" for u in units]
        vocab.extend(a + b for a, b in merges)
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}

        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]
        self.vocab_size = len(vocab)

        self._word_cache: Dict[str, List[str]] = {
            SOT_TEXT: [SOT_TEXT],
            EOT_TEXT: [EOT_TEXT],
        }

    # -- BPE merge loop ------------------------------------------------------
    def _merge_word(self, token: str) -> List[str]:
        cached = self._word_cache.get(token)
        if cached is not None:
            return cached

        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            # find the highest-priority adjacent pair
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                r = self._rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_idx = i
            if best_rank is None:
                break
            first, second = parts[best_idx], parts[best_idx + 1]
            # merge every non-overlapping occurrence of (first, second)
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        self._word_cache[token] = parts
        return parts

    # -- public API ---------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        with trace.span("prompt.clean", host_only=True):
            text = _clean_text(text).lower()
        with trace.span("prompt.bpe", host_only=True):
            for raw in pretokenize(text):
                mapped = "".join(self._b2u[b] for b in raw.encode("utf-8"))
                ids.extend(self.encoder[piece] for piece in self._merge_word(mapped))
        return ids

    def decode(self, ids: List[int]) -> str:
        joined = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self._u2b[ch] for ch in joined)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()
