"""Minimal ``ftfy.fix_text`` for the CLIP tokenizer's ``basic_clean``.

The reference cleans every prompt/classname with ``ftfy.fix_text``
(``clip/simple_tokenizer.py:50-52``) before BPE; ftfy is an optional
dependency here, so this module vendors the subset of its default fixers
that can actually change CLIP token ids:

- **mojibake repair** (``fix_encoding``): UTF-8 text that was mis-decoded
  as windows-1252/latin-1 — ``"sÃ©ance" -> "séance"`` —
  detected by the tell-tale lead-byte + continuation-char pattern and
  reversed by re-encoding through a *sloppy* windows-1252 (the five
  unmapped cp1252 bytes fall back to their C1 code points, as in ftfy's
  sloppy codecs). Applied iteratively, so double-mojibake unwinds too.
- **latin ligatures**: ``ﬁ -> fi`` etc. (ftfy ``fix_latin_ligatures``).
- **character width**: fullwidth forms -> ASCII, ideographic space ->
  space (ftfy ``fix_character_width``, sans the halfwidth-kana cases the
  suite never sees).
- **uncurl quotes**: ``’ -> '``, ``“ -> "`` (ftfy
  ``uncurl_quotes``).
- **line breaks / terminal escapes / control chars / lone surrogates**:
  normalized or stripped as ftfy's defaults do.
- **NFC normalization** (ftfy ``normalization="NFC"``).

Deliberately NOT ported: HTML unescaping (``basic_clean`` already runs
``html.unescape`` twice right after), language-model badness scoring
(the regex heuristic below covers the mis-decode signatures that occur
in practice), and the exotic encodings (sloppy cp1251 etc.) ftfy probes
for non-Latin scripts.

A copy of ``ovmr_tpu/text/fix_text.py`` that runs on the standard library
alone: every pattern here is a plain character class, which ``re`` reads
the same way as the third-party ``regex`` module.
"""

from __future__ import annotations

import re
import unicodedata

# what a UTF-8 continuation byte (0x80-0xBF) looks like after a cp1252
# or latin-1 mis-decode: the latin-1 block U+00A0-00BF, the
# windows-1252 "smart" characters for 0x80-0x9F, and ALL raw C1
# controls U+0080-009F (a latin-1 mis-decode maps every 0x80-0x9F byte
# straight to its C1 code point, e.g. 0x9F in "Stra\xdfe")
_W1252_TAILS = (
    " -¿"
    "€‚ƒ„…†‡ˆ‰Š"
    "‹ŒŽ‘’“”•–—"
    "˜™š›œžŸ"
    "\x80-\x9f"
)
# a UTF-8 lead byte (0xC2-0xF4) decoded as latin-1/cp1252 is an accented
# capital (U+00C2..U+00F4) — followed by a continuation-looking char it
# flags mojibake
_MOJIBAKE = re.compile("[Â-ô][" + _W1252_TAILS + "]")

# windows-1252 leaves five bytes unmapped (81 8D 8F 90 9D); ftfy's sloppy
# codec encodes those code points straight back to their byte values
_SLOPPY = frozenset((0x81, 0x8D, 0x8F, 0x90, 0x9D))

_LIGATURES = str.maketrans({
    "Ĳ": "IJ", "ĳ": "ij",
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st", "ﬆ": "st",
})

_QUOTES = str.maketrans({
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
})

_LINE_BREAKS = str.maketrans({
    "\r": "\n", " ": "\n", " ": "\n", "\x85": "\n",
    "\v": "\n", "\f": "\n",
})

_TERMINAL_ESCAPES = re.compile(r"\x1b\[[\x30-\x3f]*[\x20-\x2f]*[\x40-\x7e]")


def _sloppy_w1252_bytes(text: str):
    """Encode as windows-1252 with ftfy's sloppy fallback for the five
    unmapped code points; None when any char has no byte at all (real
    non-Latin text — not mojibake)."""
    out = bytearray()
    for ch in text:
        cp = ord(ch)
        if cp in _SLOPPY:
            out.append(cp)
            continue
        try:
            out += ch.encode("windows-1252")
        except UnicodeEncodeError:
            if cp < 0x100:  # latin-1 passthrough (C1 controls)
                out.append(cp)
            else:
                return None
    return bytes(out)


def _fix_encoding(text: str) -> str:
    """Undo UTF-8-read-as-cp1252 mis-decodes, iteratively (bounded: each
    round strictly shrinks the string)."""
    for _ in range(4):
        if not _MOJIBAKE.search(text):
            return text
        raw = _sloppy_w1252_bytes(text)
        if raw is None:
            return text
        try:
            fixed = raw.decode("utf-8")
        except UnicodeDecodeError:
            return text
        if fixed == text:
            return text
        text = fixed
    return text


def _fix_width(text: str) -> str:
    """Fullwidth ASCII variants (U+FF01-FF5E) -> ASCII; ideographic
    space -> space."""
    return "".join(
        " " if ch == "　"
        else chr(ord(ch) - 0xFEE0) if "！" <= ch <= "～"
        else ch
        for ch in text
    )


def fix_text(text: str) -> str:
    """The ftfy.fix_text subset above; idempotent, identity on clean
    ASCII (every suite classname/template)."""
    text = _TERMINAL_ESCAPES.sub("", text)
    text = text.translate(_LINE_BREAKS)
    # lone surrogates (broken decoders emit them) -> U+FFFD, like ftfy
    text = "".join(
        "�" if "\ud800" <= ch <= "\udfff" else ch for ch in text
    )
    text = _fix_encoding(text)
    # drop remaining C0/C1 controls except tab/newline (ftfy
    # remove_control_chars)
    text = "".join(
        ch for ch in text
        if ch in "\t\n" or unicodedata.category(ch) != "Cc"
    )
    text = text.translate(_LIGATURES).translate(_QUOTES)
    text = _fix_width(text)
    return unicodedata.normalize("NFC", text)
