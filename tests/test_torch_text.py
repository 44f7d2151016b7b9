"""The port's tokenizer runs on the standard library alone and gives the
reference ids: the recorded golden and ``ovmr_tpu.text.tokenize``.

The port's tokenizer is exercised in a child interpreter where
``import regex`` and ``import ftfy`` fail (``sys.modules[...] = None``),
as on a machine that has neither; the JAX package's ids are computed
here, where ``regex`` is installed.
"""

import json
import os
import subprocess
import sys

import numpy as np

import ovmr_tpu.text.fix_text as j_fix_text
from ovmr_tpu.text import tokenize as j_tokenize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tokenizer_golden.json")

# class names and prompts with non-ASCII text, mojibake, ligatures, full
# width forms, curly quotes, odd whitespace and the U+0345 case-fold quirk
TEXTS = [
    "a photo of a crème brûlée.", "Straße sign", "東京 tower", "sÃ©ance", "ﬁsh ﬂakes",
    "ＡＢＣ １２３", "it’s “quoted”", "tab\there line　wide", "Ⅻ roman ²",
    "aͅb {ͅǏ", "l'Ådd'LL o'Neil 'ſ", "naïve café", "Ελληνικά λέξη", "русский текст",
    "हिन्दी शब्द", "emoji 🌿🎢 mix", "<|startoftext|> x <|endoftext|>", "", "a .",
]

_CHILD = r"""
import json, sys
sys.modules["regex"] = None
sys.modules["ftfy"] = None
sys.path.insert(0, sys.argv[1])
from ovmr_tpu_torch.text import get_tokenizer, tokenize
from ovmr_tpu_torch.text.fix_text import fix_text
texts, golden = json.loads(sys.stdin.read())
tok = get_tokenizer()
print(json.dumps({
    "tokenize": tokenize(texts).tolist(),
    "golden": {t: tok.encode(t) for t in golden},
    "fix_text": [fix_text(t) for t in texts],
    "vocab": [tok.vocab_size, tok.sot_token, tok.eot_token],
}))
"""


def _child(texts, golden):
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, ROOT], input=json.dumps([texts, list(golden)]),
        capture_output=True, text=True, check=True, timeout=120,
    )
    return json.loads(proc.stdout)


def test_tokenizer_without_regex_or_ftfy_matches_reference():
    with open(FIXTURE) as f:
        golden = json.load(f)
    out = _child(TEXTS, golden)
    assert out["vocab"] == [49408, 49406, 49407]
    for text, ids in golden.items():
        assert out["golden"][text] == ids, text
    np.testing.assert_array_equal(np.array(out["tokenize"], np.int32), j_tokenize(TEXTS))
    assert out["fix_text"] == [j_fix_text.fix_text(t) for t in TEXTS]


def test_random_unicode_matches_jax_tokenizer():
    rng = np.random.RandomState(0)
    blocks = [(0x20, 0x7F), (0xA0, 0x250), (0x300, 0x500), (0x600, 0x700), (0x900, 0x980),
              (0x2000, 0x2070), (0x2150, 0x2190), (0x3000, 0x3100), (0x4E00, 0x4E80),
              (0xFF00, 0xFF60), (0x1F300, 0x1F400), (0x0, 0x20)]
    texts = []
    for _ in range(400):
        lo, hi = blocks[rng.randint(len(blocks))]
        n = rng.randint(1, 10)
        texts.append("".join(chr(rng.randint(lo, hi)) for _ in range(n)))
    out = _child(texts, {})
    np.testing.assert_array_equal(
        np.array(out["tokenize"], np.int32), j_tokenize(texts, truncate=True)
    )
