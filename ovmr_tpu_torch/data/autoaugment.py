"""AutoAugment policies and RandAugment.

The port's copy of ``ovmr_tpu/data/autoaugment.py``: the public AutoAugment
recipe (Cubuk et al., 2019; the published best sub-policies, as the
reference vendors them at ``dassl/data/transforms/autoaugment.py``),
RandAugment (Cubuk et al., 2020) and an AugMix-style mixer, behind the
transform choices imagenet_policy / cifar10_policy / svhn_policy /
randaugment / randaugment_fixmatch / randaugment2 / augmix. The same image
and the same ``random.Random`` give the JAX package's bytes. PIL is
imported inside the functions, so importing this module loads no PIL.

Ops accept an explicit ``random.Random`` for seed-stable threaded loading.
"""

from __future__ import annotations

import random as _random

import numpy as np

FILL = (128, 128, 128)


# --------------------------------------------------------------------------
# primitive ops: (PIL image, magnitude in [0, 1]-scaled op units) -> image
# --------------------------------------------------------------------------

# PIL's Image.AFFINE and Image.FLIP_LEFT_RIGHT
_AFFINE, _FLIP_LEFT_RIGHT = 0, 0


def _affine(img, coeffs):
    return img.transform(img.size, _AFFINE, coeffs, fillcolor=FILL)


def _shear_x(img, v):
    return _affine(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    return _affine(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, v):
    return _affine(img, (1, 0, v * img.size[0], 0, 1, 0))


def _translate_y(img, v):
    return _affine(img, (1, 0, 0, 0, 1, v * img.size[1]))


def _rotate(img, v):
    from PIL import Image

    rot = img.convert("RGBA").rotate(v)
    bg = Image.new("RGBA", rot.size, FILL + (255,))
    return Image.alpha_composite(bg, rot).convert("RGB")


def _ops(name):
    from PIL import ImageOps

    return getattr(ImageOps, name)


def _enhance(name, img, v):
    from PIL import ImageEnhance

    return getattr(ImageEnhance, name)(img).enhance(v)


def _cutout_frac(img, v, rng=_random):
    if v <= 0.0:
        return img
    w, h = img.size
    size = int(v * w)
    x0 = rng.randint(0, max(w - size, 0))
    y0 = rng.randint(0, max(h - size, 0))
    img = img.copy()
    img.paste(FILL, (x0, y0, x0 + size, y0 + size))
    return img


OPS = {
    "shearX": lambda img, v, rng: _shear_x(img, v),
    "shearY": lambda img, v, rng: _shear_y(img, v),
    "translateX": lambda img, v, rng: _translate_x(img, v),
    "translateY": lambda img, v, rng: _translate_y(img, v),
    "rotate": lambda img, v, rng: _rotate(img, v),
    "autocontrast": lambda img, v, rng: _ops("autocontrast")(img),
    "invert": lambda img, v, rng: _ops("invert")(img),
    "equalize": lambda img, v, rng: _ops("equalize")(img),
    "solarize": lambda img, v, rng: _ops("solarize")(img, int(v)),
    "posterize": lambda img, v, rng: _ops("posterize")(img, max(int(v), 1)),
    "contrast": lambda img, v, rng: _enhance("Contrast", img, v),
    "color": lambda img, v, rng: _enhance("Color", img, v),
    "brightness": lambda img, v, rng: _enhance("Brightness", img, v),
    "sharpness": lambda img, v, rng: _enhance("Sharpness", img, v),
    "cutout": _cutout_frac,
    "flip": lambda img, v, rng: img.transpose(_FLIP_LEFT_RIGHT),
    "identity": lambda img, v, rng: img,
}

# magnitude bins (10 levels), AutoAugment convention
_RANGES = {
    "shearX": np.linspace(0, 0.3, 10),
    "shearY": np.linspace(0, 0.3, 10),
    "translateX": np.linspace(0, 150 / 331, 10),
    "translateY": np.linspace(0, 150 / 331, 10),
    "rotate": np.linspace(0, 30, 10),
    "color": np.linspace(0.0, 0.9, 10),
    "posterize": np.round(np.linspace(8, 4, 10), 0).astype(int),
    "solarize": np.linspace(256, 0, 10),
    "contrast": np.linspace(0.0, 0.9, 10),
    "sharpness": np.linspace(0.0, 0.9, 10),
    "brightness": np.linspace(0.0, 0.9, 10),
    "autocontrast": np.zeros(10),
    "equalize": np.zeros(10),
    "invert": np.zeros(10),
    "cutout": np.linspace(0, 0.2, 10),
}

# enhancement ops are centered at 1.0 with a random sign in AutoAugment
_ENHANCE = {"color", "contrast", "sharpness", "brightness"}
_SIGNED = {"shearX", "shearY", "translateX", "translateY", "rotate"}


def _apply(img, op, magnitude_idx, rng):
    if op == "identity":
        return img
    v = float(_RANGES[op][magnitude_idx])
    if op in _ENHANCE:
        v = 1.0 + (v if rng.random() < 0.5 else -v)
    elif op in _SIGNED and rng.random() < 0.5:
        v = -v
    return OPS[op](img, v, rng)


class _SubPolicy:
    def __init__(self, p1, op1, m1, p2, op2, m2):
        self.steps = ((p1, op1, m1), (p2, op2, m2))

    def __call__(self, img, rng=_random):
        for p, op, m in self.steps:
            if rng.random() < p:
                img = _apply(img, op, m, rng)
        return img


class _AutoAugmentBase:
    TABLE = ()

    def __init__(self):
        self.policies = [_SubPolicy(*row) for row in type(self).TABLE]

    def __call__(self, img, rng=_random):
        return self.policies[rng.randint(0, len(self.policies) - 1)](img, rng)


class ImageNetPolicy(_AutoAugmentBase):
    """Published best sub-policies for ImageNet."""

    TABLE = (
        (0.4, "posterize", 8, 0.6, "rotate", 9),
        (0.6, "solarize", 5, 0.6, "autocontrast", 5),
        (0.8, "equalize", 8, 0.6, "equalize", 3),
        (0.6, "posterize", 7, 0.6, "posterize", 6),
        (0.4, "equalize", 7, 0.2, "solarize", 4),
        (0.4, "equalize", 4, 0.8, "rotate", 8),
        (0.6, "solarize", 3, 0.6, "equalize", 7),
        (0.8, "posterize", 5, 1.0, "equalize", 2),
        (0.2, "rotate", 3, 0.6, "solarize", 8),
        (0.6, "equalize", 8, 0.4, "posterize", 6),
        (0.8, "rotate", 8, 0.4, "color", 0),
        (0.4, "rotate", 9, 0.6, "equalize", 2),
        (0.0, "equalize", 7, 0.8, "equalize", 8),
        (0.6, "invert", 4, 1.0, "equalize", 8),
        (0.6, "color", 4, 1.0, "contrast", 8),
        (0.8, "rotate", 8, 1.0, "color", 2),
        (0.8, "color", 8, 0.8, "solarize", 7),
        (0.4, "sharpness", 7, 0.6, "invert", 8),
        (0.6, "shearX", 5, 1.0, "equalize", 9),
        (0.4, "color", 0, 0.6, "equalize", 3),
        (0.4, "equalize", 7, 0.2, "solarize", 4),
        (0.6, "solarize", 5, 0.6, "autocontrast", 5),
        (0.6, "invert", 4, 1.0, "equalize", 8),
        (0.6, "color", 4, 1.0, "contrast", 8),
        (0.8, "equalize", 8, 0.6, "equalize", 3),
    )


class CIFAR10Policy(_AutoAugmentBase):
    """Published best sub-policies for CIFAR10."""

    TABLE = (
        (0.1, "invert", 7, 0.2, "contrast", 6),
        (0.7, "rotate", 2, 0.3, "translateX", 9),
        (0.8, "sharpness", 1, 0.9, "sharpness", 3),
        (0.5, "shearY", 8, 0.7, "translateY", 9),
        (0.5, "autocontrast", 8, 0.9, "equalize", 2),
        (0.2, "shearY", 7, 0.3, "posterize", 7),
        (0.4, "color", 3, 0.6, "brightness", 7),
        (0.3, "sharpness", 9, 0.7, "brightness", 9),
        (0.6, "equalize", 5, 0.5, "equalize", 1),
        (0.6, "contrast", 7, 0.6, "sharpness", 5),
        (0.7, "color", 7, 0.5, "translateX", 8),
        (0.3, "equalize", 7, 0.4, "autocontrast", 8),
        (0.4, "translateY", 3, 0.2, "sharpness", 6),
        (0.9, "brightness", 6, 0.2, "color", 8),
        (0.5, "solarize", 2, 0.0, "invert", 3),
        (0.2, "equalize", 0, 0.6, "autocontrast", 0),
        (0.2, "equalize", 8, 0.6, "equalize", 4),
        (0.9, "color", 9, 0.6, "equalize", 6),
        (0.8, "autocontrast", 4, 0.2, "solarize", 8),
        (0.1, "brightness", 3, 0.7, "color", 0),
        (0.4, "solarize", 5, 0.9, "autocontrast", 3),
        (0.9, "translateY", 9, 0.7, "translateY", 9),
        (0.9, "autocontrast", 2, 0.8, "solarize", 3),
        (0.8, "equalize", 8, 0.1, "invert", 3),
        (0.7, "translateY", 9, 0.9, "autocontrast", 1),
    )


class SVHNPolicy(_AutoAugmentBase):
    """Published best sub-policies for SVHN."""

    TABLE = (
        (0.9, "shearX", 4, 0.2, "invert", 3),
        (0.9, "shearY", 8, 0.7, "invert", 5),
        (0.6, "equalize", 5, 0.6, "solarize", 6),
        (0.9, "invert", 3, 0.6, "equalize", 3),
        (0.6, "equalize", 1, 0.9, "rotate", 3),
        (0.9, "shearX", 4, 0.8, "autocontrast", 3),
        (0.9, "shearY", 8, 0.4, "invert", 5),
        (0.9, "shearY", 5, 0.2, "solarize", 6),
        (0.9, "invert", 6, 0.8, "autocontrast", 1),
        (0.6, "equalize", 3, 0.9, "rotate", 3),
        (0.9, "shearX", 4, 0.3, "solarize", 3),
        (0.8, "shearY", 8, 0.7, "invert", 4),
        (0.9, "equalize", 5, 0.6, "translateY", 6),
        (0.9, "invert", 4, 0.6, "equalize", 7),
        (0.3, "contrast", 3, 0.8, "rotate", 4),
        (0.8, "invert", 5, 0.0, "translateY", 2),
        (0.7, "shearY", 6, 0.4, "solarize", 8),
        (0.6, "invert", 4, 0.8, "rotate", 4),
        (0.3, "shearY", 7, 0.9, "translateX", 3),
        (0.1, "shearX", 6, 0.6, "invert", 5),
        (0.7, "solarize", 2, 0.6, "translateY", 7),
        (0.8, "shearY", 4, 0.8, "invert", 8),
        (0.7, "shearX", 9, 0.8, "translateY", 3),
        (0.8, "shearY", 5, 0.7, "autocontrast", 3),
        (0.7, "shearX", 2, 0.1, "invert", 5),
    )


# --------------------------------------------------------------------------
# RandAugment family: continuous (min, max) op ranges, magnitude-scaled
# like the reference (``dassl/data/transforms/randaugment.py:312-363``)
# --------------------------------------------------------------------------

RANDAUGMENT_LIST = [
    ("autocontrast", 0.0, 1.0),
    ("equalize", 0.0, 1.0),
    ("invert", 0.0, 1.0),
    ("rotate", 0.0, 30.0),
    ("posterize", 4.0, 8.0),
    ("solarize", 0.0, 256.0),
    ("color", 0.1, 1.9),
    ("contrast", 0.1, 1.9),
    ("brightness", 0.1, 1.9),
    ("sharpness", 0.1, 1.9),
    ("shearX", 0.0, 0.3),
    ("shearY", 0.0, 0.3),
    ("translateX", 0.0, 0.33),
    ("translateY", 0.0, 0.33),
]

# fixmatch/randaugment2 variants draw over symmetric geometric ranges
FIXMATCH_LIST = [
    ("autocontrast", 0.0, 1.0),
    ("brightness", 0.05, 0.95),
    ("color", 0.05, 0.95),
    ("contrast", 0.05, 0.95),
    ("equalize", 0.0, 1.0),
    ("identity", 0.0, 1.0),
    ("posterize", 4.0, 8.0),
    ("rotate", -30.0, 30.0),
    ("sharpness", 0.05, 0.95),
    ("shearX", -0.3, 0.3),
    ("shearY", -0.3, 0.3),
    ("solarize", 0.0, 256.0),
    ("translateX", -0.3, 0.3),
    ("translateY", -0.3, 0.3),
]


def _apply_val(img, op, v, rng):
    if op == "identity":
        return img
    return OPS[op](img, v, rng)


class RandAugment:
    """N ops at magnitude m of 30: val = (m/30)*(max-min)+min
    (reference ``RandAugment``)."""

    def __init__(self, n: int = 2, m: int = 10):
        assert 0 <= m <= 30
        self.n = n
        self.m = m

    def __call__(self, img, rng=_random):
        for _ in range(self.n):
            op, lo, hi = rng.choice(RANDAUGMENT_LIST)
            img = _apply_val(img, op, (self.m / 30) * (hi - lo) + lo, rng)
        return img


class RandAugment2:
    """N ops, each applied with probability p at a uniform magnitude
    (reference ``RandAugment2``)."""

    def __init__(self, n: int = 2, p: float = 0.6):
        self.n = n
        self.p = p

    def __call__(self, img, rng=_random):
        for _ in range(self.n):
            if rng.random() > self.p:
                continue
            op, lo, hi = rng.choice(FIXMATCH_LIST)
            img = _apply_val(img, op, rng.random() * (hi - lo) + lo, rng)
        return img


class RandAugmentFixMatch:
    """FixMatch strong branch: N ops at uniform random magnitude
    (reference ``RandAugmentFixMatch``; no extra cutout)."""

    def __init__(self, n: int = 2):
        self.n = n

    def __call__(self, img, rng=_random):
        for _ in range(self.n):
            op, lo, hi = rng.choice(FIXMATCH_LIST)
            img = _apply_val(img, op, rng.random() * (hi - lo) + lo, rng)
        return img


class AugMix:
    """AugMix (Hendrycks et al., 2020): mix k augmentation chains with
    Dirichlet weights, then blend with the original image."""

    def __init__(self, severity: int = 3, width: int = 3, depth: int = -1, alpha: float = 1.0):
        self.severity = min(max(severity, 1), 10)
        self.width = width
        self.depth = depth
        self.alpha = alpha

    def __call__(self, img, rng=_random):
        np_rng = np.random.default_rng(rng.getrandbits(32))
        ws = np_rng.dirichlet([self.alpha] * self.width).astype(np.float32)
        m = float(np_rng.beta(self.alpha, self.alpha))
        base = np.asarray(img, np.float32)
        mix = np.zeros_like(base)
        frac = self.severity / 10.0
        for i in range(self.width):
            chain = img.copy()
            depth = self.depth if self.depth > 0 else rng.randint(1, 3)
            for _ in range(depth):
                op, lo, hi = rng.choice(RANDAUGMENT_LIST)
                chain = _apply_val(chain, op, frac * (hi - lo) + lo, rng)
            mix += ws[i] * np.asarray(chain, np.float32)
        blended = (1 - m) * base + m * mix
        from PIL import Image

        return Image.fromarray(np.clip(blended, 0, 255).astype(np.uint8))
