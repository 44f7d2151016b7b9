"""Host-side image transforms (PIL + numpy).

The port's copy of ``ovmr_tpu/data/transforms.py``. PIL is imported inside
the functions that use it, so importing this module loads no PIL; the
resampling filters are PIL's integer codes (``Image.Resampling``). The
policy choices (``*_policy``, ``randaugment*``, ``augmix``) are the stages
of :mod:`ovmr_tpu_torch.data.autoaugment`, placed where the JAX package
places them.

Same pipeline contract as the reference transform factory
(``dassl/data/transforms/transforms.py:213-239, 244-371, 495-526``):

- train (OVMR config): random_resized_crop(scale 0.25-1.0, bicubic) ->
  random_flip -> colorjitter -> ToTensor -> normalize -> gaussian_noise;
- test: resize smaller edge to max(SIZE) (bicubic) -> center crop ->
  ToTensor -> normalize.

The test path is numerically faithful (PIL bicubic — exactly what
torchvision uses for PIL inputs); train-time augs are stochastic so
distributional equivalence is the contract. Outputs are CHW float32.

Eval batches may also ship as uint8 and be normalised on the device
(:func:`ovmr_tpu_torch.ops.preprocess.normalize_u8`).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Sequence

import numpy as np

# PIL's resampling filter codes (Image.Resampling.NEAREST/BILINEAR/BICUBIC)
NEAREST, BILINEAR, BICUBIC = 0, 2, 3
INTERP = {"bicubic": BICUBIC, "bilinear": BILINEAR, "nearest": NEAREST}

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def to_chw_float(img) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr.transpose(2, 0, 1)


def normalize(arr: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)
    return (arr - mean) / std


def resize_smaller_edge(img, size: int, interp=BICUBIC):
    # torchvision Resize(int) computes the long edge with int() TRUNCATION
    # (_compute_resized_output_size), not rounding — a one-pixel difference
    # shifts the subsequent center crop on common sizes (e.g. 320x240)
    w, h = img.size
    if w <= h:
        nw, nh = size, max(int(h * size / w), size)
    else:
        nw, nh = max(int(w * size / h), size), size
    return img.resize((nw, nh), interp)


def center_crop(img, size: Sequence[int]):
    th, tw = size
    w, h = img.size
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


def random_resized_crop(
    img,
    size: Sequence[int],
    scale=(0.08, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    interp=BICUBIC,
    rng: random.Random = random,
):
    """torchvision RandomResizedCrop algorithm: 10 tries of area/log-ratio
    sampling, else center-crop fallback."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            crop = img.crop((left, top, left + cw, top + ch))
            return crop.resize((size[1], size[0]), interp)
    # fallback: largest valid center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.crop((left, top, left + cw, top + ch)).resize((size[1], size[0]), interp)


def color_jitter(
    img,
    brightness: float,
    contrast: float,
    saturation: float,
    hue: float,
    rng: random.Random = random,
):
    from PIL import Image, ImageEnhance

    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue > 0:
        shift = rng.uniform(-hue, hue)

        def _hue(im, shift=shift):
            hsv = np.array(im.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
            return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

        ops.append(_hue)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


class Transform:
    """A composed image transform: PIL image -> CHW float32 numpy.

    Stochastic transforms accept an explicit ``rng`` (a ``random.Random``)
    so loaders can derive one per (seed, epoch, item) — thread-pool
    execution order then cannot change the augmentation stream."""

    def __init__(self, fn: Callable, description: str, stochastic: bool = False):
        self.fn = fn
        self.description = description
        self.stochastic = stochastic

    def __call__(self, img, rng: random.Random = None) -> np.ndarray:
        if self.stochastic:
            return self.fn(img, rng if rng is not None else random)
        return self.fn(img)

    def __repr__(self):
        return f"Transform({self.description})"


AVAI_CHOICES = frozenset({
    "random_flip", "random_resized_crop", "normalize", "instance_norm",
    "random_crop", "random_translation", "center_crop", "cutout",
    "imagenet_policy", "cifar10_policy", "svhn_policy", "randaugment",
    "randaugment_fixmatch", "randaugment2", "gaussian_noise", "colorjitter",
    "randomgrayscale", "gaussian_blur", "augmix",
})


def build_transform(
    cfg, is_train: bool = True, choices=None, uint8: bool = False
) -> Transform:
    if cfg.INPUT.NO_TRANSFORM:
        return None
    choices = list(choices if choices is not None else cfg.INPUT.TRANSFORMS)
    for choice in choices:  # reference transforms.py:231 asserts this
        if choice not in AVAI_CHOICES:
            raise ValueError(
                f"unknown transform choice {choice!r}; available: "
                f"{sorted(AVAI_CHOICES)}"
            )
    size = tuple(cfg.INPUT.SIZE)
    interp = INTERP[cfg.INPUT.INTERPOLATION]
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD

    if not is_train:
        if uint8:
            # geometry only; emits HWC uint8 for on-device normalization
            # (4x smaller host->device transfers, numerically identical)
            def test_u8_fn(img) -> np.ndarray:
                img = resize_smaller_edge(img, max(size), interp)
                img = center_crop(img, size)
                arr = np.asarray(img, dtype=np.uint8)
                if arr.ndim == 2:
                    arr = np.stack([arr] * 3, axis=-1)
                return arr

            return Transform(test_u8_fn, f"test resize+crop {size} (uint8)")

        def test_fn(img) -> np.ndarray:
            img = resize_smaller_edge(img, max(size), interp)
            img = center_crop(img, size)
            arr = to_chw_float(img)
            if "normalize" in choices:
                arr = normalize(arr, mean, std)
            if "instance_norm" in choices:  # reference transforms.py:495-526
                arr = instance_norm(arr)
            return arr

        return Transform(test_fn, f"test resize+crop {size}")

    rrc_scale = tuple(cfg.INPUT.RRCROP_SCALE)
    cj = (
        cfg.INPUT.COLORJITTER_B,
        cfg.INPUT.COLORJITTER_C,
        cfg.INPUT.COLORJITTER_S,
        cfg.INPUT.COLORJITTER_H,
    )
    gn_mean, gn_std = cfg.INPUT.GN_MEAN, cfg.INPUT.GN_STD

    # optional policy/augment stages (reference AVAI_CHOICES extras)
    policies = _build_policy_stages(cfg, choices)
    crop_padding = cfg.INPUT.CROP_PADDING
    cutout_n, cutout_len = cfg.INPUT.CUTOUT_N, cfg.INPUT.CUTOUT_LEN
    # INPUT.GB_K (kernel size) is intentionally unused: the PIL gaussian
    # blur is sigma-parameterized (round-3 decision) — do not close over it
    rgs_p, gb_p = cfg.INPUT.RGS_P, cfg.INPUT.GB_P

    def train_fn(img, rng) -> np.ndarray:
        from PIL import Image

        if "augmix" in choices:
            img = policies["augmix"](img, rng)
        # reference stage order (transforms.py:262-290): the initial
        # resize+crop applies whenever no crop-producing choice is active;
        # translation / crops are then independent sequential stages
        if "random_crop" not in choices and "random_resized_crop" not in choices:
            img = resize_smaller_edge(img, max(size), interp)
            img = center_crop(img, size)
        if "random_translation" in choices:
            img = random_translation(img, size, interp=interp, rng=rng)
        if "random_crop" in choices:
            img = random_crop(img, size, padding=crop_padding, rng=rng)
        if "random_resized_crop" in choices:
            img = random_resized_crop(
                img, size, scale=rrc_scale, interp=interp, rng=rng
            )
        if "random_flip" in choices and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        for key in (
            "imagenet_policy", "cifar10_policy", "svhn_policy",
            "randaugment", "randaugment_fixmatch", "randaugment2",
        ):
            if key in choices:
                img = policies[key](img, rng)
        if "colorjitter" in choices:
            img = color_jitter(img, *cj, rng=rng)
        if "randomgrayscale" in choices and rng.random() < rgs_p:
            img = img.convert("L").convert("RGB")
        if "gaussian_blur" in choices and rng.random() < gb_p:
            from PIL import ImageFilter

            # reference samples sigma ~ U(0.1, 2.0) per image
            img = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.1, 2.0)))
        arr = to_chw_float(img)
        if "cutout" in choices:
            arr = cutout(arr, n_holes=cutout_n, length=cutout_len, rng=rng)
        if "normalize" in choices:
            arr = normalize(arr, mean, std)
        if "gaussian_noise" in choices and rng.random() < 0.5:
            noise_rng = np.random.default_rng(rng.getrandbits(32))
            arr = arr + (
                noise_rng.standard_normal(arr.shape).astype(np.float32) * gn_std
                + gn_mean
            )
        if "instance_norm" in choices:
            arr = instance_norm(arr)
        return arr

    return Transform(train_fn, f"train {choices} {size}", stochastic=True)


POLICY_CHOICES = frozenset({
    "imagenet_policy", "cifar10_policy", "svhn_policy", "randaugment",
    "randaugment_fixmatch", "randaugment2", "augmix",
})


def _build_policy_stages(cfg, choices) -> dict:
    """The policy stage of each policy choice in ``choices``."""
    needed = POLICY_CHOICES & set(choices)
    if not needed:
        return {}
    from ovmr_tpu_torch.data.autoaugment import (
        AugMix,
        CIFAR10Policy,
        ImageNetPolicy,
        RandAugment,
        RandAugment2,
        RandAugmentFixMatch,
        SVHNPolicy,
    )

    builders = {
        "imagenet_policy": ImageNetPolicy,
        "cifar10_policy": CIFAR10Policy,
        "svhn_policy": SVHNPolicy,
        "randaugment": lambda: RandAugment(cfg.INPUT.RANDAUGMENT_N, cfg.INPUT.RANDAUGMENT_M),
        "randaugment_fixmatch": lambda: RandAugmentFixMatch(cfg.INPUT.RANDAUGMENT_N),
        "randaugment2": lambda: RandAugment2(cfg.INPUT.RANDAUGMENT_N),
        "augmix": AugMix,
    }
    return {key: builders[key]() for key in needed}


def random_crop(img, size, padding: int = 4, rng: random.Random = random):
    """Pad-then-random-crop (torchvision RandomCrop semantics)."""
    from PIL import ImageOps as _ImageOps

    if padding > 0:
        img = _ImageOps.expand(img, border=padding, fill=0)
    w, h = img.size
    th, tw = size
    if w < tw or h < th:  # torchvision RandomCrop raises; PIL would
        raise ValueError(  # silently zero-fill the out-of-bounds crop
            f"required crop size {(th, tw)} larger than padded input "
            f"size {(h, w)}"
        )
    if w == tw and h == th:
        return img
    left = rng.randint(0, max(w - tw, 0))
    top = rng.randint(0, max(h - th, 0))
    return img.crop((left, top, left + tw, top + th))


def random_translation(
    img, size, p: float = 0.5, interp=BILINEAR, rng: random.Random = random,
):
    """Resize to 1.125x then random-crop back (reference
    ``Random2DTranslation``, transforms.py:80-128)."""
    th, tw = size
    if rng.random() > p:
        return img.resize((tw, th), interp)
    nw, nh = int(round(tw * 1.125)), int(round(th * 1.125))
    img = img.resize((nw, nh), interp)
    left = rng.randint(0, max(nw - tw, 0))
    top = rng.randint(0, max(nh - th, 0))
    return img.crop((left, top, left + tw, top + th))


def cutout(
    arr: np.ndarray, n_holes: int = 1, length: int = 16,
    rng: random.Random = random,
) -> np.ndarray:
    """Zero square holes on a CHW float array (reference Cutout)."""
    _, h, w = arr.shape
    arr = arr.copy()
    for _ in range(n_holes):
        y = rng.randint(0, h - 1)
        x = rng.randint(0, w - 1)
        y1, y2 = np.clip([y - length // 2, y + length // 2], 0, h)
        x1, x2 = np.clip([x - length // 2, x + length // 2], 0, w)
        arr[:, y1:y2, x1:x2] = 0.0
    return arr


def instance_norm(arr: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Per-channel standardization (reference InstanceNormalization)."""
    mean_c = arr.mean(axis=(1, 2), keepdims=True)
    std_c = arr.std(axis=(1, 2), keepdims=True)
    return (arr - mean_c) / (std_c + eps)


def to_tensor_transform(cfg) -> Transform:
    """Resize-to-SIZE + tensorize(+normalize-if-configured), used for
    RETURN_IMG0 (reference DatasetWrapper ``to_tensor``,
    ``data_manager.py:288-297``)."""
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD
    do_norm = "normalize" in cfg.INPUT.TRANSFORMS
    th, tw = tuple(cfg.INPUT.SIZE)
    interp = INTERP[cfg.INPUT.INTERPOLATION]

    def fn(img) -> np.ndarray:
        arr = to_chw_float(img.resize((tw, th), interp))
        return normalize(arr, mean, std) if do_norm else arr

    return Transform(fn, "img0 to_tensor")


def resize_with_pad(img, size, interp=BICUBIC):
    """Aspect-preserving resize padded to the target frame (reference
    ResizeWithPad)."""
    from PIL import Image

    th, tw = size
    w, h = img.size
    scale = min(tw / w, th / h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    resized = img.resize((nw, nh), interp)
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas
