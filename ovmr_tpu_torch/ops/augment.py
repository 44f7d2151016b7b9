"""Training augmentation on the device.

The port's copy of ``ovmr_tpu/ops/augment.py``: the host streams cached
uint8 images (the decode-once cache, :mod:`ovmr_tpu_torch.data.cache`) and
the card runs the whole OVMR augmentation recipe inside the training step:
random-resized crop, horizontal flip, colour jitter, CLIP normalisation and
gaussian noise. That takes PIL decode and five transforms a step off the
host's 8 cores.

The JAX function draws and applies in one jitted program; here the two are
split, so that a test can hand the JAX package's draws to the port:
:func:`sample_augment_draws` makes every random number of a batch from one
``torch.Generator`` on the images' device, and :func:`augment_batch`
applies them and draws nothing. Torch and JAX random streams cannot match,
so the two agree only with the draws injected.

Semantics are distributionally those of torchvision (same parameter ranges,
bilinear resampling); hue is a rotation in the YIQ plane in place of an HSV
round trip, and the jitter runs in a fixed order (brightness, contrast,
saturation, hue), as the JAX package chose.

No kernel of this repository runs here: the JAX package computes all of
this in XLA, outside any Pallas kernel, so the crop's two interpolation
products stay batched ``torch`` products and the rest plain elementwise
torch.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
RATIO = (3.0 / 4.0, 4.0 / 3.0)
TRIES = 10

_GRAY = (0.299, 0.587, 0.114)
_RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
_YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as a true division on every device: on a CUDA
    tensor, dividing by a Python (or 0-d CPU) scalar multiplies by its
    reciprocal, one rounding more, which can tip an interpolation weight to
    the neighbouring bf16 value and move a pixel by a grey level."""
    return x / torch.full((1,), d, dtype=x.dtype, device=x.device)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map U[0, 1) draws onto [lo, hi) as ``jax.random.uniform`` does:
    ``max(lo, u * (hi - lo) + lo)`` in fp32."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def _crop_boxes(u_area, u_ratio, u_x, u_y, in_size: int, scale, ratio=RATIO):
    """torchvision-style random-resized-crop boxes from U[0, 1) draws
    (``_sample_crop_boxes`` :28-55): ``u_area``/``u_ratio`` [B, tries] are
    the candidate areas and log-ratios, the first valid try per image wins
    (the full frame when none is), ``u_x``/``u_y`` [B] place the box.
    Returns fp32 ``x0, y0, cw, ch`` [B]."""
    area = float(in_size * in_size)
    target_area = area * _uniform(u_area, scale[0], scale[1])
    log_lo = torch.log(torch.tensor(ratio[0], dtype=torch.float32))
    log_hi = torch.log(torch.tensor(ratio[1], dtype=torch.float32))
    aspect = torch.exp(_uniform(u_ratio, float(log_lo), float(log_hi)))
    cw = torch.sqrt(target_area * aspect)
    ch = torch.sqrt(target_area / aspect)
    valid = (cw <= in_size) & (ch <= in_size)
    # torch.argmax refuses bool; on uint8 it returns the first maximum, as
    # jnp.argmax does on bool
    pick = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    full = torch.full_like(cw[:, 0], float(in_size))
    cw = torch.where(any_valid, cw.gather(1, pick)[:, 0], full)
    ch = torch.where(any_valid, ch.gather(1, pick)[:, 0], full)
    x0 = u_x * (in_size - cw)
    y0 = u_y * (in_size - ch)
    return x0, y0, cw, ch


def _sample_crop_boxes(generator: torch.Generator, batch: int, in_size: int, scale,
                       ratio=RATIO):
    """Draw the crop boxes of a batch (:func:`_crop_boxes`) from
    ``generator``, on its device."""
    dev = generator.device
    u_area, u_ratio = (torch.rand((batch, TRIES), generator=generator, device=dev)
                       for _ in range(2))
    u_x, u_y = (torch.rand((batch,), generator=generator, device=dev) for _ in range(2))
    return _crop_boxes(u_area, u_ratio, u_x, u_y, in_size, scale, ratio)


def _bilinear_crop(images, x0, y0, cw, ch, out_size: int) -> torch.Tensor:
    """Per-image crop boxes -> fp32 [B, out, out, C] by a four-corner
    bilinear gather (``_bilinear_crop`` :58-105); uint8 input is converted
    after the gather. The step uses :func:`_matmul_crop`; this is its
    reference."""
    b, s, _, c = images.shape
    dev = images.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    # pixel-centre mapping: output pixel i samples y0 + (i + 0.5) * ch / out - 0.5
    ys = (y0[:, None] + (i[None, :] + 0.5) * _div(ch[:, None], out_size) - 0.5).clamp(0.0, s - 1.0)
    xs = (x0[:, None] + (i[None, :] + 0.5) * _div(cw[:, None], out_size) - 0.5).clamp(0.0, s - 1.0)
    y0i, x0i = ys.floor().long(), xs.floor().long()
    y1i, x1i = (y0i + 1).clamp(max=s - 1), (x0i + 1).clamp(max=s - 1)
    wy = (ys - y0i.float())[:, :, None, None]
    wx = (xs - x0i.float())[:, None, :, None]

    def rows(yi):  # [B, out, S, C]
        return images.gather(1, yi[:, :, None, None].expand(b, out_size, s, c))

    def cols(r, xi):  # [B, out, out, C] fp32
        return r.gather(2, xi[:, None, :, None].expand(b, out_size, out_size, c)).float()

    top, bot = rows(y0i), rows(y1i)
    tl, tr, bl, br = cols(top, x0i), cols(top, x1i), cols(bot, x0i), cols(bot, x1i)
    return (tl * (1 - wy) * (1 - wx) + tr * (1 - wy) * wx
            + bl * wy * (1 - wx) + br * wy * wx)


def _interp_weights(starts, sizes, in_size: int, out_size: int) -> torch.Tensor:
    """Bilinear interpolation matrices [B, out, in] (``_interp_weights``
    :108-117): row i holds the two-neighbour hat weights of output sample i
    of a (start, size) crop, those of :func:`_bilinear_crop` as a dense
    matrix."""
    dev = starts.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    pos = starts[:, None] + (i[None, :] + 0.5) * _div(sizes[:, None], out_size) - 0.5
    pos = pos.clamp(0.0, in_size - 1.0)
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    return (1.0 - (pos[:, :, None] - j[None, None, :]).abs()).clamp(0.0, 1.0)


def _matmul_crop(images, x0, y0, cw, ch, out_size: int, flip=None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Crop and bilinear resize as two batched products, rows then columns
    (``_matmul_crop`` :120-144); returns fp32 [B, out, out, C].

    ``flip`` [B] bool folds the horizontal flip into the column weights
    (it reverses the output rows of ``wx``). With ``dtype`` bf16 the
    weights and the row product's result are rounded to bf16, as the JAX
    function's operands are; both products then run on fp32 operands that
    hold those values, which fp32 (and TF32) represent exactly, so every
    sum accumulates in fp32 as ``preferred_element_type=f32`` does. The
    second product comes back in fp32."""
    b, s, _, c = images.shape

    def rounded(t):
        return t.to(dtype).float()

    wy = rounded(_interp_weights(y0, ch, s, out_size))  # [B, out, S]
    wx = _interp_weights(x0, cw, s, out_size)
    if flip is not None:
        wx = torch.where(flip[:, None, None], wx.flip(1), wx)
    wx = rounded(wx)
    # rows: [B, out, S] @ [B, S, S * C] -> t [B, out_h, S_w, C], rounded
    t = rounded(torch.bmm(wy, images.float().reshape(b, s, s * c)))
    # columns: [B, out_w, S_w] @ [B, S_w, out_h * C] -> [B, out_w, out_h, C]
    t = t.reshape(b, out_size, s, c).transpose(1, 2).reshape(b, s, out_size * c)
    out = torch.bmm(wx, t).reshape(b, out_size, out_size, c)
    return out.transpose(1, 2).contiguous()


def _color_jitter(x, fb, fc, fs, fh=None) -> torch.Tensor:
    """Brightness, contrast, saturation, then (``fh`` not None) hue as a
    YIQ rotation by ``fh`` radians, in that fixed order (``_color_jitter``
    :147-190). ``x`` in [0, 1], [B, H, W, 3] fp32; factors [B]."""
    dev = x.device
    fb, fc, fs = (f.reshape(-1, 1, 1, 1) for f in (fb, fc, fs))
    gray_w = torch.tensor(_GRAY, dtype=x.dtype, device=dev)
    x = (x * fb).clamp(0.0, 1.0)
    mean_gray = (x * gray_w).sum(-1, keepdim=True).mean(dim=(1, 2), keepdim=True)
    x = ((x - mean_gray) * fc + mean_gray).clamp(0.0, 1.0)
    gray = (x * gray_w).sum(-1, keepdim=True)
    x = ((x - gray) * fs + gray).clamp(0.0, 1.0)
    if fh is not None:
        rgb2yiq = torch.tensor(_RGB2YIQ, dtype=x.dtype, device=dev)
        yiq2rgb = torch.tensor(_YIQ2RGB, dtype=x.dtype, device=dev)
        yiq = x @ rgb2yiq.T
        cos_h = torch.cos(fh).reshape(-1, 1, 1, 1)
        sin_h = torch.sin(fh).reshape(-1, 1, 1, 1)
        i = yiq[..., 1:2] * cos_h - yiq[..., 2:3] * sin_h
        q = yiq[..., 1:2] * sin_h + yiq[..., 2:3] * cos_h
        yiq = torch.cat([yiq[..., :1], i, q], dim=-1)
        x = (yiq @ yiq2rgb.T).clamp(0.0, 1.0)
    return x


def sample_augment_draws(
    generator: torch.Generator,
    b: int,
    s: int,
    out_size: int = 224,
    scale: Tuple[float, float] = (0.25, 1.0),
    jitter: Tuple[float, float, float, float] = (0.4, 0.4, 0.4, 0.1),
    gn_std: float = 0.15,
) -> dict:
    """Every random number :func:`augment_batch` needs for ``b`` images of
    ``s x s``, from ``generator`` on its device (``augment_batch``'s draws,
    :213-233): the crop boxes ``x0, y0, cw, ch`` [B], ``flip`` [B] bool, the
    jitter factors ``fb, fc, fs`` [B] and the hue angle ``fh`` [B] in
    radians (None when the hue range is 0), the noise gate ``noise_gate``
    [B] bool and ``noise`` [B, out, out, 3], already scaled by ``gn_std``
    (both None when ``gn_std`` is 0)."""
    dev = generator.device
    bri, con, sat, hue = jitter
    x0, y0, cw, ch = _sample_crop_boxes(generator, b, s, scale)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    draws = dict(x0=x0, y0=y0, cw=cw, ch=ch, flip=rand(b) < 0.5,
                 fb=_uniform(rand(b), max(0.0, 1 - bri), 1 + bri),
                 fc=_uniform(rand(b), max(0.0, 1 - con), 1 + con),
                 fs=_uniform(rand(b), max(0.0, 1 - sat), 1 + sat),
                 fh=_uniform(rand(b), -hue, hue) * (2 * math.pi) if hue > 0 else None,
                 noise_gate=None, noise=None)
    if gn_std > 0:
        draws["noise_gate"] = rand(b) < 0.5
        draws["noise"] = torch.randn((b, out_size, out_size, 3), generator=generator,
                                     device=dev) * gn_std
    return draws


def augment_batch(
    images_u8: torch.Tensor,
    draws: dict,
    out_size: int = 224,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
    out_dtype=torch.bfloat16,
    out_layout: str = "NCHW",
) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> augmented, normalised [B, 3, out, out] (NCHW)
    or [B, out, out, 3] (NHWC, which the NHWC patch embedding takes as it
    is), by the draws of :func:`sample_augment_draws` (``augment_batch``
    :193-235). Runs on the images' device and draws nothing."""
    if out_layout not in ("NCHW", "NHWC"):
        raise ValueError(f"out_layout {out_layout!r}: expected NCHW or NHWC")
    d = draws
    x = _div(_matmul_crop(images_u8, d["x0"], d["y0"], d["cw"], d["ch"], out_size,
                          flip=d["flip"]), 255.0)
    x = _color_jitter(x, d["fb"], d["fc"], d["fs"], d["fh"])
    dev = x.device
    x = (x - torch.tensor(mean, dtype=torch.float32, device=dev)) / torch.tensor(
        std, dtype=torch.float32, device=dev)
    if d["noise"] is not None:
        x = x + torch.where(d["noise_gate"].reshape(-1, 1, 1, 1), d["noise"], 0.0)
    if out_layout == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x.to(out_dtype)

