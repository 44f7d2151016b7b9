"""Plain float32 training augmentation from given draws.

OVMR's recipe (random-resized crop, horizontal flip, colour jitter, CLIP
normalisation, gaussian noise) applied to uint8 NHWC images from the draws
the benchmark makes: crop boxes ``x0, y0, cw, ch``, ``flip``, jitter factors
``fb, fc, fs`` and hue angle ``fh`` (radians, a rotation in the YIQ plane),
``noise_gate`` and ``noise`` (already scaled). The crop samples output pixel
``i`` at ``start + (i + 0.5) * size / out - 0.5`` (clamped to the image) with
bilinear hat weights; the jitter runs brightness, contrast (about the image's
mean grey), saturation, hue, each clamped to [0, 1].
"""

from __future__ import annotations

import torch

GRAY = (0.299, 0.587, 0.114)
RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def _hat(start, size, s, out):
    i = torch.arange(out, dtype=torch.float32, device=start.device)
    pos = (start[:, None] + (i[None] + 0.5) * size[:, None] / out - 0.5).clamp(0.0, s - 1.0)
    j = torch.arange(s, dtype=torch.float32, device=start.device)
    return (1.0 - (pos[:, :, None] - j[None, None]).abs()).clamp(0.0, 1.0)  # [B, out, S]


def augment(images_u8: torch.Tensor, d: dict, out: int, mean, std) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> float32 NHWC [B, out, out, 3]."""
    b, s = images_u8.shape[:2]
    dev = images_u8.device
    wy = _hat(d["y0"], d["ch"], s, out)
    wx = _hat(d["x0"], d["cw"], s, out)
    wx = torch.where(d["flip"][:, None, None], wx.flip(1), wx)
    x = torch.einsum("bih,bhwc,bjw->bijc", wy, images_u8.float(), wx) / 255.0
    gray = torch.tensor(GRAY, device=dev)
    x = (x * d["fb"].reshape(-1, 1, 1, 1)).clamp(0, 1)
    m = (x * gray).sum(-1, keepdim=True).mean(dim=(1, 2), keepdim=True)
    x = ((x - m) * d["fc"].reshape(-1, 1, 1, 1) + m).clamp(0, 1)
    g = (x * gray).sum(-1, keepdim=True)
    x = ((x - g) * d["fs"].reshape(-1, 1, 1, 1) + g).clamp(0, 1)
    if d.get("fh") is not None:
        yiq = x @ torch.tensor(RGB2YIQ, device=dev).T
        c, sn = torch.cos(d["fh"]).reshape(-1, 1, 1), torch.sin(d["fh"]).reshape(-1, 1, 1)
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], i * c - q * sn, i * sn + q * c], dim=-1)
        x = (yiq @ torch.tensor(YIQ2RGB, device=dev).T).clamp(0, 1)
    x = (x - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)
    if d.get("noise") is not None:
        x = x + torch.where(d["noise_gate"].reshape(-1, 1, 1, 1), d["noise"], 0.0)
    return x
