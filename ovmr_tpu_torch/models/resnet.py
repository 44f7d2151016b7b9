"""ModifiedResNet CLIP image tower (RN50 / RN101 / RN50xN backbones).

Counterpart of ``ovmr_tpu/models/resnet.py`` (reference
``clip/model.py:10-150``), as functions over the JAX package's parameter
tree (``visual = {"stem", "stages": [[block, ...], ...], "attnpool"}``):

- a 3-convolution stem with BatchNorm (inference statistics: these towers
  are always frozen) and a trailing 2x2 average pool;
- anti-aliased strided Bottlenecks: a stride-2 stage pools, then convolves;
- the final pooling is attention over the spatial tokens with a prepended
  mean token (``AttentionPool2d``, separate q/k/v/c projections stored
  ``[in, out]``), token 0 the only query.

Layout: NCHW activations, OIHW kernels, as in the torch checkpoints. The
convolutions are ``F.conv2d`` and the pool's products ``torch.matmul``:
the JAX package computes them in XLA, outside any Pallas kernel, so they
have no hand-written kernel here either. A float32 tower runs its
convolutions with cuDNN's TF32 switched off for the tower's duration
(cuDNN's default would keep about three decimal digits); bf16/fp16
convolutions accumulate in fp32 and round once, as the JAX package's
``preferred_element_type=float32`` then cast does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ovmr_tpu_torch.ops.layers import dense, matmul_f32


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Convolution in x's dtype with fp32 accumulation, rounded once."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def batch_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm in fp32, cast back (``resnet.py:35-42``,
    the same order of operations)."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(p["var"].float() + eps)
    out = (x.float() - p["mean"].float().view(shape)) * (inv * p["scale"].float()).view(shape)
    return (out + p["bias"].float().view(shape)).to(x.dtype)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Window sums in fp32, cast to x's dtype, then divided there
    (``resnet.py:45-53``): the same rounding as the JAX package, not
    ``F.avg_pool2d``'s on a bf16 tensor."""
    sums = F.avg_pool2d(x.float(), window, stride=window, divisor_override=1)
    return sums.to(x.dtype) / (window * window)


def bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    out = torch.relu(batch_norm(conv2d(x, p["conv1_w"]), p["bn1"]))
    out = torch.relu(batch_norm(conv2d(out, p["conv2_w"], padding=1), p["bn2"]))
    if stride > 1:
        out = avg_pool(out, stride)
    out = batch_norm(conv2d(out, p["conv3_w"]), p["bn3"])
    identity = x
    if "down_conv_w" in p:
        if stride > 1:
            identity = avg_pool(identity, stride)
        identity = batch_norm(conv2d(identity, p["down_conv_w"]), p["down_bn"])
    return torch.relu(out + identity)


def attention_pool(x: torch.Tensor, p: dict, n_head: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, output_dim] (reference ``AttentionPool2d``).

    A feature map whose grid is not the trained square one (a different
    shape, even of equal area) bilinear-resizes the positional table to
    its grid, as the ViT towers do; identity at the native size."""
    from ovmr_tpu_torch.models.clip import resize_pos_embed

    b, c, h, w = x.shape
    dtype = x.dtype
    tokens = x.reshape(b, c, h * w).transpose(1, 2)  # [B, HW, C]
    tokens = torch.cat([tokens.float().mean(dim=1, keepdim=True).to(dtype), tokens], dim=1)
    pe = p["positional_embedding"]
    grid = round((pe.shape[0] - 1) ** 0.5)
    # guard on the grid's shape, not its area: a 4x1 map against a trained
    # 2x2 must resize too
    if (h, w) != (grid, grid):
        pe = resize_pos_embed(pe, grid, h, w)
    tokens = tokens + pe.to(dtype)[None]

    # only the mean token's output is used: it is the only query
    q = dense(tokens[:, :1], p["q_w"], p["q_b"])  # [B, 1, C]
    k = dense(tokens, p["k_w"], p["k_b"])
    v = dense(tokens, p["v_w"], p["v_b"])
    length, dh = tokens.shape[1], c // n_head
    qh = q.reshape(b, 1, n_head, dh).transpose(1, 2)
    kh = k.reshape(b, length, n_head, dh).transpose(1, 2)
    vh = v.reshape(b, length, n_head, dh).transpose(1, 2)
    scores = matmul_f32(qh * dh ** -0.5, kh.transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = matmul_f32(probs, vh).to(dtype).transpose(1, 2).reshape(b, c)
    return dense(out, p["c_w"], p["c_b"])


@contextlib.contextmanager
def exact_fp32_convolutions(dtype: torch.dtype = torch.float32):
    """cuDNN's TF32 off for float32 work (a tower, a Dassl step), for this
    block only; every other flag keeps its current value."""
    if dtype != torch.float32:
        yield
        return
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def encode_image_resnet(params: dict, images: torch.Tensor, n_head: int) -> torch.Tensor:
    """NCHW images -> [B, embed_dim] in the tower's dtype."""
    v = params["visual"]
    stem = v["stem"]
    x = images.to(stem["conv1_w"].dtype)
    with exact_fp32_convolutions(x.dtype):
        x = torch.relu(batch_norm(conv2d(x, stem["conv1_w"], stride=2, padding=1), stem["bn1"]))
        x = torch.relu(batch_norm(conv2d(x, stem["conv2_w"], padding=1), stem["bn2"]))
        x = torch.relu(batch_norm(conv2d(x, stem["conv3_w"], padding=1), stem["bn3"]))
        x = avg_pool(x, 2)
        for stage_idx, stage in enumerate(v["stages"]):
            for block_idx, block in enumerate(stage):
                x = bottleneck(x, block, 2 if stage_idx > 0 and block_idx == 0 else 1)
    return attention_pool(x, v["attnpool"], n_head)


# --------------------------------------------------------------------------
# random init (name-based smoke builds; checkpoints use the importer below)
# --------------------------------------------------------------------------

def init_resnet_visual(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """Shape-correct seeded random visual tree for a named RN backbone
    (``resnet.py:145-216``): attnpool projections ~ N(0, C^-0.5), every
    bottleneck's bn3 gamma zeroed, fan-in-scaled normal conv kernels. The
    values come from ``gen`` on the CPU, not from the JAX package's RNG."""
    width = cfg.vision_width
    embed_c = width * 32

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dtype)

    def conv(out_c, in_c, k):
        return normal((out_c, in_c, k, k), (in_c * k * k) ** -0.5)

    def bn(c, zero_scale=False):
        return {
            "scale": torch.zeros(c, dtype=dtype) if zero_scale else torch.ones(c, dtype=dtype),
            "bias": torch.zeros(c, dtype=dtype),
            "mean": torch.zeros(c),
            "var": torch.ones(c),
        }

    stem = {
        "conv1_w": conv(width // 2, 3, 3), "bn1": bn(width // 2),
        "conv2_w": conv(width // 2, width // 2, 3), "bn2": bn(width // 2),
        "conv3_w": conv(width, width // 2, 3), "bn3": bn(width),
    }
    stages = []
    inplanes = width
    for stage_i, n_blocks in enumerate(cfg.vision_layers):
        planes = width * (2 ** stage_i)
        stage = []
        for b in range(n_blocks):
            block = {
                "conv1_w": conv(planes, inplanes, 1), "bn1": bn(planes),
                "conv2_w": conv(planes, planes, 3), "bn2": bn(planes),
                "conv3_w": conv(planes * 4, planes, 1), "bn3": bn(planes * 4, zero_scale=True),
            }
            if b == 0:
                block["down_conv_w"] = conv(planes * 4, inplanes, 1)
                block["down_bn"] = bn(planes * 4)
            stage.append(block)
            inplanes = planes * 4
        stages.append(stage)

    spatial = cfg.image_resolution // 32
    std = embed_c ** -0.5
    attnpool = {"positional_embedding": normal((spatial * spatial + 1, embed_c), std)}
    for name, out_c in (("q", embed_c), ("k", embed_c), ("v", embed_c), ("c", cfg.embed_dim)):
        attnpool[f"{name}_w"] = normal((embed_c, out_c), std)
        attnpool[f"{name}_b"] = torch.zeros(out_c, dtype=dtype)
    return {"stem": stem, "stages": stages, "attnpool": attnpool}


# --------------------------------------------------------------------------
# torch import
# --------------------------------------------------------------------------

def _bn(sd, prefix, t):
    return {
        "scale": t(sd[prefix + ".weight"]),
        "bias": t(sd[prefix + ".bias"]),
        "mean": t(sd[prefix + ".running_mean"]),
        "var": t(sd[prefix + ".running_var"]),
    }


def stage_depths(sd: Dict) -> Tuple[int, ...]:
    """The four stages' block counts of a ResNet CLIP state_dict."""
    return tuple(
        len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
        for b in (1, 2, 3, 4)
    )


def resnet_visual_from_state_dict(sd: Dict, t) -> Tuple[dict, dict]:
    """``visual.*`` keys of a ResNet CLIP state_dict -> (visual params, meta
    ``{layers, width, heads, output_dim, image_resolution}``); ``t``
    converts a tensor to fp32 on the CPU. Linear weights are transposed to
    ``[in, out]``; convolution kernels stay OIHW."""
    stem = {
        "conv1_w": t(sd["visual.conv1.weight"]), "bn1": _bn(sd, "visual.bn1", t),
        "conv2_w": t(sd["visual.conv2.weight"]), "bn2": _bn(sd, "visual.bn2", t),
        "conv3_w": t(sd["visual.conv3.weight"]), "bn3": _bn(sd, "visual.bn3", t),
    }
    counts = stage_depths(sd)
    stages = []
    for stage_i, n_blocks in enumerate(counts, start=1):
        stage = []
        for b in range(n_blocks):
            pre = f"visual.layer{stage_i}.{b}"
            block = {
                "conv1_w": t(sd[pre + ".conv1.weight"]), "bn1": _bn(sd, pre + ".bn1", t),
                "conv2_w": t(sd[pre + ".conv2.weight"]), "bn2": _bn(sd, pre + ".bn2", t),
                "conv3_w": t(sd[pre + ".conv3.weight"]), "bn3": _bn(sd, pre + ".bn3", t),
            }
            if pre + ".downsample.0.weight" in sd:
                block["down_conv_w"] = t(sd[pre + ".downsample.0.weight"])
                block["down_bn"] = _bn(sd, pre + ".downsample.1", t)
            stage.append(block)
        stages.append(stage)

    ap = "visual.attnpool."
    attnpool = {"positional_embedding": t(sd[ap + "positional_embedding"])}
    for name in ("q", "k", "v", "c"):
        attnpool[f"{name}_w"] = t(sd[f"{ap}{name}_proj.weight"]).t().contiguous()
        attnpool[f"{name}_b"] = t(sd[f"{ap}{name}_proj.bias"])

    width = sd["visual.layer1.0.conv1.weight"].shape[0]
    spatial = round((attnpool["positional_embedding"].shape[0] - 1) ** 0.5)
    meta = {
        "layers": counts,
        "width": width,
        "heads": width * 32 // 64,
        "output_dim": attnpool["c_w"].shape[1],
        "image_resolution": spatial * 32,
    }
    return {"stem": stem, "stages": stages, "attnpool": attnpool}, meta
