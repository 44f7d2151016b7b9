"""Operations and bytes of the algorithm, from shapes, and the chip's peaks.

The work a request or a training step needs, whatever implements it: each
unit below reads its inputs and weights once and writes its outputs once, in
the served dtype (bf16: 2 bytes). A unit's least time is the larger of its
operations over the bf16 peak and its bytes over the memory bandwidth; the
roofline share is the sum of these over the window's units, divided by the
device's busy time. The model FLOPs are the sum of the units' operations.

Units: a transformer block is two, its attention half (LayerNorm, the qkv
product, the attention core, the output product, the residual) and its MLP
half (LayerNorm, two products, the residual). A causal core counts the
``L (L + 1) / 2`` query-key pairs it needs. Backward (dx only, the frozen
text tower's) counts each product once more and the core twice.
Augmentation and the optimizer update count their bytes only.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s
PEAK_FP32 = 67e12  # FLOP/s, outside the tensor cores
HBM_BYTES_S = 3.35e12  # bytes/s
BF16 = 2
FP32 = 4


class Work:
    """Summed model FLOPs and least seconds of a set of units."""

    def __init__(self, flops: float = 0.0, bound_s: float = 0.0):
        self.flops = flops
        self.bound_s = bound_s

    def unit(self, flops: float, nbytes: float) -> "Work":
        self.flops += flops
        self.bound_s += max(flops / PEAK_BF16, nbytes / HBM_BYTES_S)
        return self

    def bytes_only(self, nbytes: float) -> "Work":
        self.bound_s += nbytes / HBM_BYTES_S
        return self

    def __iadd__(self, other: "Work") -> "Work":
        self.flops += other.flops
        self.bound_s += other.bound_s
        return self

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.bound_s * k)


def core_pairs(length: int, causal: bool) -> int:
    return length * (length + 1) // 2 if causal else length * length


def attn_half(batch: int, length: int, width: int, causal: bool = False):
    """(flops, bytes) of one attention half over ``batch`` sequences."""
    tokens = batch * length
    flops = 2 * tokens * width * 3 * width + 4 * batch * core_pairs(length, causal) * width \
        + 2 * tokens * width * width
    nbytes = BF16 * (2 * tokens * width + 4 * width * width + 6 * width)
    return flops, nbytes


def mlp_half(batch: int, length: int, width: int):
    """(flops, bytes) of one MLP half (hidden 4 x width)."""
    tokens = batch * length
    flops = 2 * 2 * tokens * width * 4 * width
    nbytes = BF16 * (2 * tokens * width + 8 * width * width + 7 * width)
    return flops, nbytes


def tower(batch: int, length: int, width: int, layers: int, causal: bool = False) -> Work:
    w = Work()
    for _ in range(layers):
        w.unit(*attn_half(batch, length, width, causal))
        w.unit(*mlp_half(batch, length, width))
    return w


def tower_backward_dx(batch: int, length: int, width: int, layers: int, causal: bool) -> Work:
    """dx through a frozen tower: each half reads its saved input, the
    incoming gradient and its weights, and writes the input's gradient."""
    w = Work()
    tokens = batch * length
    for _ in range(layers):
        fa, _ = attn_half(batch, length, width, causal)
        core = 4 * batch * core_pairs(length, causal) * width
        w.unit(fa + core, BF16 * (3 * tokens * width + 4 * width * width))
        fm, _ = mlp_half(batch, length, width)
        w.unit(fm, BF16 * (3 * tokens * width + 8 * width * width))
    return w


def vision(cfg: dict, images: int) -> Work:
    """The image tower over ``images`` images: patch embedding, the blocks,
    the pooled projection."""
    p, width = cfg["vision_patch_size"], cfg["vision_width"]
    grid = cfg["image_resolution"] // p
    length = grid * grid + 1
    patch_in = 3 * p * p
    w = Work().unit(2 * images * grid * grid * patch_in * width,
                    FP32 * images * grid * grid * patch_in + BF16 * (patch_in * width
                                                                    + images * length * width))
    w += tower(images, length, width, cfg["vision_layers"])
    w.unit(2 * images * width * cfg["embed_dim"],
           BF16 * (images * width + width * cfg["embed_dim"] + images * cfg["embed_dim"]))
    return w


def text(cfg: dict, sequences: int) -> Work:
    """The causal text tower over ``sequences`` 77-token sequences, with the
    projection of the gathered token."""
    width, length = cfg["transformer_width"], cfg["context_length"]
    w = tower(sequences, length, width, cfg["transformer_layers"], causal=True)
    w.unit(2 * sequences * width * cfg["embed_dim"],
           BF16 * (sequences * width + width * cfg["embed_dim"]))
    return w


def generator(cfg: dict, classes: int, shots: int) -> Work:
    """OVMR's visual token generator over ``classes`` sets of ``shots``
    exemplar features (plus the ``n_ctx`` queries)."""
    return tower(classes, cfg["n_ctx"] + shots, cfg["embed_dim"], cfg["generator_layers"])


def fusion(cfg: dict, classes: int, shots: int) -> Work:
    """Exemplar logits against the three classifiers (F1 and softmax are
    counts)."""
    rows, d = classes * shots, cfg["embed_dim"]
    return Work().unit(3 * 2 * rows * classes * d,
                       BF16 * rows * d + 3 * FP32 * classes * d)


def generate_request(cfg: dict, classes: int, shots: int, encode: bool) -> Work:
    """One ``generate`` (``encode``) or ``generate_from_features`` request:
    exemplar encoding, the generator, three text passes a class (text
    classifier, multi-modal and vision prompts), fusion."""
    w = vision(cfg, classes * shots) if encode else Work()
    w += generator(cfg, classes, shots)
    w += text(cfg, 3 * classes)
    w += fusion(cfg, classes, shots)
    return w


def train_step(cfg: dict, classes: int, instances: int, split: int, side: int, out: int,
               params: int) -> Work:
    """One MM_CLS_OP step: augmentation (uint8 in, noise in, bf16 out), both
    image passes, the generator forward and backward (dx and dW), the two
    prompted text passes forward and dx backward, Adam over ``params``
    fp32 leaves (read p, g, m, v; write p, m, v)."""
    images = classes * instances
    w = Work().bytes_only(images * side * side * 3 + images * out * out * 3 * (FP32 + BF16))
    w += vision(cfg, images)
    agg = generator(cfg, classes, instances - split)
    w += agg.scaled(3)
    w += text(cfg, 2 * classes)
    w += tower_backward_dx(2 * classes, cfg["context_length"], cfg["transformer_width"],
                           cfg["transformer_layers"], causal=True)
    w.bytes_only(7 * FP32 * params)
    return w
