"""K3's one-launch attention-backward core for short heads, on the CPU.

A numpy model of what one block of the card's short core computes for one
(head, image) — the head padded to whole 16-row warps, every key of a row
in one pass: fp32 scores (keys past L at -inf), the fp32 max, sum and
normalised probs formed as exp2(s log2(e) - m log2(e)) * (1 / sum), dP,
delta = sum P dP, dS = cast(P (dP - delta) scale), dq = cast(dS k), the
padded query rows zeroed, then T(P) and T(dS) as the warps read them back
for dv = cast(T(P)^T dO) and dk = cast(T(dS)^T q) — against the plain core
``attn_bwd_core_plain`` at L 1, 16, 77 and 128, head widths 40, 64 and 128,
with no mask, the causal mask and a random one: fp32 within 1e-5 of the
output scale, bf16 within two units in the last place at the output's
largest magnitude (the casts fall on fp32 values summed in another order).
The route that sends such heads to it is checked too.
"""

import math
import re

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused_bwd import (
    SHORT_CORE_MAX_L,
    attn_bwd_core,
    attn_bwd_core_plain,
    attn_bwd_core_route,
)

LOG2E = np.float32(1.4426950408889634)


def _mask(kind, l):
    """None, causal (-inf above the diagonal), or random additive entries
    with a quarter of them pushed down towards -1e4."""
    if kind == "none":
        return None
    if kind == "causal":
        return np.triu(np.full((l, l), -np.inf, np.float32), 1)
    rng = np.random.RandomState(l + 1)
    m = rng.randn(l, l).astype(np.float32)
    drop = rng.rand(l, l).astype(np.float32)
    return np.where(drop < 0.25, -1e4 * drop * 4, m).astype(np.float32)


def _short_core_model(q, k, v, do, mask, scale, cast):
    """One block of the short core in numpy fp32 for one head of L <= 128
    tokens: rows and keys padded to R = 16 ceil(L / 16)."""
    f32 = np.float32
    L, dh = q.shape
    R = 16 * -(-L // 16)

    def pad(a):
        return np.concatenate([a, np.zeros((R - L, dh), f32)])

    q, k, v, do = (pad(a) for a in (q, k, v, do))
    s = (q @ k.T) * f32(scale)
    if mask is not None:  # a padded row reads the mask row L - 1 (it is zeroed below)
        s[:, :L] += mask[np.minimum(np.arange(R), L - 1)]
    s[:, L:] = -np.inf
    m = s.max(1, keepdims=True)
    e = np.exp2(s * LOG2E - m * LOG2E).astype(f32)
    p = e * (f32(1) / e.sum(1, keepdims=True))
    p[L:] = 0
    dp = do @ v.T
    delta = (p * dp).sum(1, keepdims=True)
    ds = cast(p * (dp - delta) * f32(scale))
    dq = cast(ds @ k)
    dv = cast(cast(p).T @ do)
    dk = cast(ds.T @ q)
    return dq[:L], dk[:L], dv[:L]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
@pytest.mark.parametrize("dh", [40, 64, 128])
@pytest.mark.parametrize("l", [1, 16, 77, 128])
def test_short_core_model_matches_the_plain_core(dtype, mask_kind, dh, l):
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    heads = 2
    rng = np.random.RandomState(l * 11 + dh)
    qkv = torch.tensor(rng.randn(1, l, 3 * heads * dh).astype(np.float32)).to(tdt)
    dattn = torch.tensor(rng.randn(1, l, heads * dh).astype(np.float32)).to(tdt)
    mask = _mask(mask_kind, l)
    ref = attn_bwd_core_plain(qkv, dattn, None if mask is None else torch.tensor(mask),
                              heads).float().numpy()[0]

    def cast(a):
        return torch.tensor(np.asarray(a, np.float32)).to(tdt).float().numpy()

    w = heads * dh
    q, k, v = (qkv.float().numpy()[0, :, i * w:(i + 1) * w] for i in range(3))
    do = dattn.float().numpy()[0]
    got = np.zeros_like(ref)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        for i, part in enumerate(_short_core_model(q[:, cols], k[:, cols], v[:, cols],
                                                   do[:, cols], mask, dh ** -0.5, cast)):
            got[:, i * w + h * dh:i * w + (h + 1) * dh] = part
    assert np.isfinite(got).all()
    peak = max(float(np.abs(ref).max()), 1.0)
    tol = 1e-5 * peak if dtype == "fp32" else 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    assert float(np.abs(got - ref).max()) <= tol


def test_short_heads_route_to_the_one_launch_core():
    """bf16/fp16 heads of up to 128 tokens (the text tower's 77) take the
    one-launch core; longer heads and fp32 the query-tiled pair. The CPU
    wrapper is the plain core."""
    assert SHORT_CORE_MAX_L == 128
    for dtype in (torch.bfloat16, torch.float16):
        assert [attn_bwd_core_route(l, dtype) for l in (1, 77, 128, 129, 197, 577)] == \
            ["short"] * 3 + ["tiled"] * 3
    assert {attn_bwd_core_route(l, torch.float32) for l in (1, 77, 577)} == {"tiled"}
    g = torch.Generator().manual_seed(0)
    qkv, dattn = torch.randn(2, 77, 96, generator=g), torch.randn(2, 77, 32, generator=g)
    assert torch.equal(attn_bwd_core(qkv, dattn, None, 2), attn_bwd_core_plain(qkv, dattn, None, 2))
    with pytest.raises(ValueError, match="dattn"):
        attn_bwd_core(qkv, dattn[:, :, :16], None, 2)


def test_short_core_shared_memory_fits_a_block():
    """The one-launch core holds a head's Q, K, V and dO (rows of the padded
    width plus 8) and T(P), T(dS) (rows of NT * 8 + 8 keys) for 16 ceil(L /
    16) rows: at 80 rows (NT 10) and 128 (NT 16), widths 64 and 128, it fits
    a block's 227 KB, and three blocks share an SM at the text tower's 80
    rows of width 64. Sizes from csrc/block_fused_bwd.cu's bs_smem."""
    text = (cuda_lib.CSRC / "block_fused_bwd.cu").read_text()
    body = re.search(r"constexpr size_t bs_smem\(int rows, int dhp, int nt\) \{\s*return ([^;]*);",
                     text).group(1)
    assert body == "(size_t)rows * (4 * (dhp + 8) + 2 * (nt * 8 + 8)) * 2"

    def bs(rows, dhp, nt):
        return rows * (4 * (dhp + 8) + 2 * (nt * 8 + 8)) * 2

    assert bs(80, 64, 10) == 74240 and 3 * bs(80, 64, 10) <= 228 * 1024 - 3 * 1024
    assert max(bs(8 * nt, dhp, nt) for nt in (10, 16) for dhp in (64, 128)) <= 227 * 1024
    assert "static_assert(most <= 227 * 1024" in text
