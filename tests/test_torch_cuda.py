"""The port's hand-written kernels against their plain versions on a CUDA
card, and the serving slice on the card against the CPU.

Every test here needs a card: marked ``cuda`` and skipped without one
(the check runs inside the ``cuda`` fixture, not at import). On the card:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.

Tolerances: fp32 1e-5 of the output scale; bf16/fp16 two units in the
last place at the output's largest magnitude (the kernel and the plain
version may round one sum to a neighbouring value).
"""

import math

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.attention import fused_attention, fused_attention_plain
from ovmr_tpu_torch.ops.block_fused import (
    fused_attn_half,
    fused_attn_half_plain,
    fused_mlp_half,
    fused_mlp_half_plain,
)
from ovmr_tpu_torch.ops.layers import causal_mask

pytestmark = pytest.mark.cuda

MANTISSA = {torch.float32: None, torch.bfloat16: 7, torch.float16: 10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    peak = max(float(ref.abs().max()), 1.0)
    bits = MANTISSA[ref.dtype]
    tol = 1e-5 * peak if bits is None else 2.0 * 2.0 ** (math.floor(math.log2(peak)) - bits)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


def _layer(d, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*s, std):
        return (torch.randn(*s, generator=g) * std).to(device, dtype)

    return {
        "w_qkv": r(d, 3 * d, std=d ** -0.5), "b_qkv": r(3 * d, std=0.02),
        "w_out": r(d, d, std=d ** -0.5), "b_out": r(d, std=0.02),
        "ln_s": 1 + r(d, std=0.1), "ln_b": r(d, std=0.1),
        "c_fc_w": r(d, 4 * d, std=d ** -0.5), "c_fc_b": r(4 * d, std=0.02),
        "c_proj_w": r(4 * d, d, std=(4 * d) ** -0.5), "c_proj_b": r(d, std=0.02),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "b,l,d,h,masked",
    [(1, 1, 64, 1, False), (2, 17, 64, 2, True), (3, 17, 64, 1, False),
     (2, 77, 64, 2, True), (5, 9, 128, 4, False), (2, 197, 768, 12, False),
     (3, 77, 512, 8, True), (2, 33, 40, 5, True)],
)
def test_block_halves_match_plain(cuda, dtype, b, l, d, h, masked):
    p = _layer(d, dtype, cuda, seed=b * 1000 + l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    a = (x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_s"], p["ln_b"])
    cuda_lib.reset_launches()
    _check(fused_attn_half(*a, mask=mask, n_head=h), fused_attn_half_plain(*a, mask=mask, n_head=h))
    m = (x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_s"], p["ln_b"])
    _check(fused_mlp_half(*m), fused_mlp_half_plain(*m))
    k1 = "fused_attn_half_masked" if masked else "fused_attn_half"
    assert cuda_lib.LAUNCHES[k1] == 1 and cuda_lib.LAUNCHES["fused_mlp_half"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,masked", [((32, 8, 18, 64), False), ((2, 1, 17, 64), True),
                                          ((3, 2, 9, 32), False), ((4, 2, 77, 64), True)])
def test_fused_attention_matches_plain(cuda, dtype, shape, masked):
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(*shape, generator=g).to(cuda, dtype) for _ in range(3))
    mask = causal_mask(shape[2], device=cuda) if masked else None
    _check(fused_attention(q, k, v, mask), fused_attention_plain(q, k, v, mask))


def test_kernels_refuse_what_they_do_not_take(cuda):
    p = _layer(64, torch.float32, cuda, seed=0)
    x = torch.randn(2, 9, 64, device=cuda)
    a = (p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_s"], p["ln_b"])
    with pytest.raises(TypeError):
        fused_attn_half(x.half(), *a, n_head=2)  # mixed dtypes
    with pytest.raises(ValueError, match="contiguous"):
        fused_attn_half(x.transpose(0, 1).contiguous().transpose(0, 1), *a, n_head=2)
    with pytest.raises(ValueError, match="head width"):
        fused_attn_half(x, *a, n_head=3)
    with pytest.raises(ValueError, match="on cpu"):
        fused_attn_half(x, p["w_qkv"].cpu(), *a[1:], n_head=2)
    with pytest.raises(ValueError, match="mask"):
        fused_attn_half(x, *a, mask=torch.zeros(9, 9, device=cuda, dtype=torch.half), n_head=2)


def test_slice_on_card_matches_cpu(cuda):
    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator

    cp = tclip.init_params(tclip.TINY, seed=0)
    ap = init_aggregator(width=64, layers=2, n_ctx=2, seed=0)
    rng = np.random.RandomState(0)
    images = (rng.rand(3, 1, 3, 32, 32) + 0.3 * rng.rand(3, 4, 3, 32, 32)).astype(np.float32)
    names = ["red circle", "green square", "blue triangle"]
    cuda_lib.reset_launches()
    gpu = OVMRGenerator(cp, tclip.TINY, ap, dtype=torch.float32, device="cuda").generate(names, images)
    assert all(v > 0 for v in cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES
    cpu = OVMRGenerator(cp, tclip.TINY, ap, dtype=torch.float32, device="cpu").generate(names, images)
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "visual_tokens"):
        np.testing.assert_allclose(gpu[key], cpu[key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(gpu["fusion_weight"], cpu["fusion_weight"], atol=1e-3)
