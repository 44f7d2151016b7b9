"""The port's hand-written kernels against their plain versions on a CUDA
card, the differentiable entries on the card against the CPU, and the
serving slice on the card against the CPU; the tensor-parallel partials K7
and K8 and the TP block likewise.

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
from ovmr_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_kernel,
    fused_attention_plain,
)
from ovmr_tpu_torch.ops.block_fused import (
    BLOCK_KEYS,
    attn_core,
    attn_core_plain,
    fused_attn_half,
    fused_attn_half_plain,
    fused_mlp_half,
    fused_mlp_half_chunked,
    fused_mlp_half_chunked_plain,
    fused_mlp_half_plain,
    block_gemm,
    block_gemm_plain,
    fused_residual_block,
)
from ovmr_tpu_torch.ops import block_fused as tbf
from ovmr_tpu_torch.ops.block_fused_bwd import (
    attn_bwd_core,
    attn_bwd_core_plain,
    attn_half_bwd_dx,
    attn_half_bwd_dx_plain,
    block_gemm_bwd,
    block_gemm_bwd_plain,
    mlp_bwd_dh,
    mlp_bwd_dh_plain,
    mlp_half_bwd_dx,
    mlp_half_bwd_dx_plain,
)
from ovmr_tpu_torch.ops import block_fused_tp as tbtp
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
@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("b,l,d", [(1, 1, 64), (3, 17, 64), (2, 33, 40), (5, 9, 128),
                                   (3, 77, 768), (2, 577, 1024)])
def test_chunked_mlp_half_matches_plain(cuda, dtype, chunks, b, l, d):
    """K5 against its plain version, from one token to ViT-L/14@336px's
    shape, at a width (40) that is a multiple of 8 but not of 128."""
    p = _layer(d, dtype, cuda, seed=b * 1000 + l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    m = (x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_s"], p["ln_b"])
    cuda_lib.reset_launches()
    _check(fused_mlp_half_chunked(*m, chunks=chunks),
           fused_mlp_half_chunked_plain(*m, chunks=chunks))
    assert cuda_lib.LAUNCHES["fused_mlp_half_chunked"] == 1
    assert cuda_lib.LAUNCHES["fused_mlp_half"] == 0


def test_chunked_mlp_half_raises_chunks_to_a_divisor(cuda):
    p = _layer(64, torch.float32, cuda, seed=3)  # hidden 256: 3 -> 4 chunks
    x = torch.randn(2, 9, 64, device=cuda)
    m = (x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_s"], p["ln_b"])
    assert torch.equal(fused_mlp_half_chunked(*m, chunks=3), fused_mlp_half_chunked(*m, chunks=4))
    with pytest.raises(ValueError, match="chunk width"):
        fused_mlp_half_chunked(*m, chunks=64)  # slices of 4 columns start off a 16-byte boundary


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,l,d,h", [(2, 320, 128, 2), (2, 321, 128, 2), (1, 577, 1024, 16),
                                     (1, 400, 256, 2), (3, 700, 40, 1)])
def test_attn_half_at_long_sequences(cuda, dtype, masked, b, l, d, h):
    """K1 at lengths off the attention core's 64-key and 128-query tiles,
    at ViT-L/14@336px's 577 tokens, at head widths 128 and 40, with and
    without a causal mask."""
    p = _layer(d, dtype, cuda, seed=l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    a = (x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_s"], p["ln_b"])
    _check(fused_attn_half(*a, mask=mask, n_head=h), fused_attn_half_plain(*a, mask=mask, n_head=h))


def _core_mask(kind, l, device):
    """No mask, causal, or random additive entries (a quarter of them
    pushed down towards -1e4)."""
    if kind == "none":
        return None
    if kind == "causal":
        return causal_mask(l, device=device)
    g = torch.Generator().manual_seed(l)
    m = torch.randn(l, l, generator=g)
    drop = torch.rand(l, l, generator=g)
    return torch.where(drop < 0.25, -1e4 * drop * 4, m).to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
@pytest.mark.parametrize("heads", [2, 3], ids=["k1-W=D", "k7-W=dl"])
@pytest.mark.parametrize("dh", [16, 40, 64, 128])
@pytest.mark.parametrize("l", [1, 16, 17, 63, 64, 65, 77, 197, 320, 321, 577, 700])
def test_attn_core_matches_plain(cuda, dtype, mask_kind, heads, dh, l):
    """The register-resident core against its plain twin across key-tile
    edges (64), query-tile edges (128), the paths' 77, 197 and 577 tokens,
    head widths zero-padded to 64 (16, 40) or 128, and both packings K1 (two
    heads of a width D) and K7 (three heads of a shard dl of a wider model)
    hand it."""
    b = 2
    g = torch.Generator().manual_seed(l * 131 + dh)
    qkv = torch.randn(b, l, 3 * heads * dh, generator=g).to(cuda, dtype)
    mask = _core_mask(mask_kind, l, cuda)
    cuda_lib.reset_launches()
    _check(attn_core(qkv, mask, heads), attn_core_plain(qkv, mask, heads))
    assert cuda_lib.LAUNCH_SHAPES == {
        ("attn_core", (b, l, heads * dh, heads), str(dtype).removeprefix("torch.")): 1}


def test_attn_core_refuses_what_it_does_not_take(cuda):
    qkv = torch.randn(2, 9, 3 * 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds"):
        attn_core(qkv, None, 1)  # head width 256
    with pytest.raises(ValueError, match="multiple of 8"):
        attn_core(qkv, None, 64)  # head width 4
    with pytest.raises(ValueError, match="fp32"):
        attn_core(qkv, torch.zeros(9, 9, device=cuda, dtype=torch.bfloat16), 4)
    with pytest.raises(ValueError, match="contiguous"):
        attn_core(qkv.transpose(0, 1).contiguous().transpose(0, 1), None, 4)
    with pytest.raises(TypeError):
        attn_core(qkv.to(torch.float64), None, 4)
    with pytest.raises(RuntimeError, match="requires grad"):
        attn_core(qkv.float().requires_grad_(True), None, 4)


# K6 at the aggregator's L = 18 (ViT-B/16: 8 heads, ViT-L/14@336px: 12), the
# fp32 TP check's L = 4, at one and past one chunk of 32 keys (32, 33) and
# at the text length 77, masked and not; head widths that take the 16-byte
# loads (32, 64), two column passes (72, 128) or element loads (20: L Dh is
# no multiple of 8); the most keys (256) and the old kernel's longest head
# at Dh 64 (162)
K6_SHAPES = [((32, 8, 18, 64), False), ((2, 1, 17, 64), True), ((3, 2, 9, 32), False),
             ((4, 2, 77, 64), True)] + [
    ((3, h, l, 64), masked) for l in (4, 18, 32, 33, 77) for h in (8, 12)
    for masked in (False, True)] + [
    ((2, 3, 9, 20), True), ((2, 2, 40, 72), False), ((2, 2, 33, 128), True),
    ((1, 2, 256, 32), True), ((1, 1, 162, 64), False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,masked", K6_SHAPES)
def test_fused_attention_matches_plain(cuda, dtype, shape, masked):
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(*shape, generator=g).to(cuda, dtype) for _ in range(3))
    mask = causal_mask(shape[2], device=cuda) if masked else None
    cuda_lib.reset_launches()
    _check(fused_attention(q, k, v, mask), fused_attention_plain(q, k, v, mask))
    assert cuda_lib.LAUNCHES["fused_attention"] == 1


def test_fused_attention_refuses_what_it_does_not_take(cuda):
    """K6 refuses a tensor that requires grad (the raw wrapper records no
    graph), a mask that is not fp32, and a head beyond its limits: more
    than 256 keys, or one warp's fp32 Q, K and V above 227 KB of shared
    memory; nothing is launched."""
    q = torch.randn(2, 2, 18, 64, device=cuda)
    cuda_lib.reset_launches()
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_attention_kernel(q.clone().requires_grad_(True), q, q)
    with pytest.raises(ValueError, match="fp32"):
        fused_attention(q, q, q, causal_mask(18, device=cuda).to(torch.bfloat16))
    for shape in ((1, 1, 257, 32), (1, 1, 64, 320)):
        t = torch.randn(*shape, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="shared memory"):
            fused_attention(t, t, t)
    assert cuda_lib.LAUNCHES["fused_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "b,l,d,h,masked",
    [(1, 1, 64, 1, False), (2, 17, 64, 2, True), (3, 17, 64, 1, False),
     (2, 77, 64, 2, True), (5, 9, 128, 4, False), (3, 77, 512, 8, True),
     (3, 77, 512, 8, False), (2, 33, 40, 5, True), (192, 77, 512, 8, True)],
)
def test_dx_halves_match_plain(cuda, dtype, b, l, d, h, masked):
    """K3 and K4 against their plain twins, TINY and text-tower shapes."""
    p = _layer(d, dtype, cuda, seed=b * 1000 + l)
    gen = torch.Generator().manual_seed(l)
    x = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    cuda_lib.reset_launches()
    a = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"], p["ln_s"], p["ln_b"])
    _check(attn_half_bwd_dx(*a, mask=mask, n_head=h),
           attn_half_bwd_dx_plain(*a, mask=mask, n_head=h))
    m = (x, g, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["ln_s"], p["ln_b"])
    _check(mlp_half_bwd_dx(*m), mlp_half_bwd_dx_plain(*m))
    k3 = "attn_half_bwd_dx_masked" if masked else "attn_half_bwd_dx"
    assert cuda_lib.LAUNCHES[k3] == 1 and cuda_lib.LAUNCHES["mlp_half_bwd_dx"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,h", [(2, 197, 768, 12), (1, 577, 1024, 16)])
def test_attn_bwd_core_refuses_a_head_that_does_not_fit(cuda, dtype, b, l, d, h):
    """No head is too long for K3 any more: ViT-B/16's L = 197 and
    ViT-L/14@336px's 577 (whose whole head outgrows a block's shared
    memory) run the query-tiled core and match the plain twin. What the core
    still refuses is a head width above 128."""
    p = _layer(d, dtype, cuda, seed=l)
    gen = torch.Generator().manual_seed(l)
    x = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    a = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"], p["ln_s"], p["ln_b"])
    cuda_lib.reset_launches()
    _check(attn_half_bwd_dx(*a, n_head=h), attn_half_bwd_dx_plain(*a, n_head=h))
    assert cuda_lib.LAUNCHES["attn_half_bwd_dx"] == 1
    w = _layer(272, dtype, cuda, seed=1)
    x = torch.randn(1, 9, 272, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="exceeds"):
        attn_half_bwd_dx(x, x, w["w_qkv"], w["b_qkv"], w["w_out"], w["ln_s"], w["ln_b"],
                         n_head=2)  # head width 136


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
@pytest.mark.parametrize("dh", [16, 40, 64, 128])
@pytest.mark.parametrize("l", [1, 16, 17, 63, 64, 65, 77, 127, 128, 129, 197, 320, 577, 700])
def test_attn_bwd_tiled_core_matches_plain(cuda, dtype, mask_kind, dh, l):
    """K3 across the tiled core's key (64) and query (32, 64, 128) tile
    edges, at the paths' 77, 197 and 577 tokens, at head widths zero-padded
    to 64 (16, 40) or 128, with no mask, the causal mask and a random one;
    fp32 runs the tiled FMA launches at every length, bf16/fp16 the
    one-launch core up to 128 tokens and the tiled pair beyond."""
    b, h = 2, 2
    d = h * dh
    p = _layer(d, dtype, cuda, seed=l * 131 + dh)
    gen = torch.Generator().manual_seed(l * 7 + dh)
    x = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    mask = _core_mask(mask_kind, l, cuda)
    a = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"], p["ln_s"], p["ln_b"])
    _check(attn_half_bwd_dx(*a, mask=mask, n_head=h),
           attn_half_bwd_dx_plain(*a, mask=mask, n_head=h))


_EPILOGUE_ARGS = {"bias": (True, False), "gelu": (True, False), "residual": (True, True),
                  "f32": (False, False), "accum": (False, False)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual", "f32", "accum"])
@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (128, 128, 64), (72, 200, 1000), (1, 8, 8),
                                   (300, 1000, 72), (4100, 3072, 768), (2464, 768, 3072)])
@pytest.mark.parametrize("sliced", [False, True])
def test_mlp_gemm_matches_plain(cuda, dtype, epilogue, m, n, k, sliced):
    """The wgmma/TMA GEMM of K1, K2, K5 and K7 against its plain twin: one
    64-wide tile, one full 128 x 128 tile, ragged M, N and K that are
    multiples of 8 but not of the tile, ViT-B/16's text MLP shapes;
    ``sliced`` reads W as a column slice of a wider weight and writes C
    into a column slice of a wider buffer (K5's and K7's layouts, and more).
    ``"f32"`` writes an fp32 C, held at the input dtype's tolerance."""
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen).to(cuda, dtype)
    w_full = (torch.randn(k, n + (24 if sliced else 0), generator=gen) * k ** -0.5).to(cuda, dtype)
    w = w_full[:, 16:16 + n] if sliced else w_full
    has_bias, has_resid = _EPILOGUE_ARGS[epilogue]
    bias = (torch.randn(n, generator=gen) * 0.1).to(cuda, dtype) if has_bias else None
    resid = torch.randn(m, n, generator=gen).to(cuda, dtype) if has_resid else None
    out_dtype = torch.float32 if epilogue == "f32" else dtype
    c_full = torch.randn(m, n + (40 if sliced else 0), generator=gen).to(cuda, out_dtype)
    c = c_full[:, 8:8 + n] if sliced else c_full
    before = c_full.clone()
    ref = block_gemm_plain(a, w, bias, epilogue, resid, c.clone())
    cuda_lib.reset_launches()
    got = block_gemm(a, w, bias, epilogue, resid, out=c)
    assert got.data_ptr() == c.data_ptr() and cuda_lib.LAUNCHES["gemm_wgmma"] == 1
    if epilogue == "f32":
        _check_partial(got, ref, dtype)
    else:
        _check(got, ref)
    if sliced:  # the columns beside the slice are untouched
        assert torch.equal(c_full[:, :8], before[:, :8])
        assert torch.equal(c_full[:, 8 + n:], before[:, 8 + n:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,l,d", [(3, 17, 64), (2, 33, 40), (1, 577, 1024), (5, 9, 200)])
def test_k2_and_k5_launch_the_wgmma_gemm_in_half_precision(cuda, dtype, b, l, d):
    """K2 runs two products and K5 two a chunk on the wgmma GEMM in bf16 and
    fp16; fp32 keeps gemm.cuh's FMA GEMM."""
    p = _layer(d, dtype, cuda, seed=b * 100 + l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    m = (x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_s"], p["ln_b"])
    half = dtype != torch.float32
    cuda_lib.reset_launches()
    _check(fused_mlp_half(*m), fused_mlp_half_plain(*m))
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (2 if half else 0)
    cuda_lib.reset_launches()
    _check(fused_mlp_half_chunked(*m, chunks=2), fused_mlp_half_chunked_plain(*m, chunks=2))
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (4 if half else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,l,d,h,dl,nh", [(3, 17, 64, 2, 32, 1), (2, 33, 40, 5, 16, 2),
                                           (2, 77, 768, 12, 384, 6), (1, 577, 1024, 16, 512, 8),
                                           (2, 197, 768, 12, 384, 6)])
def test_k1_and_k7_launch_the_wgmma_gemm_in_half_precision(cuda, dtype, masked, b, l, d, h,
                                                          dl, nh):
    """K1 runs its QKV and out-proj, K7 its q, k, v and fp32 out-proj on the
    wgmma GEMM in bf16 and fp16 (2 and 4 launches); fp32 keeps gemm.cuh's
    FMA GEMM. Each still matches its plain twin."""
    p = _layer(d, dtype, cuda, seed=b * 10 + l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    half = dtype != torch.float32
    a = (x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_s"], p["ln_b"])
    cuda_lib.reset_launches()
    _check(fused_attn_half(*a, mask=mask, n_head=h), fused_attn_half_plain(*a, mask=mask, n_head=h))
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (2 if half else 0)
    s = _tp_shard(d, dl, 4 * dl, dtype, cuda, seed=l)
    cuda_lib.reset_launches()
    _check_partial(tbtp.tp_attn_half_partial(*_k7_args(x, s), mask=mask, n_head=nh),
                   tbtp.tp_attn_half_partial_plain(*_k7_args(x, s), mask=mask, n_head=nh), dtype)
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (4 if half else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,l,d,hl", [(3, 17, 64, 128), (2, 33, 40, 80), (2, 77, 768, 1536),
                                      (1, 577, 1024, 2048)])
def test_k8_launches_the_wgmma_gemm_in_half_precision(cuda, dtype, b, l, d, hl):
    """K8 runs its c_fc and fp32-out c_proj on the wgmma GEMM in bf16 and
    fp16 (2 launches); fp32 keeps gemm.cuh's FMA GEMM. It still matches
    its plain twin."""
    s = _tp_shard(d, d // 2, hl, dtype, cuda, seed=b * 10 + l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    m = (x, s["c_fc_w"], s["c_fc_b"], s["c_proj_w"], s["ln_s"], s["ln_b"])
    cuda_lib.reset_launches()
    _check_partial(tbtp.tp_mlp_half_partial(*m), tbtp.tp_mlp_half_partial_plain(*m), dtype)
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (0 if dtype == torch.float32 else 2)
    assert cuda_lib.LAUNCHES["tp_mlp_half_partial"] == 1


def test_mlp_gemm_refuses_what_it_does_not_take(cuda):
    a = torch.randn(9, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(64, 128, device=cuda, dtype=torch.bfloat16)
    b = torch.randn(128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        block_gemm(a.float(), w.float(), b.float())
    with pytest.raises(ValueError, match="multiples of 8"):
        block_gemm(a, w[:, :100], b[:100])
    with pytest.raises(ValueError, match="unit column stride"):
        block_gemm(a, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="needs a bias"):
        block_gemm(a, w, None, "gelu")
    with pytest.raises(ValueError, match="needs a bias"):  # the kernel reads bias in pairs
        block_gemm(a, w, torch.randn(256, device=cuda, dtype=torch.bfloat16)[::2])
    with pytest.raises(ValueError, match="needs a bias"):
        block_gemm(a, w, torch.randn(129, device=cuda, dtype=torch.bfloat16)[1:])
    with pytest.raises(ValueError, match="missing"):
        block_gemm(a, w, None, "accum")
    with pytest.raises(ValueError, match="takes no bias"):
        block_gemm(a, w, b, "f32")
    with pytest.raises(ValueError, match="takes no bias"):
        block_gemm(a, w, b, "accum", out=torch.zeros(9, 128, device=cuda, dtype=a.dtype))
    with pytest.raises(ValueError, match="out must be torch.float32"):  # f32 writes fp32
        block_gemm(a, w, None, "f32", out=torch.empty(9, 128, device=cuda, dtype=a.dtype))
    with pytest.raises(ValueError, match="even number"):  # the epilogue stores column pairs
        block_gemm(a, w, b, "bias", out=torch.empty(9, 129, device=cuda, dtype=a.dtype)[:, :128])
    with pytest.raises(ValueError, match="8-byte aligned"):  # an fp32 pair is 8 bytes
        block_gemm(a, w, None, "f32",
                   out=torch.empty(9 * 128 + 1, device=cuda)[1:].view(9, 128))
    with pytest.raises(RuntimeError, match="requires grad"):
        block_gemm(a, w.clone().requires_grad_(True), b)


def _ulps(ref, n):
    """n units in the last place at ref's largest magnitude (1e-5 of it in fp32)."""
    peak = max(float(ref.abs().max()), 1.0)
    bits = MANTISSA[ref.dtype]
    return n * 1e-5 * peak if bits is None else n * 2.0 ** (math.floor(math.log2(peak)) - bits)


def _tiled_core(qkv, dattn, mask, heads):
    """K3's query-tiled core pair at any length, launched directly."""
    b, l, w3 = qkv.shape
    lib = cuda_lib.library("block_fused_bwd")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b, heads, 3, -(-l // 128) * 128), dtype=torch.float32, device=qkv.device)
    cuda_lib.check(lib, lib.ovmr_attn_bwd_core(
        cuda_lib.dtype_code(qkv.dtype), qkv.data_ptr(), dattn.data_ptr(),
        mask.data_ptr() if mask is not None else None, dqkv.data_ptr(), stats.data_ptr(), b, l,
        w3 // 3, heads, cuda_lib.stream_of(qkv)), "ovmr_attn_bwd_core")
    return dqkv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
@pytest.mark.parametrize("dh", [16, 40, 64, 128])
@pytest.mark.parametrize("l", [1, 16, 17, 65, 77, 80, 81, 127, 128])
def test_attn_bwd_short_core_matches_tiled_and_plain(cuda, dtype, mask_kind, dh, l):
    """The one-launch core for heads of up to 128 tokens (one block per
    head and image, a warp per 16 query rows; 80 padded keys or 128)
    against the plain core, two units in the last place, and against the
    tiled pair on the same inputs, within the sum of their allowances."""
    b, h = 3, 2
    gen = torch.Generator().manual_seed(l * 13 + dh)
    qkv = torch.randn(b, l, 3 * h * dh, generator=gen).to(cuda, dtype)
    dattn = torch.randn(b, l, h * dh, generator=gen).to(cuda, dtype)
    mask = _core_mask(mask_kind, l, cuda)
    ref = attn_bwd_core_plain(qkv, dattn, mask, h)
    cuda_lib.reset_launches()
    got = attn_bwd_core(qkv, dattn, mask, h)
    assert cuda_lib.LAUNCHES["attn_bwd_core_short"] == 1
    assert cuda_lib.LAUNCHES["attn_bwd_core_tiled"] == 0
    _check(got, ref)
    tiled = _tiled_core(qkv, dattn, mask, h)
    _check(tiled, ref)
    assert float((got.float() - tiled.float()).abs().max()) <= _ulps(ref, 4)


_BWD_GEMM_SHAPES = [(72, 8, 64), (300, 120, 72), (4100, 136, 512), (1, 8, 8), (2464, 2048, 512),
                    (2464, 512, 1536), (129, 512, 2048)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("epilogue", ["bias_f32", "cast", "gelu_grad", "f32"])
@pytest.mark.parametrize("m,n,k", _BWD_GEMM_SHAPES)
@pytest.mark.parametrize("sliced", [False, True])
def test_bwd_gemm_matches_plain(cuda, dtype, epilogue, m, n, k, sliced):
    """The wgmma/TMA GEMM's backward epilogues against their plain twins:
    ``"bias_f32"`` with W [K, N], the others with W^T read K-major from W
    [N, K] as it is stored; N of 8, 120 and 136 (one ragged 128-wide tile),
    ragged M, K3's and K4's text-tower shapes; ``sliced`` reads W as a
    column slice of a wider weight and writes C into a column slice of a
    wider buffer. fp32 outputs are held at the input dtype's tolerance."""
    gen = torch.Generator().manual_seed(m + 3 * n + k)
    a = torch.randn(m, k, generator=gen).to(cuda, dtype)
    rows, cols = (k, n) if epilogue == "bias_f32" else (n, k)
    w_full = (torch.randn(rows, cols + (24 if sliced else 0), generator=gen)
              * k ** -0.5).to(cuda, dtype)
    w = w_full[:, 16:16 + cols] if sliced else w_full
    bias = (torch.randn(n, generator=gen) * 0.1).to(cuda, dtype) if epilogue == "bias_f32" else None
    h_pre = torch.randn(m, n, generator=gen).to(cuda) if epilogue == "gelu_grad" else None
    out_dtype = torch.float32 if epilogue in ("bias_f32", "f32") else dtype
    c_full = torch.randn(m, n + (40 if sliced else 0), generator=gen).to(cuda, out_dtype)
    c = c_full[:, 8:8 + n] if sliced else c_full
    before = c_full.clone()
    ref = block_gemm_bwd_plain(a, w, epilogue, bias=bias, h_pre=h_pre)
    cuda_lib.reset_launches()
    got = block_gemm_bwd(a, w, epilogue, bias=bias, h_pre=h_pre, out=c)
    assert got.data_ptr() == c.data_ptr() and cuda_lib.LAUNCHES["gemm_wgmma"] == 1
    if out_dtype == torch.float32:
        _check_partial(got, ref, dtype)
    else:
        _check(got, ref)
    if sliced:  # the columns beside the slice are untouched
        assert torch.equal(c_full[:, :8], before[:, :8])
        assert torch.equal(c_full[:, 8 + n:], before[:, 8 + n:])


def test_bwd_gemm_refuses_what_it_does_not_take(cuda):
    bf = torch.bfloat16
    a = torch.randn(9, 64, device=cuda, dtype=bf)
    w = torch.randn(128, 64, device=cuda, dtype=bf)  # [N, K]
    h = torch.randn(9, 128, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        block_gemm_bwd(a.float(), w.float(), "f32")
    with pytest.raises(ValueError, match=r"w must be \[N, 64\]"):
        block_gemm_bwd(a, w.t().contiguous(), "cast")
    with pytest.raises(ValueError, match="multiples of 8"):
        block_gemm_bwd(a, w[:100], "cast")
    with pytest.raises(ValueError, match="16-byte boundary"):  # TMA reads W from an aligned base
        block_gemm_bwd(a, torch.empty(128 * 72 + 4, device=cuda, dtype=bf)[4:].view(128, 72)
                       [:, :64], "cast")
    with pytest.raises(ValueError, match="needs a contiguous fp32 h_pre"):
        block_gemm_bwd(a, w, "gelu_grad")
    with pytest.raises(ValueError, match="h_pre must be torch.float32"):
        block_gemm_bwd(a, w, "gelu_grad", h_pre=h.to(bf))
    with pytest.raises(ValueError, match="8-byte aligned"):  # h_pre is read in fp32 pairs
        block_gemm_bwd(a, w, "gelu_grad", h_pre=torch.empty(9 * 128 + 1, device=cuda)[1:]
                       .view(9, 128))
    with pytest.raises(ValueError, match="takes no bias"):
        block_gemm_bwd(a, w, "cast", bias=torch.zeros(128, device=cuda, dtype=bf))
    with pytest.raises(ValueError, match="takes no h_pre"):
        block_gemm_bwd(a, w, "f32", h_pre=h)
    with pytest.raises(ValueError, match="needs a bias"):
        block_gemm_bwd(a, w.t().contiguous(), "bias_f32")
    with pytest.raises(RuntimeError, match="requires grad"):
        block_gemm_bwd(a, w.clone().requires_grad_(True), "cast")
    # the export's own refusals: W's rows closer than K, fp32, a misaligned A
    lib, out = cuda_lib.library("block_fused_bwd"), torch.empty(9, 128, device=cuda, dtype=bf)
    st = cuda_lib.stream_of(a)

    def export(code, a_ptr, ldw, epilogue=4):
        return lib.ovmr_gemm_wgmma_bwd(code, a_ptr, w.data_ptr(), None, None, out.data_ptr(),
                                       9, 128, 64, ldw, 128, epilogue, st)

    assert export(1, a.data_ptr(), 64) == 0
    torch.cuda.synchronize()
    assert export(1, a.data_ptr(), 56) != 0  # ldw < K
    assert export(0, a.data_ptr(), 64) != 0  # fp32 takes gemm.cuh's FMA GEMM
    assert export(1, a.data_ptr() + 2, 64) != 0
    assert export(1, a.data_ptr(), 64, epilogue=0) != 0  # a forward-only epilogue


def test_fp32_gemm_exports_refuse_half_precision(cuda):
    """gemm.cuh keeps only the fp32 FMA kernel: its exports refuse bf16 and
    fp16, and the wrappers raise on the refusal."""
    for dtype in (torch.bfloat16, torch.float16):
        code = cuda_lib.dtype_code(dtype)
        a = torch.randn(9, 64, device=cuda, dtype=dtype)
        w = torch.randn(64, 128, device=cuda, dtype=dtype)
        b = torch.randn(128, device=cuda, dtype=dtype)
        out = torch.empty(9, 128, device=cuda, dtype=dtype)
        st = cuda_lib.stream_of(a)
        with pytest.raises(RuntimeError, match="ovmr_gemm: CUDA error"):
            tbf._gemm(cuda_lib.library("block_fused"), code, a, w, b, out, 0, st)
        with pytest.raises(RuntimeError, match="ovmr_gemm_bwd: CUDA error"):
            lib = cuda_lib.library("block_fused_bwd")
            cuda_lib.check(lib, lib.ovmr_gemm_bwd(code, a.data_ptr(), w.t().contiguous().data_ptr(),
                                                  None, None, out.data_ptr(), 9, 128, 64, 4, st),
                           "ovmr_gemm_bwd")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,l,d,h,masked", [(3, 17, 64, 2, True), (2, 77, 512, 8, True),
                                            (2, 33, 40, 5, False), (1, 197, 768, 12, False)])
def test_k3_and_k4_launch_the_wgmma_gemm_in_half_precision(cuda, dtype, b, l, d, h, masked):
    """In bf16 and fp16 K3 runs its QKV recompute, dattn and dxln products
    on the wgmma GEMM (3 launches) and K4 its dh_pre (the c_fc recompute
    and the GELU' product in one launch) and dxln (2 launches), K3's core
    by length (one launch up to 128 tokens, else the tiled pair); fp32
    keeps gemm.cuh's FMA GEMM and the tiled FMA core. Each matches its
    plain twin."""
    p = _layer(d, dtype, cuda, seed=b * 7 + l)
    gen = torch.Generator().manual_seed(l + d)
    x = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    half = dtype != torch.float32
    route = "short" if half and l <= 128 else "tiled"
    a = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"], p["ln_s"], p["ln_b"])
    cuda_lib.reset_launches()
    _check(attn_half_bwd_dx(*a, mask=mask, n_head=h), attn_half_bwd_dx_plain(*a, mask=mask, n_head=h))
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (3 if half else 0)
    assert cuda_lib.LAUNCHES["attn_bwd_core_" + route] == 1
    assert cuda_lib.LAUNCHES["attn_bwd_core_short"] + cuda_lib.LAUNCHES["attn_bwd_core_tiled"] == 1
    m = (x, g, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["ln_s"], p["ln_b"])
    cuda_lib.reset_launches()
    _check(mlp_half_bwd_dx(*m), mlp_half_bwd_dx_plain(*m))
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == (2 if half else 0)
    assert cuda_lib.LAUNCHES["mlp_half_bwd_dx"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,l,d,hidden", [(3, 17, 64, 256), (2, 77, 512, 2048), (1, 9, 40, 120),
                                          (2, 33, 136, 136), (1, 577, 1024, 4096)])
def test_mlp_bwd_dh_is_the_pair_of_launches_bit_for_bit(cuda, dtype, b, l, d, hidden):
    """K4's one-launch dh_pre (both products' accumulators in registers,
    h_pre never stored) equals the "bias_f32" and "gelu_grad" launches bit
    for bit (same instruction shapes, same k order, the same fp32
    arithmetic) and its plain twin within two units in the last place; N of
    120 and 136 leave a ragged 128-wide tile."""
    gen = torch.Generator().manual_seed(b * l + hidden)
    xln, g = (torch.randn(b, l, d, generator=gen).to(cuda, dtype) for _ in range(2))
    c_fc_w = (torch.randn(d, hidden, generator=gen) * d ** -0.5).to(cuda, dtype)
    c_fc_b = (torch.randn(hidden, generator=gen) * 0.1).to(cuda, dtype)
    c_proj_w = (torch.randn(hidden, d, generator=gen) * hidden ** -0.5).to(cuda, dtype)
    cuda_lib.reset_launches()
    got = mlp_bwd_dh(xln, c_fc_w, c_fc_b, g, c_proj_w)
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == 1
    h_pre = block_gemm_bwd(xln, c_fc_w, "bias_f32", bias=c_fc_b)
    pair = block_gemm_bwd(g, c_proj_w, "gelu_grad", h_pre=h_pre)
    torch.cuda.synchronize()
    assert torch.equal(got, pair)
    _check(got, mlp_bwd_dh_plain(xln, c_fc_w, c_fc_b, g, c_proj_w))
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        mlp_bwd_dh(xln.float(), c_fc_w.float(), c_fc_b.float(), g.float(), c_proj_w.float())
    with pytest.raises(ValueError, match="c_proj_w has shape"):
        mlp_bwd_dh(xln, c_fc_w, c_fc_b, g, c_proj_w[:8])


def _block_params(d, dtype, device, seed):
    p = _layer(d, dtype, device, seed)
    p.update(ln_1_scale=p["ln_s"], ln_1_bias=p["ln_b"],
             ln_2_scale=p["ln_s"].flip(0).contiguous(), ln_2_bias=p["ln_b"].flip(0).contiguous())
    return {k: p[k] for k in BLOCK_KEYS}


def test_raw_wrappers_refuse_a_tensor_that_requires_grad(cuda):
    """A raw wrapper records no autograd graph: on the card it raises for
    a tracked tensor instead of dropping the gradient silently."""
    p = _block_params(64, torch.float32, cuda, seed=1)
    x = torch.randn(2, 9, 64, device=cuda, requires_grad=True)
    a = (p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_1_scale"], p["ln_1_bias"])
    m = (p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_2_scale"], p["ln_2_bias"])
    q = torch.randn(2, 1, 9, 64, device=cuda, requires_grad=True)
    g = torch.randn(2, 9, 64, device=cuda)
    calls = [
        lambda: fused_attn_half(x, *a, n_head=1),
        lambda: fused_mlp_half(x, *m),
        lambda: fused_mlp_half_chunked(x, *m, chunks=2),
        lambda: fused_attention_kernel(q, q, q),
        lambda: attn_half_bwd_dx(x, g, *a[:3], *a[4:], n_head=1),
        lambda: mlp_half_bwd_dx(x, g, *m[:3], *m[4:]),
        # a frozen input but a weight that trains
        lambda: fused_mlp_half(x.detach(), m[0].clone().requires_grad_(True), *m[1:]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    with torch.no_grad():
        for call in calls:
            assert not call().requires_grad


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("train_weights", [False, True])
def test_fused_block_gradients_on_card_match_cpu(cuda, masked, train_weights):
    """fused_residual_block on the card (K1, K2 forward; K4, K3 backward)
    gives the CPU's (plain twins') gradients, through two stacked layers and
    with a strided cotangent."""
    b, l, d, h = 3, 17, 64, 2
    layers = [_block_params(d, torch.float32, "cpu", seed=s) for s in (2, 3)]
    x0 = torch.randn(b, l, d, generator=torch.Generator().manual_seed(5))
    results = {}
    for device in ("cpu", cuda):
        ps = [{k: v.clone().to(device).requires_grad_(train_weights) for k, v in p.items()}
              for p in layers]
        x = x0.clone().to(device).requires_grad_(True)
        mask = causal_mask(l, device=device) if masked else None
        cuda_lib.reset_launches()
        y = x
        for p in ps:
            y = fused_residual_block(y, p, h, mask)
        assert y.grad_fn is not None
        # transpose makes the cotangent reaching the Function strided
        (y.transpose(0, 1) ** 2).sum().backward()
        if device != "cpu":
            k3 = "attn_half_bwd_dx_masked" if masked else "attn_half_bwd_dx"
            assert cuda_lib.LAUNCHES[k3] == 2 and cuda_lib.LAUNCHES["mlp_half_bwd_dx"] == 2
        results[str(device)] = [x.grad.cpu()] + [
            p[k].grad.cpu() for p in ps for k in BLOCK_KEYS if train_weights
        ]
    for got, ref in zip(results["cuda"], results["cpu"]):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("masked", [False, True])
def test_fused_attention_gradients_on_card_match_cpu(cuda, masked):
    """K6 through its autograd wrapper: K6 forward on the card, dq, dk, dv
    equal to the CPU's."""
    gen = torch.Generator().manual_seed(9)
    qkv = [torch.randn(3, 2, 18, 64, generator=gen) for _ in range(3)]
    results = {}
    for device in ("cpu", cuda):
        leaves = [t.clone().to(device).requires_grad_(True) for t in qkv]
        mask = causal_mask(18, device=device) if masked else None
        cuda_lib.reset_launches()
        out = fused_attention(*leaves, mask)
        assert out.grad_fn is not None
        if device != "cpu":
            assert cuda_lib.LAUNCHES["fused_attention"] == 1
        (out ** 2).sum().backward()
        results[str(device)] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, ref in zip(results["cuda"], results["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-4 * max(float(ref.abs().max()), 1.0)


def test_train_step_on_card_matches_cpu(cuda):
    """One TINY fp32 training step at dropout 0 on the card (K1-K4 and K6
    through their autograd entries) against the CPU (plain twins). SGD, whose
    update is linear in the gradient, so every element is comparable."""
    from ovmr_tpu_torch.engine.optimizers import param_leaves
    from ovmr_tpu_torch.engine.train_step import make_train_step
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator
    from ovmr_tpu_torch.models.ovmr import build_prompt_tokens

    cp = tclip.init_params(tclip.TINY, seed=0)
    ap = init_aggregator(width=64, layers=2, n_ctx=2, seed=0)
    rng = np.random.RandomState(1)
    images = torch.tensor(
        (rng.rand(3, 1, 3, 32, 32) + 0.3 * rng.rand(3, 4, 3, 32, 32)).astype(np.float32)
    )
    ptok, eot, vtok = (torch.tensor(a) for a in build_prompt_tokens(["circle", "square", "cross"]))
    step = make_train_step(tclip.TINY, dropout=0.0)
    results = {}
    for device in ("cpu", cuda):
        agg = {"blocks": {k: v.clone().to(device).requires_grad_(True)
                          for k, v in ap["blocks"].items()},
               "cls_token": ap["cls_token"].clone().to(device).requires_grad_(True)}
        optimizer = torch.optim.SGD(param_leaves(agg), lr=0.05, momentum=0.9)
        cuda_lib.reset_launches()
        loss = step(agg, optimizer, tclip.tree_to(cp, device=device), images.to(device),
                    ptok.to(device), eot.to(device), vtok.to(device), None, 2)
        if device != "cpu":
            assert cuda_lib.LAUNCHES == {
                "fused_attn_half": 4, "fused_attn_half_masked": 4, "attn_core": 8,
                "fused_mlp_half": 8,
                "fused_mlp_half_chunked": 0, "fused_attention": 2, "attn_half_bwd_dx": 0, "attn_half_bwd_dx_masked": 4,
                "mlp_half_bwd_dx": 4, "tp_attn_half_partial": 0, "tp_attn_half_partial_masked": 0,
                "tp_mlp_half_partial": 0, "gemm_wgmma": 0,
                "attn_bwd_core_short": 0, "attn_bwd_core_tiled": 4,
            }, cuda_lib.LAUNCHES
        results[str(device)] = [loss.cpu()] + [leaf.detach().cpu() for leaf in param_leaves(agg)]
    for got, ref in zip(results["cuda"], results["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-5
    moved = (results["cpu"][-1] - ap["cls_token"]).abs().max()
    assert float(moved) > 1e-4


def test_fused_block_routes_vit_l_336_through_the_chunked_half(cuda):
    """A layer of ViT-L/14@336px's vision tower runs K1 and
    K5 in 2 chunks and equals the plain halves; its backward runs K4 then
    K3 (the tiled core at 577 tokens) and equals the plain dx twins on the
    same saved activations."""
    d, l = 1024, 577
    p = _block_params(d, torch.bfloat16, cuda, seed=4)
    x = torch.randn(2, l, d, generator=torch.Generator().manual_seed(1)).to(cuda, torch.bfloat16)
    cuda_lib.reset_launches()
    with torch.no_grad():
        got = fused_residual_block(x, p, 16)
    assert cuda_lib.LAUNCHES["fused_mlp_half_chunked"] == 1
    assert cuda_lib.LAUNCHES["fused_mlp_half"] == 0 and cuda_lib.LAUNCHES["fused_attn_half"] == 1
    y = fused_attn_half_plain(x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"],
                              p["ln_1_scale"], p["ln_1_bias"], n_head=16)
    ref = fused_mlp_half_chunked_plain(y, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"],
                                       p["ln_2_scale"], p["ln_2_bias"], chunks=2)
    # two halves: twice one half's rounding allowance
    torch.cuda.synchronize()
    peak = max(float(ref.abs().max()), 1.0)
    assert float((got.float() - ref.float()).abs().max()) <= 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    xg = x.clone().requires_grad_(True)
    g = torch.randn(2, l, d, generator=torch.Generator().manual_seed(2)).to(cuda, torch.bfloat16)
    cuda_lib.reset_launches()
    (dx,) = torch.autograd.grad(fused_residual_block(xg, p, 16), xg, g)
    assert cuda_lib.LAUNCHES["mlp_half_bwd_dx"] == 1 and cuda_lib.LAUNCHES["attn_half_bwd_dx"] == 1
    with torch.no_grad():
        y_k = fused_attn_half(x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"],
                              p["ln_1_scale"], p["ln_1_bias"], n_head=16)
    dy = mlp_half_bwd_dx_plain(y_k, g, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"],
                               p["ln_2_scale"], p["ln_2_bias"])
    ref = attn_half_bwd_dx_plain(x, dy, p["w_qkv"], p["b_qkv"], p["w_out"],
                                 p["ln_1_scale"], p["ln_1_bias"], n_head=16)
    torch.cuda.synchronize()
    peak = max(float(ref.abs().max()), 1.0)
    assert float((dx.float() - ref.float()).abs().max()) <= 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)


def test_fused_block_after_k5_gradients_on_card_match_cpu(cuda, monkeypatch):
    """fp32, a block sent through K5 (the thresholds at zero) at a vision
    tower's 197 tokens: dx on the card (K4, then K3's tiled FMA core) equals
    the CPU's within 1e-4 of its scale."""
    import ovmr_tpu_torch.ops.block_fused as tbf

    monkeypatch.setattr(tbf, "_MLP_W_CUTOFF", 0)
    monkeypatch.setattr(tbf, "_MLP_W_RESIDENT_FWD", 0)
    b, l, d, h = 2, 197, 64, 2
    p0 = _block_params(d, torch.float32, "cpu", seed=6)
    x0 = torch.randn(b, l, d, generator=torch.Generator().manual_seed(7))
    grads = {}
    for device in ("cpu", cuda):
        x = x0.clone().to(device).requires_grad_(True)
        p = {k: v.to(device) for k, v in p0.items()}
        cuda_lib.reset_launches()
        (fused_residual_block(x, p, h) ** 2).sum().backward()
        if device != "cpu":
            assert cuda_lib.LAUNCHES["fused_mlp_half_chunked"] == 1
            assert cuda_lib.LAUNCHES["attn_half_bwd_dx"] == 1
        grads[str(device)] = x.grad.cpu()
    scale = max(float(grads["cpu"].abs().max()), 1.0)
    assert float((grads["cuda"] - grads["cpu"]).abs().max()) <= 1e-4 * scale


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
    # serving launches every forward kernel of a TINY tower (its MLP half is
    # K2, not the chunked K5) and no backward (nor K3's core) or
    # tensor-parallel one
    for name, count in cuda_lib.LAUNCHES.items():
        # (nor, at fp32, the bf16/fp16 wgmma GEMM)
        idle = (name.endswith(("bwd_dx", "bwd_dx_masked")) or name == "fused_mlp_half_chunked"
                or name.startswith(("tp_", "attn_bwd_core")) or name == "gemm_wgmma")
        assert (count == 0) == idle, cuda_lib.LAUNCHES
    cpu = OVMRGenerator(cp, tclip.TINY, ap, dtype=torch.float32, device="cpu").generate(names, images)
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "visual_tokens"):
        np.testing.assert_allclose(gpu[key], cpu[key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(gpu["fusion_weight"], cpu["fusion_weight"], atol=1e-3)


# ---------------------------------------------------------------------------
# tensor parallelism: K7, K8 and the TP block
# ---------------------------------------------------------------------------


def _tp_shard(d, dl, hl, dtype, device, seed, zero_heads=False):
    """One shard's tensors; ``zero_heads``: the q/k/v/out weights of an
    all-zero padded head shard."""
    g = torch.Generator().manual_seed(seed)

    def r(*s, std, pad=False):
        t = torch.randn(*s, generator=g) * std
        return (t * 0 if pad and zero_heads else t).to(device, dtype)

    return {
        "w_q": r(d, dl, std=d ** -0.5, pad=True), "b_q": r(dl, std=0.02, pad=True),
        "w_k": r(d, dl, std=d ** -0.5, pad=True), "b_k": r(dl, std=0.02, pad=True),
        "w_v": r(d, dl, std=d ** -0.5, pad=True), "b_v": r(dl, std=0.02, pad=True),
        "w_out": r(dl, d, std=dl ** -0.5, pad=True),
        "ln_s": 1 + r(d, std=0.1), "ln_b": r(d, std=0.1),
        "c_fc_w": r(d, hl, std=d ** -0.5), "c_fc_b": r(hl, std=0.02),
        "c_proj_w": r(hl, d, std=hl ** -0.5),
    }


def _check_partial(got, ref, dtype):
    """An fp32 partial against its plain twin, at the tolerance of the
    input dtype (bf16/fp16 heads or hidden values may round to neighbours)."""
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    peak = max(float(ref.abs().max()), 1.0)
    bits = MANTISSA[dtype]
    tol = 1e-5 * peak if bits is None else 2.0 * 2.0 ** (math.floor(math.log2(peak)) - bits)
    err = float((got - ref).abs().max())
    assert err <= tol, (err, tol)


def _k7_args(x, s):
    return (x, s["w_q"], s["b_q"], s["w_k"], s["b_k"], s["w_v"], s["b_v"], s["w_out"],
            s["ln_s"], s["ln_b"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,l,d,dl,nh,hl",
    [(2, 77, 512, 64, 1, 256), (2, 197, 512, 128, 2, 512), (3, 77, 768, 384, 6, 1536),
     (2, 197, 768, 384, 6, 1536), (1, 577, 1024, 512, 8, 2048), (2, 33, 40, 16, 2, 80)],
)
def test_tp_partials_match_plain(cuda, dtype, masked, b, l, d, dl, nh, hl):
    """K7 and K8 against their plain twins at the shard widths of model
    axis 2 (ViT-L/14@336px: text dl 384 / hl 1536, vision dl 512 / hl 2048;
    ViT-B/16 vision 384) and at 64 and 128, at 77, 197 and 577 tokens."""
    s = _tp_shard(d, dl, hl, dtype, cuda, seed=b * 1000 + l)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    cuda_lib.reset_launches()
    a = _k7_args(x, s)
    _check_partial(tbtp.tp_attn_half_partial(*a, mask=mask, n_head=nh),
                   tbtp.tp_attn_half_partial_plain(*a, mask=mask, n_head=nh), dtype)
    m = (x, s["c_fc_w"], s["c_fc_b"], s["c_proj_w"], s["ln_s"], s["ln_b"])
    _check_partial(tbtp.tp_mlp_half_partial(*m), tbtp.tp_mlp_half_partial_plain(*m), dtype)
    k7 = "tp_attn_half_partial_masked" if masked else "tp_attn_half_partial"
    assert cuda_lib.LAUNCHES[k7] == 1 and cuda_lib.LAUNCHES["tp_mlp_half_partial"] == 1
    assert cuda_lib.LAUNCH_SHAPES[(k7, (b, l, d, dl), str(dtype).removeprefix("torch."))] == 1
    assert cuda_lib.LAUNCH_SHAPES[("tp_mlp_half_partial", (b, l, d, hl),
                                   str(dtype).removeprefix("torch."))] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,l,d,dl,nh", [(2, 77, 768, 384, 6), (1, 577, 1024, 512, 8),
                                         (2, 17, 64, 64, 1)])
def test_tp_padded_shard_gives_exact_zeros(cuda, dtype, masked, b, l, d, dl, nh):
    """A shard of zero-padded heads (split_clip_qkv's padding) contributes
    an exact 0, masked or not."""
    s = _tp_shard(d, dl, 4 * d, dtype, cuda, seed=l, zero_heads=True)
    x = torch.randn(b, l, d, generator=torch.Generator().manual_seed(l)).to(cuda, dtype)
    mask = causal_mask(l, device=cuda) if masked else None
    got = tbtp.tp_attn_half_partial(*_k7_args(x, s), mask=mask, n_head=nh)
    torch.cuda.synchronize()
    assert got.shape == (b, l, d) and bool((got == 0).all())


def test_tp_raw_wrappers_refuse_a_tensor_that_requires_grad(cuda):
    s = _tp_shard(64, 64, 256, torch.float32, cuda, seed=1)
    x = torch.randn(2, 9, 64, device=cuda, requires_grad=True)
    calls = [
        lambda: tbtp.tp_attn_half_partial(*_k7_args(x, s), n_head=1),
        lambda: tbtp.tp_mlp_half_partial(x, s["c_fc_w"], s["c_fc_b"], s["c_proj_w"],
                                         s["ln_s"], s["ln_b"]),
        lambda: tbtp.tp_mlp_half_partial(x.detach(), s["c_fc_w"].clone().requires_grad_(True),
                                         s["c_fc_b"], s["c_proj_w"], s["ln_s"], s["ln_b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    with torch.no_grad():
        for call in calls:
            assert not call().requires_grad


def _tp_layer(m, n_head, seed):
    """One TINY_TP vision layer (D 128, 2 heads of 64), split, head-padded
    for ``m`` and placed as local shards, on the CPU."""
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.parallel import ModelAxis, shard_block

    cp = tclip.init_params(tclip.TINY_TP, seed=seed)
    p = {k: v[0] for k, v in cp["visual"]["blocks"].items()}
    g = torch.Generator().manual_seed(seed)
    for k in ("b_qkv", "b_out", "c_fc_b", "c_proj_b", "ln_1_bias", "ln_2_bias"):
        p[k] = 0.05 * torch.randn(p[k].shape, generator=g)
    sp = tbtp.pad_head_shards(tbtp.split_qkv_blocks(p), 128 // n_head, m)
    axis = ModelAxis.local(m)
    return axis, shard_block(sp, axis, stacked=False)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_tp_block_gradients_on_card_match_cpu(cuda, m, masked):
    """The TP block (local shards, m=2 and head-padded m=4) on the card (K7,
    K8 forward) against the CPU (plain twins): output, dx and every weight
    gradient within 1e-4 of their scale, through two stacked layers."""
    n_head = 2
    layers = [_tp_layer(m, n_head, seed) for seed in (0, 1)]
    axis = layers[0][0]
    block = tbtp.make_tp_block(axis)
    x0 = torch.randn(3, 17, 128, generator=torch.Generator().manual_seed(5))
    results = {}
    for device in ("cpu", cuda):
        ps = [{k: v.clone().to(device).requires_grad_(True) for k, v in p.items()}
              for _, p in layers]
        x = x0.clone().to(device).requires_grad_(True)
        mask = causal_mask(17, device=device) if masked else None
        cuda_lib.reset_launches()
        y = x
        for p in ps:
            y = block(y, p, n_head, mask)
        (y.transpose(0, 1) ** 2).sum().backward()
        if device != "cpu":
            k7 = "tp_attn_half_partial_masked" if masked else "tp_attn_half_partial"
            assert cuda_lib.LAUNCHES[k7] == 2 * m and cuda_lib.LAUNCHES["tp_mlp_half_partial"] == 2 * m
        results[str(device)] = [y.detach().cpu(), x.grad.cpu()] + [
            p[k].grad.cpu() for p in ps for k in tbtp.TP_KEYS]
    for got, ref in zip(results["cuda"], results["cpu"]):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) <= 1e-4 * scale


def test_tp_block_takes_the_kernels_at_every_shard_size(cuda):
    """One shard at ViT-L/14's width (the axis a one-rank process group
    gives): its MLP weights, 16 MiB in bf16, are above the TPU module's
    residency cutoff, and the card still runs K7 and K8 for it, matching the
    CPU within 1e-4 of the output's scale."""
    from ovmr_tpu_torch.parallel import ModelAxis, shard_block

    d, n_head = 1024, 16
    s = _tp_shard(d, d, 4 * d, torch.float32, "cpu", seed=7)
    g = torch.Generator().manual_seed(8)
    p = {k: s[k] for k in ("w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_out",
                           "c_fc_w", "c_fc_b", "c_proj_w")}
    p.update(ln_1_scale=s["ln_s"], ln_1_bias=s["ln_b"],
             ln_2_scale=1 + 0.1 * torch.randn(d, generator=g), ln_2_bias=0.1 * torch.randn(d, generator=g),
             b_out=0.02 * torch.randn(d, generator=g), c_proj_b=0.02 * torch.randn(d, generator=g))
    axis = ModelAxis.local(1)
    p = shard_block(p, axis, stacked=False)
    block = tbtp.make_tp_block(axis)
    x = torch.randn(2, 17, d, generator=g)
    ref = block(x, p, n_head)
    cuda_lib.reset_launches()
    with torch.no_grad():
        got = block(x.to(cuda), {k: v.to(cuda) for k, v in p.items()}, n_head)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCH_SHAPES == {
        ("tp_attn_half_partial", (2, 17, d, d), "float32"): 1,
        ("attn_core", (2, 17, d, n_head), "float32"): 1,
        ("tp_mlp_half_partial", (2, 17, d, 4 * d), "float32"): 1,
    }, cuda_lib.LAUNCH_SHAPES
    assert float((got.cpu() - ref).abs().max()) <= 1e-4 * max(float(ref.abs().max()), 1.0)


def test_mm_cls_op_trainer_on_card(cuda, tmp_path, monkeypatch):
    """MM_CLS_OP at TINY through ``build_trainer`` on the card in fp32: one
    epoch of two steps launches K1/K2/K4/K3 at the exact per-step counts,
    the loss is finite and the checkpoint is written; then the fusion eval
    on the card against the same weights on the CPU (classifiers 1e-4,
    fusion weights 1e-3)."""
    from ovmr_tpu_torch.engine.trainer import build_trainer
    from ovmr_tpu_torch.utils import get_cfg_default

    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")

    def cfg_for(device, out):
        cfg = get_cfg_default()
        cfg.merge_from_list([
            "OUTPUT_DIR", str(tmp_path / out), "SEED", "1",
            "DATASET.ROOT", str(tmp_path / "data"), "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", "4", "INPUT.SIZE", "(32, 32)",
            "INPUT.TRANSFORMS", "['normalize']",
            "DATALOADER.TRAIN_X.SAMPLER", "RandomClassSampler",
            "DATALOADER.TRAIN_X.BATCH_SIZE", "8", "DATALOADER.TRAIN_X.N_INS", "4",
            "DATALOADER.TEST.BATCH_SIZE", "8", "DATALOADER.NUM_WORKERS", "2",
            "MODEL.BACKBONE.NAME", "TINY", "TRAINER.NAME", "MM_CLS_OP",
            "TRAINER.COCOOP.N_CTX", "2", "OPTIM.MAX_EPOCH", "1", "TEST.NO_TEST", "True",
            "EVAL_MODE", "fusion", "CUDA.DTYPE", "float32", "CUDA.DEVICE", device,
        ])
        return cfg

    card = build_trainer(cfg_for("cuda", "card"))
    losses = []
    orig = card.forward_backward

    def fb(batch):
        out = orig(batch)
        losses.append(out["loss"])
        return out

    monkeypatch.setattr(card, "forward_backward", fb)
    cuda_lib.reset_launches()
    card.train()
    torch.cuda.synchronize()
    steps = len(losses)
    assert steps == 2 and all(math.isfinite(v) for v in losses)
    v_layers, t_layers = card.clip_cfg.vision_layers, card.clip_cfg.transformer_layers
    per_step = {"fused_attn_half": 2 * v_layers, "fused_attn_half_masked": 2 * t_layers,
                "fused_mlp_half": 2 * (v_layers + t_layers), "mlp_half_bwd_dx": 2 * t_layers,
                "attn_half_bwd_dx_masked": 2 * t_layers, "attn_half_bwd_dx": 0,
                "fused_attention": 0}
    for key, n in per_step.items():
        assert cuda_lib.LAUNCHES[key] == steps * n, (key, dict(cuda_lib.LAUNCHES))
    pl = tmp_path / "card" / "prompt_learner"
    assert (pl / "model-1.npz").is_file() and (pl / "model.pth.tar-1").is_file()

    cpu = build_trainer(cfg_for("cpu", "cpu"))
    cpu.load_model(str(tmp_path / "card"), epoch=1)
    card.test()
    cpu.test()
    got = torch.load(tmp_path / "card" / "mm_classifiers.pt", weights_only=False)
    want = torch.load(tmp_path / "cpu" / "mm_classifiers.pt", weights_only=False)
    assert sorted(got) == sorted(want)
    for key in ("mm_classifier", "vision_classifier", "text_classifier"):
        torch.testing.assert_close(got[key], want[key], atol=1e-4, rtol=0)
    torch.testing.assert_close(got["fusion_weight"], want["fusion_weight"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_augment_batch_on_card_matches_cpu(cuda, out_dtype, layout):
    """``augment_batch`` on the card against the CPU with the same draws
    (made on the CPU and moved), at one batch of 8 x 256² -> 224: the crop's
    two products sum two exact products per output, so they agree bit for
    bit once the weights do; the jitter's transcendentals and means differ
    in the last bits."""
    from ovmr_tpu_torch.ops.augment import augment_batch, sample_augment_draws

    draws = sample_augment_draws(torch.Generator().manual_seed(0), 8, 256, out_size=224)
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (8, 256, 256, 3))
                            .astype(np.uint8))
    ref = augment_batch(imgs, draws, out_size=224, out_dtype=out_dtype, out_layout=layout)
    got = augment_batch(imgs.to(cuda), {k: None if v is None else v.to(cuda)
                                        for k, v in draws.items()},
                        out_size=224, out_dtype=out_dtype, out_layout=layout)
    assert got.device.type == "cuda"
    _check(got.cpu(), ref)


@pytest.mark.parametrize("shape", [(4, 300, 400, 3), (4, 400, 300, 3), (4, 256, 256, 3)])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_preprocess_batch_on_card_matches_cpu(cuda, shape, method):
    """``preprocess_batch`` (``F.interpolate`` with antialias) on the card
    against the CPU, fp32, within 1e-4: CUDA's antialiased resampling
    computes and sums its filter taps in another order than the CPU's
    (up to ~5e-5 after the division by the std), the tolerance of the
    CPU's parity with ``jax.image.resize``."""
    from ovmr_tpu_torch.ops.preprocess import preprocess_batch

    imgs = torch.from_numpy(np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8))
    ref = preprocess_batch(imgs, size=224, method=method, out_dtype=torch.float32)
    got = preprocess_batch(imgs.to(cuda), size=224, method=method, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_text_halves_at_the_imagenet_stage2_shape(cuda, dtype):
    """K1-causal, K2, K3-causal and K4 at CoOp's one-prompt step over
    ImageNet's 1000 classes (1000 prompts x 77 x 512, 8 heads)."""
    b, l, d, h = 1000, 77, 512, 8
    p = _layer(d, dtype, cuda, seed=1000)
    gen = torch.Generator().manual_seed(1000)
    x = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, l, d, generator=gen).to(cuda, dtype)
    mask = causal_mask(l, device=cuda)
    cuda_lib.reset_launches()
    a = (x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_s"], p["ln_b"])
    _check(fused_attn_half(*a, mask=mask, n_head=h), fused_attn_half_plain(*a, mask=mask, n_head=h))
    m = (x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_s"], p["ln_b"])
    _check(fused_mlp_half(*m), fused_mlp_half_plain(*m))
    a3 = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"], p["ln_s"], p["ln_b"])
    _check(attn_half_bwd_dx(*a3, mask=mask, n_head=h),
           attn_half_bwd_dx_plain(*a3, mask=mask, n_head=h))
    m4 = (x, g, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["ln_s"], p["ln_b"])
    _check(mlp_half_bwd_dx(*m4), mlp_half_bwd_dx_plain(*m4))
    for key in ("fused_attn_half_masked", "fused_mlp_half", "attn_half_bwd_dx_masked",
                "mlp_half_bwd_dx"):
        assert cuda_lib.LAUNCHES[key] == 1, key


@pytest.mark.parametrize("n_cls,prompt_ind", [(4, 0), (401, 1)])
def test_coop_step_on_card_matches_cpu(cuda, n_cls, prompt_ind):
    """One fp32 CoOp step at TINY (seeded random towers, zero vokens) on the
    card and on the CPU from the same ctx and batch: the loss within 1e-4,
    the ctx gradient within 1e-4 of its scale, and the launches of three
    prompts (one above 400 classes) exactly."""
    from ovmr_tpu_torch.engine.coop import CoOp
    from ovmr_tpu_torch.utils import get_cfg_default

    def build(device):
        cfg = get_cfg_default()
        cfg.merge_from_list(["MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
                             "TRAINER.COOP.N_CTX", "4", "OPTIM.NAME", "sgd", "OPTIM.LR", "0.002",
                             "CUDA.DTYPE", "float32", "CUDA.DEVICE", device, "SEED", "1"])
        t = CoOp.__new__(CoOp)
        t.cfg = cfg
        t.dm = type("DM", (), {"dataset": type("DS", (), {
            "classnames": [f"class {i}" for i in range(n_cls)]})()})()
        t.build_model()
        return t

    card, cpu = build("cuda"), build("cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(2, 3, 32, 32, generator=gen)
    labels = torch.tensor([1, 3])
    grads = []
    for t, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        ctx = t.params["ctx"]
        orig = t.optimizer.step
        t.optimizer.step = lambda orig=orig, ctx=ctx: (grads.append(ctx.grad.detach().cpu()), orig())
        cuda_lib.reset_launches()
        loss, _ = t.train_step(images.to(dev), labels.to(dev), prompt_ind)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            prompts = 1 if n_cls > 400 else 3
            v, tl = card.clip_cfg.vision_layers, card.clip_cfg.transformer_layers
            want = {"fused_attn_half": v, "fused_attn_half_masked": prompts * tl,
                    "fused_mlp_half": v + prompts * tl, "attn_half_bwd_dx_masked": prompts * tl,
                    "mlp_half_bwd_dx": prompts * tl, "attn_half_bwd_dx": 0, "gemm_wgmma": 0}
            for key, n in want.items():
                assert cuda_lib.LAUNCHES[key] == n, (key, dict(cuda_lib.LAUNCHES))
            card_loss = float(loss)
        else:
            assert abs(card_loss - float(loss)) <= 1e-4, (card_loss, float(loss))
    scale = max(float(grads[1].abs().max()), 1e-12)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-4 * scale
    torch.testing.assert_close(card.params["ctx"].detach().cpu(), cpu.params["ctx"].detach(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_clip_compat_half_on_card_matches_cpu(cuda, dtype, tmp_path, monkeypatch):
    """``clip_compat.load("TINY")`` (seeded random towers) in fp16 and bf16:
    both towers run K1/K2 on the card (exact launches: vision and text
    layers once each), and the features and fp32 logits agree with the same
    dtype's plain versions on the CPU within 8 units in the last place at
    their largest magnitude (two towers of two blocks, each rounding apart;
    for the logits, the largest they can take, exp(logit_scale))."""
    from ovmr_tpu_torch import clip_compat

    monkeypatch.delenv("OVMR_CLIP_CKPT", raising=False)
    card, _ = clip_compat.load("TINY", download_root=str(tmp_path), dtype=dtype, seed=5)
    cpu, _ = clip_compat.load("TINY", download_root=str(tmp_path), dtype=dtype, seed=5,
                              device="cpu")
    images = np.random.default_rng(0).standard_normal((3, 3, 32, 32)).astype(np.float32)
    tokens = clip_compat.tokenize(["a photo of a cat", "a dog", "a red panda on a tree"])
    cuda_lib.reset_launches()
    lpi, _ = card(images, tokens)
    torch.cuda.synchronize()
    v, t = card.cfg.vision_layers, card.cfg.transformer_layers
    want = {"fused_attn_half": v, "fused_attn_half_masked": t, "fused_mlp_half": v + t,
            "attn_core": v + t, "gemm_wgmma": 4 * (v + t)}
    assert {k: cuda_lib.LAUNCHES[k] for k in want} == want, dict(cuda_lib.LAUNCHES)
    bits = MANTISSA[dtype]

    def close(got, ref, peak=None):
        got, ref = got.float().cpu(), ref.float()
        peak = max(float(ref.abs().max()), 2.0 ** -10) if peak is None else peak
        tol = 8.0 * 2.0 ** (math.floor(math.log2(peak)) - bits)
        err = float((got - ref).abs().max())
        assert err <= tol, (err, tol)

    close(card.encode_image(images), cpu.encode_image(images))
    close(card.encode_text(tokens), cpu.encode_text(tokens))
    ref, _ = cpu(images, tokens)
    assert lpi.dtype == torch.float32 and bool(torch.isfinite(lpi).all())
    close(lpi, ref, peak=float(cpu.logit_scale.exp()))


# ---------------------------------------------------------------------------
# the ModifiedResNet tower and int8 serving on the card
# ---------------------------------------------------------------------------

def test_resnet_encode_fp32_on_card_matches_cpu(cuda, monkeypatch):
    """A fp32 ``TINY_RN`` tower on the card against the CPU within 1e-5 of
    the output's scale: cuDNN's TF32 is off inside the tower (each
    convolution sees it off) and back to its value after it."""
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models import resnet as tresnet

    seen = []
    orig = tresnet.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tresnet, "conv2d", spy)
    before = torch.backends.cudnn.allow_tf32
    params = tclip.init_params(tclip.TINY_RN, seed=3)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 96, 64))
                              .astype(np.float32))
    ref = tclip.encode_image(params, tclip.TINY_RN, images)
    seen.clear()
    got = tclip.encode_image(tclip.tree_to(params, device=cuda), tclip.TINY_RN, images.to(cuda))
    assert seen and not any(seen) and torch.backends.cudnn.allow_tf32 == before
    _check(got.cpu(), ref)


@pytest.mark.parametrize("rows,k,n", [(788, 768, 2304), (788, 3072, 768), (5, 768, 768)])
def test_dense_int8_on_card_is_exact(cuda, rows, k, n):
    """ViT-B/16's block shapes (4 images x 197 tokens) and a 5-row input:
    on the same fp32 input the card's int8 activations and scales equal the
    CPU's (a product with the float32 reciprocal of 127 and a division by a
    tensor, each correctly rounded on both), its int32 products are the
    CPU's exactly, and the output is within 1e-6 of its scale."""
    from ovmr_tpu_torch.ops import quant

    rng = np.random.default_rng(rows + k)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
    q, s = quant.quantize_weight(rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5)
    q, s = torch.from_numpy(q), torch.from_numpy(s)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xq, xs = quant.quantize_rows(x)
    xq_c, xs_c = quant.quantize_rows(x.to(cuda))
    assert torch.equal(xq_c.cpu(), xq) and torch.equal(xs_c.cpu(), xs)
    assert torch.equal(quant.int_mm(xq_c, q.to(cuda)).cpu(), quant.int_mm(xq, q))
    ref = quant.dense_int8(x, q, s, b)
    got = quant.dense_int8(x.to(cuda), q.to(cuda), s.to(cuda), b.to(cuda)).cpu()
    peak = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= 1e-6 * peak


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (16, 768, 768), (17, 60, 20), (40, 100, 7),
                                   (17, 64, 768), (20, 64, 192), (308, 96, 2304)])
def test_int_mm_pads_rows_on_card(cuda, m, k, n):
    """The card's integer GEMM takes a depth and width that are multiples
    of 8, and below a depth of 128 rows that are a multiple of 32 (cuBLASLt
    refuses 17 x 64 x 768 and 20 x 64 x 192 as they are); ``int_mm`` pads
    with zeros and the int32 result is the exact product."""
    from ovmr_tpu_torch.ops import quant

    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = quant.int_mm(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.cpu().numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_int8_block_on_card_takes_torch_math(cuda):
    """An int8 TINY layer through ``fused_residual_block`` on the card: no
    kernel launches (the route sends it to torch math), and fp32 output
    within 1e-3 of its scale of the CPU's: an activation on a rounding
    boundary of the per-row quantizer may round to the neighbouring int8
    step on one device (the product itself is exact)."""
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import quant

    params = quant.quantize_params(tclip.init_params(tclip.TINY, seed=1))
    p = {k: v[0] for k, v in params["visual"]["blocks"].items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 5, 64)).astype(np.float32))
    ref = fused_residual_block(x, p, 1)
    cuda_lib.reset_launches()
    got = fused_residual_block(x.to(cuda), {k: v.to(cuda) for k, v in p.items()}, 1)
    torch.cuda.synchronize()
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    peak = max(float(ref.abs().max()), 1.0)
    assert float((got.cpu() - ref).abs().max()) <= 1e-3 * peak


# ---------------------------------------------------------------------------
# the data axis on the card
# ---------------------------------------------------------------------------

def _tiny_step_inputs(device, n_cls=8, n_ins=4):
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator
    from ovmr_tpu_torch.models.ovmr import build_prompt_tokens

    towers = tclip.tree_to(tclip.init_params(tclip.TINY, seed=0), device=device)
    agg = init_aggregator(width=tclip.TINY.embed_dim, layers=2, n_ctx=2, seed=0)
    g = torch.Generator().manual_seed(1)
    images = torch.randn(n_cls, n_ins, 3, 32, 32, generator=g).to(device)
    tokens = build_prompt_tokens([f"class {i}" for i in range(n_cls)])
    return towers, agg, images, [torch.as_tensor(np.asarray(a), device=device) for a in tokens]


def _run_step(step, towers, agg, images, tokens):
    from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves
    from ovmr_tpu_torch.utils import get_cfg_default

    leaves = {k: v.detach().clone().to(images.device).requires_grad_(True)
              for k, v in agg["blocks"].items()}
    params = {"blocks": leaves,
              "cls_token": agg["cls_token"].detach().clone().to(images.device).requires_grad_(True)}
    ocfg = get_cfg_default().OPTIM
    ocfg.NAME, ocfg.LR, ocfg.MOMENTUM = "sgd", 0.05, 0.0
    loss = step(params, build_optimizer(ocfg, params), towers, images, *tokens, None, 2)
    torch.cuda.synchronize()
    return float(loss), [leaf.detach().clone() for leaf in param_leaves(params)]


def test_sharded_step_on_card_matches_the_single_program_step(cuda):
    """Two and four local data shards on the card (K1-K4 per shard, the
    classifiers gathered by ``torch.cat``), fp32 at TINY, against the
    single-program step on the card: the loss within 1e-5 and the updated
    aggregator within 1e-4; each shard launches the single step's kernels."""
    from ovmr_tpu_torch.engine.train_step import make_sharded_train_step, make_train_step
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.parallel import DataAxis, Mesh, ModelAxis

    towers, agg, images, tokens = _tiny_step_inputs(cuda)
    cuda_lib.reset_launches()
    want_loss, want = _run_step(make_train_step(tclip.TINY, dropout=0.0), towers, agg, images,
                                tokens)
    single = dict(cuda_lib.LAUNCHES)
    assert single["fused_attn_half"] > 0 and single["mlp_half_bwd_dx"] > 0
    for shards in (2, 4):
        mesh = Mesh(DataAxis.local(shards), ModelAxis.local(1))
        cuda_lib.reset_launches()
        loss, got = _run_step(make_sharded_train_step(tclip.TINY, mesh, dropout=0.0), towers,
                              agg, images, tokens)
        assert dict(cuda_lib.LAUNCHES) == {k: shards * n for k, n in single.items()}
        assert abs(loss - want_loss) <= 1e-5
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


class _NcclWorld1:
    """An NCCL process group of one rank on this card, for the duration."""

    def __enter__(self):
        import socket

        import torch.distributed as dist

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                                rank=0)
        return dist.group.WORLD

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def test_nccl_world_size_1_equals_the_local_shard(cuda):
    """The process-group branch of the data axis over NCCL at world size 1
    (all-gather, its reduce-scatter backward and the gradient all-reduce
    each a copy) gives the local shard's step bit for bit."""
    from ovmr_tpu_torch.engine.train_step import make_sharded_train_step
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.parallel import DataAxis, Mesh, ModelAxis

    towers, agg, images, tokens = _tiny_step_inputs(cuda)
    local = Mesh(DataAxis.local(1), ModelAxis.local(1))
    want_loss, want = _run_step(make_sharded_train_step(tclip.TINY, local, dropout=0.0), towers,
                                agg, images, tokens)
    with _NcclWorld1() as world:
        grouped = Mesh(DataAxis(1, (0,), group=world), ModelAxis.local(1))
        loss, got = _run_step(make_sharded_train_step(tclip.TINY, grouped, dropout=0.0), towers,
                              agg, images, tokens)
    assert loss == want_loss
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gather_nccl_backward_matches_the_local_cat(cuda):
    """``DataAxis.gather`` over NCCL: forward the all-gather, backward the
    reduce-scatter, against the local shards' ``torch.cat`` (world size 1:
    both are the identity on the rows)."""
    from ovmr_tpu_torch.parallel import DataAxis

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(5, 7, device="cuda", generator=g)
    w = torch.randn(5, 7, device="cuda", generator=g)
    with _NcclWorld1() as world:
        a = x.clone().requires_grad_(True)
        y = DataAxis(1, (0,), group=world).gather([a])
        (y * w).sum().backward()
    b = x.clone().requires_grad_(True)
    z = DataAxis.local(1).gather([b])
    (z * w).sum().backward()
    assert torch.equal(y.detach(), z.detach()) and torch.equal(a.grad, b.grad)


# --------------------------------------------------------------------------
# the Dassl DG trainers (no hand-written kernel: cuDNN, TF32 off)
# --------------------------------------------------------------------------

def _dg_vanilla(device, data=-1):
    """Vanilla on ResNet-18 (64 px, batch 16, a BN head so the BN statistics
    move), built without a data manager. The lr is the recipe's tenth, as in
    ``chip_smoke.py`` phase 20's gates: the JAX goldens' way of keeping two
    steps insensitive to fp32 rounding (``tests/test_trajectory_parity.py``;
    at the recipe's lr the first convolution's update moves by 8x the leaf
    gate between card and CPU)."""
    from ovmr_tpu_torch.engine import dg
    from ovmr_tpu_torch.utils import get_cfg_default

    cfg = get_cfg_default()
    cfg.MODEL.BACKBONE.NAME = "resnet18"
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.HEAD.NAME = "mlp"
    cfg.MODEL.HEAD.HIDDEN_LAYERS = [32]
    cfg.INPUT.SIZE = (64, 64)
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.LR_SCHEDULER = "sgd", 1e-4, "cosine"
    cfg.CUDA.DEVICE = device
    cfg.CUDA.MESH.DATA = data

    class _DM:
        num_classes, num_source_domains = 7, 3

    trainer = dg.Vanilla.__new__(dg.Vanilla)
    trainer._init_state(cfg)
    trainer.dm = _DM()
    torch.manual_seed(0)
    trainer.build_model()
    trainer.epoch = 0
    trainer.before_epoch()
    return trainer


def _dg_steps(trainer):
    """Two steps on seeded batches: the losses, the state before and after."""
    init = trainer.model_state()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(2):
        batch = {"img": rng.standard_normal((16, 3, 64, 64)).astype(np.float32),
                 "label": rng.integers(0, 7, 16), "domain": rng.integers(0, 3, 16)}
        losses.append(trainer.forward_backward(batch)["loss"])
    return losses, init, trainer.model_state()


def _dg_leaves(state, prefix=""):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _dg_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _dg_scale(name, ref, init):
    """``chip_smoke._dg_scale``: max |leaf|; a leaf that starts at zero (a
    bias, a running mean) takes the larger of that and its module's weight's
    at the start (the BN scale or kernel beside it, the running variance)."""
    scale = float(np.abs(ref).max())
    if np.any(init[name]):
        return scale
    head, _, last = name.rpartition("/")
    for weight in {"bias": ("scale", "kernel"), "mean": ("var",)}.get(last, ()):
        if f"{head}/{weight}" in init:
            return max(scale, float(np.abs(init[f"{head}/{weight}"]).max()))
    return scale


def _dg_assert_close(got, ref, init):
    """Every parameter and BN statistic within 1e-4 of its leaf's scale."""
    ref, init = dict(_dg_leaves(ref)), dict(_dg_leaves(init))
    for name, value in _dg_leaves(got):
        err, scale = float(np.abs(value - ref[name]).max()), _dg_scale(name, ref[name], init)
        assert err <= 1e-4 * scale, (name, err, scale)


def test_dg_vanilla_step_on_card_matches_the_cpu(cuda):
    """Two Vanilla steps of ResNet-18 on the card (cuDNN, TF32 off by the
    trainer, whatever torch's flags) against the CPU from the same init and
    batches: each loss within 1e-5 relative, every parameter and BN
    statistic within 1e-4 of its leaf's scale (:func:`_dg_scale`)."""
    card_losses, init, card = _dg_steps(_dg_vanilla("cuda"))
    cpu_losses, _, cpu = _dg_steps(_dg_vanilla("cpu"))
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-5)
    _dg_assert_close(card, cpu, init)


def test_dg_vanilla_on_two_local_data_shards_matches_one_program(cuda):
    """``CUDA.MESH.DATA 2`` on the card: the global BN statistics over the
    two shards give the one program's losses within 1e-5 relative and its
    parameters and statistics within 1e-4 of each leaf's scale."""
    one_losses, init, one = _dg_steps(_dg_vanilla("cuda"))
    two_losses, _, two = _dg_steps(_dg_vanilla("cuda", data=2))
    np.testing.assert_allclose(two_losses, one_losses, rtol=1e-5)
    _dg_assert_close(two, one, init)
