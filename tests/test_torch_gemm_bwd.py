"""K3 and K4 composed from the backward's GEMM (``block_gemm_bwd``, the
wgmma/TMA kernel on the card) on the CPU, where each piece is its plain twin.

The backward epilogues' plain twins (``"bias_f32"``, and against the
transposed weight as it is stored ``"cast"``, ``"gelu_grad"``, ``"f32"``)
are held bit for bit against the ``matmul_f32`` compositions that the dx
twins write out. K3 (LayerNorm, K1's ``"bias"`` QKV product, ``"cast"``
dattn, the attention-backward core, ``"f32"`` dxln, the LayerNorm
cotangent) and K4 (LayerNorm, ``"bias_f32"`` h_pre, ``"gelu_grad"``
dh_pre, ``"f32"`` dxln, the LayerNorm cotangent) composed so equal
``attn_half_bwd_dx_plain`` / ``mlp_half_bwd_dx_plain`` bit for bit and
match the Pallas kernels in interpret mode (fp32 atol 1e-5, bf16 1e-2) on
numpy-seeded inputs scaled so that the outputs stay below 2, where one
bf16 rounding step is below 1e-2.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ovmr_tpu.ops.block_fused_bwd import (
    attn_half_bwd_dx as j_attn_half_bwd_dx,
    mlp_half_bwd_dx as j_mlp_half_bwd_dx,
)
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused import block_gemm
from ovmr_tpu_torch.ops.block_fused_bwd import (
    attn_bwd_core,
    attn_half_bwd_dx,
    attn_half_bwd_dx_plain,
    block_gemm_bwd,
    block_gemm_bwd_plain,
    ln_bwd_plain,
    mlp_half_bwd_dx,
    mlp_half_bwd_dx_plain,
)
from ovmr_tpu_torch.ops.layers import causal_mask, layer_norm, matmul_f32

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
K3_KEYS = ("w_qkv", "b_qkv", "w_out", "ln_s", "ln_b")
K4_KEYS = ("c_fc_w", "c_fc_b", "c_proj_w", "ln_s", "ln_b")
# b, l, d, heads: the text tower's 77 tokens, a ragged short sequence, and
# a head width that pads to 64 inside the card's core
SHAPES = [(2, 77, 64, 2), (3, 9, 64, 4), (2, 17, 80, 2)]


def _layer(d, seed):
    """One block's tensors, numpy-seeded: unit-variance weights scaled by
    their fan-in (the output projections halved, so each cotangent stays
    below 2), small biases, LayerNorm near identity."""
    rng = np.random.RandomState(seed)
    p = {
        "w_qkv": rng.randn(d, 3 * d) * d ** -0.5,
        "b_qkv": 0.05 * rng.randn(3 * d),
        "w_out": 0.5 * rng.randn(d, d) * d ** -0.5,
        "c_fc_w": rng.randn(d, 4 * d) * d ** -0.5,
        "c_fc_b": 0.05 * rng.randn(4 * d),
        "c_proj_w": 0.5 * rng.randn(4 * d, d) * (4 * d) ** -0.5,
        "ln_s": 1 + 0.1 * rng.randn(d),
        "ln_b": 0.05 * rng.randn(d),
    }
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(b, l, d, seed):
    """The half's input (standard deviation 0.25) and its cotangent (0.15)."""
    rng = np.random.RandomState(seed)
    return tuple((std * rng.randn(b, l, d)).astype(np.float32) for std in (0.25, 0.15))


def _compose_k3(x, g, t, mask, heads):
    """K3 as its wrapper launches it on the card."""
    qkv = block_gemm(layer_norm(x, t["ln_s"], t["ln_b"]), t["w_qkv"], t["b_qkv"], "bias")
    dattn = block_gemm_bwd(g, t["w_out"], "cast")
    dqkv = attn_bwd_core(qkv, dattn, mask, heads)
    return ln_bwd_plain(x, block_gemm_bwd(dqkv, t["w_qkv"], "f32"), g, t["ln_s"])


def _compose_k4(y, g, t):
    """K4 as its wrapper launches it on the card."""
    h_pre = block_gemm_bwd(layer_norm(y, t["ln_s"], t["ln_b"]), t["c_fc_w"], "bias_f32",
                           bias=t["c_fc_b"])
    dh_pre = block_gemm_bwd(g, t["c_proj_w"], "gelu_grad", h_pre=h_pre)
    return ln_bwd_plain(y, block_gemm_bwd(dh_pre, t["c_fc_w"], "f32"), g, t["ln_s"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("epilogue", ["bias_f32", "cast", "gelu_grad", "f32"])
def test_bwd_gemm_plain_is_the_matmul_f32_composition(dtype, epilogue):
    """Each epilogue as the dx twins write it out: the fp32 h_pre with its
    bias, the cast product with w^T, the fp32 QuickGELU' product cast
    after it, the fp32 product with w^T."""
    tdt = DTYPES[dtype][1]
    rng = np.random.RandomState(len(epilogue))
    a = torch.tensor(rng.randn(3, 5, 24).astype(np.float32)).to(tdt)
    w = torch.tensor((rng.randn(24, 40) * 0.2).astype(np.float32)).to(tdt)
    if epilogue == "bias_f32":
        bias = torch.tensor(rng.randn(40).astype(np.float32)).to(tdt)
        want = matmul_f32(a, w) + bias.float()
        got = block_gemm_bwd_plain(a, w, epilogue, bias=bias)
    else:
        w = w.t().contiguous()  # stored [N, K]: the product is a @ w^T
        acc = matmul_f32(a, w.transpose(-1, -2))
        h_pre = None
        if epilogue == "f32":
            want = acc
        elif epilogue == "cast":
            want = acc.to(tdt)
        else:
            h_pre = torch.tensor(rng.randn(3, 5, 40).astype(np.float32))
            s = torch.sigmoid(1.702 * h_pre)
            want = (acc * (s + 1.702 * h_pre * s * (1.0 - s))).to(tdt)
        got = block_gemm_bwd_plain(a, w, epilogue, h_pre=h_pre)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert got.dtype == (torch.float32 if epilogue in ("bias_f32", "f32") else tdt)
    out = torch.empty_like(got)
    cuda_lib.reset_launches()
    kw = dict(bias=bias) if epilogue == "bias_f32" else dict(h_pre=h_pre)
    assert block_gemm_bwd(a, w, epilogue, out=out, **kw) is out and torch.equal(out, want)
    assert all(n == 0 for n in cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,l,d,heads", SHAPES)
def test_bwd_gemm_composes_k3(dtype, masked, b, l, d, heads):
    jdt, tdt, tol = DTYPES[dtype]
    p = _layer(d, seed=l + d)
    x, g = _inputs(b, l, d, seed=l * 3 + d)
    mask = causal_mask(l) if masked else None
    ref = j_attn_half_bwd_dx(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), *(jnp.asarray(p[k], jdt) for k in K3_KEYS),
        mask=None if mask is None else jnp.asarray(mask.numpy()), n_head=heads, interpret=True,
    )
    xt, gt = torch.tensor(x).to(tdt), torch.tensor(g).to(tdt)
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    got = _compose_k3(xt, gt, t, mask, heads)
    plain = attn_half_bwd_dx_plain(xt, gt, *(t[k] for k in K3_KEYS), mask=mask, n_head=heads)
    assert got.dtype == tdt and torch.equal(got, plain)
    assert torch.equal(attn_half_bwd_dx(xt, gt, *(t[k] for k in K3_KEYS), mask=mask,
                                        n_head=heads), plain)
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() < 2.0
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,d,heads", SHAPES)
def test_bwd_gemm_composes_k4(dtype, b, l, d, heads):
    jdt, tdt, tol = DTYPES[dtype]
    p = _layer(d, seed=l * 5 + d)
    y, g = _inputs(b, l, d, seed=l + 7 * d)
    ref = j_mlp_half_bwd_dx(jnp.asarray(y, jdt), jnp.asarray(g, jdt),
                            *(jnp.asarray(p[k], jdt) for k in K4_KEYS), interpret=True)
    yt, gt = torch.tensor(y).to(tdt), torch.tensor(g).to(tdt)
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    got = _compose_k4(yt, gt, t)
    plain = mlp_half_bwd_dx_plain(yt, gt, *(t[k] for k in K4_KEYS))
    assert got.dtype == tdt and torch.equal(got, plain)
    cuda_lib.reset_launches()
    assert torch.equal(mlp_half_bwd_dx(yt, gt, *(t[k] for k in K4_KEYS)), plain)
    assert all(n == 0 for n in cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() < 2.0
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)
