"""The block halves' GEMM (``block_gemm``, the wgmma/TMA kernel on the
card) on the CPU, where it is its plain twin: its MLP epilogues compose to
K2's and K5's plain versions exactly, and those match the Pallas kernels in
interpret mode (fp32 1e-5, bf16 1e-2). K1 and K7 composed from it:
``tests/test_torch_gemm_attn.py``."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ovmr_tpu.ops.block_fused import fused_mlp_half as j_fused_mlp_half
from ovmr_tpu.ops.block_fused import fused_mlp_half_chunked as j_fused_mlp_half_chunked
from ovmr_tpu_torch.ops.block_fused import (
    _chunk_width,
    fused_mlp_half_chunked_plain,
    fused_mlp_half_plain,
    block_gemm,
    block_gemm_plain,
)
from ovmr_tpu_torch.ops.layers import layer_norm

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
NAMES = ("c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b", "ln_2_scale", "ln_2_bias")


def _mlp(d, seed):
    rng = np.random.RandomState(seed)
    return {
        "c_fc_w": (rng.randn(d, 4 * d) * d ** -0.5).astype(np.float32),
        "c_fc_b": (0.02 * rng.randn(4 * d)).astype(np.float32),
        "c_proj_w": (0.5 * rng.randn(4 * d, d) * (4 * d) ** -0.5).astype(np.float32),
        "c_proj_b": (0.02 * rng.randn(d)).astype(np.float32),
        "ln_2_scale": (1 + 0.1 * rng.randn(d)).astype(np.float32),
        "ln_2_bias": (0.05 * rng.randn(d)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunks", [0, 2, 4])
@pytest.mark.parametrize("b,l,d", [(2, 9, 64), (1, 17, 40)])
def test_mlp_gemm_composes_k2_and_k5(dtype, chunks, b, l, d):
    """K2 is ``gelu`` then ``residual``; K5 is, per chunk, ``gelu`` on a
    column slice of c_fc_w then ``accum`` into x + c_proj_b: bit for bit
    the plain halves, which match the Pallas kernels."""
    jdt, tdt, tol = DTYPES[dtype]
    p = _mlp(d, seed=b + l + d)
    x = np.random.RandomState(l).randn(b, l, d).astype(np.float32) * 0.5
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    xt = torch.tensor(x).to(tdt)
    xln = layer_norm(xt, t["ln_2_scale"], t["ln_2_bias"])
    if chunks == 0:
        h = block_gemm(xln, t["c_fc_w"], t["c_fc_b"], "gelu")
        got = block_gemm(h, t["c_proj_w"], t["c_proj_b"], "residual", resid=xt)
        plain = fused_mlp_half_plain(xt, *(t[k] for k in NAMES))
        ref = j_fused_mlp_half(jnp.asarray(x, jdt), *(jnp.asarray(p[k], jdt) for k in NAMES),
                               interpret=True)
    else:
        hc = _chunk_width(4 * d, chunks)
        got = xt + t["c_proj_b"].float().to(tdt)
        for j in range(0, 4 * d, hc):
            h = block_gemm(xln, t["c_fc_w"][:, j:j + hc], t["c_fc_b"][j:j + hc], "gelu")
            block_gemm(h, t["c_proj_w"][j:j + hc], None, "accum", out=got)
        plain = fused_mlp_half_chunked_plain(xt, *(t[k] for k in NAMES), chunks=chunks)
        ref = j_fused_mlp_half_chunked(jnp.asarray(x, jdt),
                                       *(jnp.asarray(p[k], jdt) for k in NAMES),
                                       chunks=chunks, interpret=True)
    assert got.dtype == tdt and torch.equal(got, plain)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=0)


def test_mlp_gemm_epilogues_and_refusals():
    g = torch.Generator().manual_seed(0)
    a, w = torch.randn(5, 16, generator=g), torch.randn(16, 24, generator=g)
    bias, resid, c = torch.randn(24, generator=g), torch.randn(5, 24, generator=g), torch.zeros(5, 24)
    acc = a @ w
    torch.testing.assert_close(block_gemm_plain(a, w, bias, "gelu"),
                               (acc + bias) * torch.sigmoid(1.702 * (acc + bias)))
    torch.testing.assert_close(block_gemm_plain(a, w, bias, "residual", resid), resid + acc + bias)
    out = block_gemm(a, w, None, "accum", out=c)
    assert out is c
    torch.testing.assert_close(c, acc)
    with pytest.raises(ValueError, match="epilogue"):
        block_gemm(a, w, bias, "relu")
    with pytest.raises(ValueError, match="no kernel"):
        block_gemm(a.to("meta"), w.to("meta"), bias.to("meta"))
