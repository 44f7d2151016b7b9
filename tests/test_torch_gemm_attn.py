"""K1 and K7 composed from the block halves' GEMM (``block_gemm``, the
wgmma/TMA kernel on the card) on the CPU, where it is its plain twin.

K1 is LayerNorm, a ``"bias"`` QKV product, the attention core and a
``"residual"`` out-proj; K7 is LayerNorm, three ``"bias"`` products into
the column slices of one ``[B, L, 3 dl]`` buffer, the core and an ``"f32"``
out-proj. Composed so, they equal the plain halves bit for bit and match
the Pallas kernels in interpret mode (fp32 atol 1e-5, bf16 1e-2), masked
and unmasked, on numpy-seeded inputs. As in ``tests/test_torch_kernels.py``
x is scaled so that the outputs stay below 2, where one bf16 rounding step
is below 1e-2.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ovmr_tpu.ops import block_fused_tp as jtp
from ovmr_tpu.ops.block_fused import fused_attn_half as j_fused_attn_half
from ovmr_tpu.ops.layers import causal_mask as j_causal_mask
from ovmr_tpu_torch.ops import block_fused_tp as ttp
from ovmr_tpu_torch.ops.block_fused import (
    attn_core,
    block_gemm,
    block_gemm_plain,
    fused_attn_half_plain,
)
from ovmr_tpu_torch.ops.layers import causal_mask, layer_norm

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
K1_KEYS = ("w_qkv", "b_qkv", "w_out", "b_out", "ln_s", "ln_b")
K7_KEYS = ("w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_out", "ln_s", "ln_b")
SHAPES = [(2, 17, 64, 2), (2, 17, 64, 4)]  # b, l, d, heads


def _inputs(keys, shapes, b, l, d, seed):
    """x [b, l, d] (standard deviation 0.25) and the named tensors,
    numpy-seeded: unit-variance weights scaled by their fan-in, small
    biases, LayerNorm near identity."""
    rng = np.random.RandomState(seed)
    p = {}
    for k in keys:
        shape = shapes[k]
        if k == "ln_s":
            v = 1 + 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            v = 0.05 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) * shape[0] ** -0.5
        p[k] = v.astype(np.float32)
    return (0.25 * rng.randn(b, l, d)).astype(np.float32), p


def _masks(masked, l):
    if not masked:
        return None, None
    return jnp.asarray(j_causal_mask(l)), causal_mask(l)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("b,l,d,h", SHAPES)
def test_block_gemm_composes_k1(dtype, masked, b, l, d, h):
    jdt, tdt, tol = DTYPES[dtype]
    shapes = {"w_qkv": (d, 3 * d), "b_qkv": (3 * d,), "w_out": (d, d), "b_out": (d,),
              "ln_s": (d,), "ln_b": (d,)}
    x, p = _inputs(K1_KEYS, shapes, b, l, d, seed=10 * h + masked)
    jmask, tmask = _masks(masked, l)
    ref = j_fused_attn_half(jnp.asarray(x, jdt), *(jnp.asarray(p[k], jdt) for k in K1_KEYS),
                            mask=jmask, n_head=h, interpret=True)
    xt = torch.tensor(x).to(tdt)
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    qkv = block_gemm(layer_norm(xt, t["ln_s"], t["ln_b"]), t["w_qkv"], t["b_qkv"], "bias")
    heads = attn_core(qkv, tmask, h)
    got = block_gemm(heads, t["w_out"], t["b_out"], "residual", resid=xt)
    plain = fused_attn_half_plain(xt, *(t[k] for k in K1_KEYS), mask=tmask, n_head=h)
    assert got.dtype == tdt and torch.equal(got, plain)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("b,l,d,h", SHAPES)
def test_block_gemm_composes_k7(dtype, masked, b, l, d, h):
    """One head shard of a model axis of 2: ``h / 2`` local heads of width
    ``d / h``, q, k and v written into their slices of one buffer."""
    jdt, tdt, tol = DTYPES[dtype]
    dl, nh = d // 2, h // 2
    shapes = {"w_q": (d, dl), "b_q": (dl,), "w_k": (d, dl), "b_k": (dl,), "w_v": (d, dl),
              "b_v": (dl,), "w_out": (dl, d), "ln_s": (d,), "ln_b": (d,)}
    x, p = _inputs(K7_KEYS, shapes, b, l, d, seed=20 * h + masked)
    jmask, tmask = _masks(masked, l)
    ref = jtp.tp_attn_half_partial(jnp.asarray(x, jdt), *(jnp.asarray(p[k], jdt) for k in K7_KEYS),
                                   mask=jmask, n_head=nh, interpret=True)
    xt = torch.tensor(x).to(tdt)
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    xln = layer_norm(xt, t["ln_s"], t["ln_b"])
    qkv = torch.empty(b, l, 3 * dl, dtype=tdt)
    for j, name in enumerate("qkv"):
        out = qkv[..., j * dl:(j + 1) * dl]
        assert block_gemm(xln, t[f"w_{name}"], t[f"b_{name}"], "bias", out=out) is out
    got = block_gemm(attn_core(qkv, tmask, nh), t["w_out"], None, "f32")
    plain = ttp.tp_attn_half_partial_plain(xt, *(t[k] for k in K7_KEYS), mask=tmask, n_head=nh)
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_gemm_bias_and_f32_epilogues(dtype):
    """``"bias"`` casts the sum after an fp32 bias; ``"f32"`` keeps the fp32
    sum; a column slice of ``out`` is written and its neighbours are not."""
    g = torch.Generator().manual_seed(3)
    a, w = torch.randn(5, 16, generator=g).to(dtype), torch.randn(16, 24, generator=g).to(dtype)
    bias = torch.randn(24, generator=g).to(dtype)
    acc = a.float() @ w.float()
    assert torch.equal(block_gemm_plain(a, w, bias, "bias"), (acc + bias.float()).to(dtype))
    f32 = block_gemm_plain(a, w, None, "f32")
    assert f32.dtype == torch.float32
    torch.testing.assert_close(f32, acc, atol=1e-5, rtol=1e-5)
    buf = torch.full((5, 40), 7.0, dtype=dtype)
    block_gemm(a, w, bias, "bias", out=buf[:, 8:32])
    assert torch.equal(buf[:, 8:32], (acc + bias.float()).to(dtype))
    assert bool((buf[:, :8] == 7).all() and (buf[:, 32:] == 7).all())
