"""The backward of a block whose MLP half runs chunked (K5), on the CPU.

A block of width 1024 with hidden 8192 (32 MiB of bf16 MLP weights, above
the residency tiers) routes to K5 with no patching, in 4 chunks of 2048, in
both packages. Its input cotangent through ``fused_residual_block`` (K4
then K3 on the saved x and y; the plain twins here) is held against
``jax.vjp`` of the JAX ``fused_residual_block`` (Pallas in interpret mode;
its backward for such a block is the XLA VJP, ``block_fused.py:549``): fp32
within 1e-4 (JAX sizes its route by the real itemsize, so its fp32 forward
is XLA), bf16 within 1e-2 (both forwards take the chunked kernel).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.ops.block_fused import fused_residual_block as j_fused_residual_block
from ovmr_tpu_torch.ops import block_fused as tbf

D, HIDDEN, HEADS, B, L = 1024, 8192, 16, 1, 8


@pytest.fixture(scope="module")
def block_np():
    rng = np.random.RandomState(0)

    def r(*shape, std):
        return (std * rng.randn(*shape)).astype(np.float32)

    return {
        "w_qkv": r(D, 3 * D, std=D ** -0.5), "b_qkv": r(3 * D, std=0.02),
        "w_out": r(D, D, std=0.5 * D ** -0.5), "b_out": r(D, std=0.02),
        "ln_1_scale": 1 + r(D, std=0.1), "ln_1_bias": r(D, std=0.05),
        "c_fc_w": r(D, HIDDEN, std=D ** -0.5), "c_fc_b": r(HIDDEN, std=0.02),
        "c_proj_w": r(HIDDEN, D, std=0.5 * HIDDEN ** -0.5), "c_proj_b": r(D, std=0.02),
        "ln_2_scale": 1 + r(D, std=0.1), "ln_2_bias": r(D, std=0.05),
    }


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_dx_after_k5_matches_jax_vjp(block_np, dtype, tol):
    rng = np.random.RandomState(1)
    x = (0.5 * rng.randn(B, L, D)).astype(np.float32)
    g = (0.25 * rng.randn(B, L, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    pj = {k: jnp.asarray(v, jdt) for k, v in block_np.items()}
    _, vjp = jax.vjp(lambda x_: j_fused_residual_block(x_, pj, HEADS, None, interpret=True),
                     jnp.asarray(x, jdt))
    (ref,) = vjp(jnp.asarray(g, jdt))
    ref = np.asarray(ref, np.float32)

    taken = []
    real = tbf.fused_mlp_half_chunked
    pt = {k: torch.tensor(v).to(tdt) for k, v in block_np.items()}
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    try:
        tbf.fused_mlp_half_chunked = lambda *a, **k: (taken.append(k["chunks"]), real(*a, **k))[1]
        out = tbf.fused_residual_block(xt, pt, HEADS)
    finally:
        tbf.fused_mlp_half_chunked = real
    assert taken == [4]
    (dx,) = torch.autograd.grad(out, xt, torch.tensor(g).to(tdt))
    assert dx.dtype == tdt and np.abs(ref).max() < 2.0
    got = dx.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
