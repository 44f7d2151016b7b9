"""K8 composed from the block halves' GEMM (``block_gemm``, the wgmma/TMA
kernel on the card) on the CPU, where it is its plain twin.

K8 (``tp_mlp_half_partial``) is LayerNorm, a ``"gelu"`` c_fc product
(bias and QuickGELU in fp32, then cast) and an ``"f32"`` c_proj product
(the fp32 partial, uncast) over one hidden shard. Composed so, it equals
the plain twin bit for bit and matches the Pallas kernel in interpret mode
(fp32 atol 1e-5, bf16 1e-2) on numpy-seeded inputs, at the hidden-shard
widths of a model axis of 2 and of 4. As in ``tests/test_torch_kernels.py``
x is scaled so that the outputs stay below 2, where one bf16 rounding step
is below 1e-2.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ovmr_tpu.ops import block_fused_tp as jtp
from ovmr_tpu_torch.ops import block_fused_tp as ttp
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused import block_gemm
from ovmr_tpu_torch.ops.layers import layer_norm

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
K8_KEYS = ("c_fc_w", "c_fc_b", "c_proj_w", "ln_s", "ln_b")
# b, l, d, hidden shard: model axis 2 (hl = 2 d) at two widths, model axis 4
# (hl = d); d = 40 is the card tests' narrowest K8 case
SHAPES = [(2, 17, 64, 128), (3, 9, 40, 80), (2, 17, 64, 64)]


def _inputs(b, l, d, hl, seed):
    """x [b, l, d] (standard deviation 0.25) and one hidden shard's
    tensors, numpy-seeded: unit-variance weights scaled by their fan-in,
    small biases, LayerNorm near identity."""
    rng = np.random.RandomState(seed)
    p = {
        "c_fc_w": rng.randn(d, hl) * d ** -0.5,
        "c_fc_b": 0.05 * rng.randn(hl),
        "c_proj_w": rng.randn(hl, d) * hl ** -0.5,
        "ln_s": 1 + 0.1 * rng.randn(d),
        "ln_b": 0.05 * rng.randn(d),
    }
    x = 0.25 * rng.randn(b, l, d)
    return x.astype(np.float32), {k: v.astype(np.float32) for k, v in p.items()}


def _compose_k8(x, t):
    """K8 as its wrapper launches it on the card: LayerNorm, then the
    c_fc and c_proj products on the block GEMM."""
    h = block_gemm(layer_norm(x, t["ln_s"], t["ln_b"]), t["c_fc_w"], t["c_fc_b"], "gelu")
    return block_gemm(h, t["c_proj_w"], None, "f32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,d,hl", SHAPES)
def test_block_gemm_composes_k8(dtype, b, l, d, hl):
    jdt, tdt, tol = DTYPES[dtype]
    x, p = _inputs(b, l, d, hl, seed=d + hl)
    ref = jtp.tp_mlp_half_partial(jnp.asarray(x, jdt), *(jnp.asarray(p[k], jdt) for k in K8_KEYS),
                                  interpret=True)
    xt = torch.tensor(x).to(tdt)
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    got = _compose_k8(xt, t)
    plain = ttp.tp_mlp_half_partial_plain(xt, *(t[k] for k in K8_KEYS))
    assert got.dtype == torch.float32 and got.shape == (b, l, d)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k8_wrapper_on_the_cpu_is_the_composition(dtype):
    """The wrapper takes its plain twin for a CPU tensor, which is the GEMM
    composition bit for bit; nothing is launched or counted."""
    _, tdt, _ = DTYPES[dtype]
    x, p = _inputs(2, 17, 64, 128, seed=3)
    xt = torch.tensor(x).to(tdt)
    t = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    cuda_lib.reset_launches()
    got = ttp.tp_mlp_half_partial(xt, *(t[k] for k in K8_KEYS))
    assert torch.equal(got, _compose_k8(xt, t))
    assert all(n == 0 for n in cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES
