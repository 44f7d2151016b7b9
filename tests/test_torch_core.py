"""The attention core of K1 and K7 (``attn_core``) against the JAX package.

``ovmr_tpu_torch.ops.block_fused.attn_core_plain`` is what the core's
wrapper runs for a CPU tensor and what K1's and K7's plain twins run
between their projections. It is held, on the same numpy inputs:

- against the per-head body of the TPU kernels (``_attn_half_kernel``
  ``ovmr_tpu/ops/block_fused.py:78-101``, ``_attn_partial_kernel``
  ``ovmr_tpu/ops/block_fused_tp.py:204-221``), written out in JAX on a
  given ``qkv``: the core alone;
- as the middle step of K1 (``W = D``) against ``fused_attn_half`` and of K7
  (``W = dl``, a head shard) against ``tp_attn_half_partial``, both Pallas
  kernels in interpret mode;

with no mask, the causal mask and a random additive mask whose entries
reach -1e4. Tolerances are the ladder of ``tests/test_block_fused.py``:
fp32 atol 1e-5, bf16 atol 1e-2 (outputs stay below 2, where one bf16
rounding step is under 1e-2). The CUDA kernel runs in
``tests/test_torch_cuda.py`` on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.ops import block_fused_tp as jtp
from ovmr_tpu.ops.block_fused import fused_attn_half as j_fused_attn_half
from ovmr_tpu.ops.layers import causal_mask as j_causal_mask
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.block_fused import attn_core, attn_core_plain
from ovmr_tpu_torch.ops.layers import dense, layer_norm, matmul_f32

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
MASKS = ["none", "causal", "random"]


def _mask_np(kind, l):
    """None, the causal mask, or N(0, 1) entries with a quarter of them
    pushed down towards -1e4."""
    if kind == "none":
        return None
    if kind == "causal":
        return np.asarray(j_causal_mask(l))
    rng = np.random.RandomState(l)
    m = rng.randn(l, l).astype(np.float32)
    drop = rng.rand(l, l).astype(np.float32)
    return np.where(drop < 0.25, -1e4 * drop * 4, m).astype(np.float32)


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _j_core(qkv, mask, n_head):
    """The TPU kernels' per-head loop on a packed qkv [B, L, 3W]: fp32
    scores scaled after the product, the fp32 mask, jax.nn.softmax, probs
    cast before the fp32-accumulated product, each head cast."""
    dtype = qkv.dtype
    w = qkv.shape[-1] // 3
    dh = w // n_head
    outs = []
    for h in range(n_head):
        q = qkv[:, :, h * dh : (h + 1) * dh]
        k = qkv[:, :, w + h * dh : w + (h + 1) * dh]
        v = qkv[:, :, 2 * w + h * dh : 2 * w + (h + 1) * dh]
        s = jax.lax.dot_general(q, k, (((2,), (2,)), ((0,), (0,))),
                                preferred_element_type=jnp.float32) * dh ** -0.5
        if mask is not None:
            s = s + mask.astype(jnp.float32)[None]
        p = jax.nn.softmax(s, axis=-1)
        outs.append(jax.lax.dot_general(p.astype(dtype), v, (((2,), (1,)), ((0,), (0,))),
                                        preferred_element_type=jnp.float32).astype(dtype))
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,l,w,n_head", [(2, 17, 64, 2), (3, 33, 40, 5), (1, 77, 96, 3)])
def test_attn_core_plain_matches_the_tpu_head_loop(dtype, mask_kind, b, l, w, n_head):
    jdt, tdt, tol = DTYPES[dtype]
    qkv = np.random.RandomState(b * 100 + l).randn(b, l, 3 * w).astype(np.float32)
    mask = _mask_np(mask_kind, l)
    ref = _j_core(jnp.asarray(qkv, jdt), None if mask is None else jnp.asarray(mask), n_head)
    got = attn_core_plain(torch.tensor(qkv).to(tdt),
                          None if mask is None else torch.tensor(mask), n_head)
    assert got.dtype == tdt and got.shape == (b, l, w)
    _close(got, ref, tol)


@pytest.fixture(scope="module")
def layer_np():
    """One TINY vision block (D=64) from the JAX package's init_params, as
    numpy, with non-trivial biases and LayerNorm parameters; w_out halved
    so that K1's output stays below 2."""
    params = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY)
    p = {k: np.asarray(v[0]) for k, v in params["visual"]["blocks"].items()}
    rng = np.random.RandomState(0)
    for k in ("b_qkv", "b_out", "ln_1_bias"):
        p[k] = (0.05 * rng.randn(*p[k].shape)).astype(np.float32)
    p["ln_1_scale"] = (1 + 0.1 * rng.randn(*p["ln_1_scale"].shape)).astype(np.float32)
    p["w_out"] = 0.5 * p["w_out"]
    return p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,l,n_head", [(4, 17, 2), (2, 40, 4)])
def test_attn_core_plain_as_k1s_middle_step_matches_pallas(layer_np, dtype, mask_kind, b, l,
                                                            n_head):
    """W = D: LN1, the packed QKV product, the core, out-projection and
    residual against the Pallas K1 in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    x = (0.25 * np.random.RandomState(b * 10 + l).randn(b, l, 64)).astype(np.float32)
    mask = _mask_np(mask_kind, l)
    names = ("w_qkv", "b_qkv", "w_out", "b_out", "ln_1_scale", "ln_1_bias")
    ref = j_fused_attn_half(jnp.asarray(x, jdt), *(jnp.asarray(layer_np[k], jdt) for k in names),
                            mask=None if mask is None else jnp.asarray(mask), n_head=n_head,
                            interpret=True)
    p = {k: torch.tensor(layer_np[k]).to(tdt) for k in names}
    xt = torch.tensor(x).to(tdt)
    qkv = dense(layer_norm(xt, p["ln_1_scale"], p["ln_1_bias"]), p["w_qkv"], p["b_qkv"])
    heads = attn_core_plain(qkv, None if mask is None else torch.tensor(mask), n_head)
    got = xt + dense(heads, p["w_out"], p["b_out"])
    assert np.abs(np.asarray(ref, np.float32)).max() < 2.0
    _close(got, ref, tol)


K7_KEYS = ("w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_out", "ln_1_scale", "ln_1_bias")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("m,shard,n_head", [(1, 0, 2), (2, 0, 2), (2, 1, 2), (2, 1, 4)])
def test_attn_core_plain_as_k7s_middle_step_matches_pallas(layer_np, dtype, mask_kind, m, shard,
                                                            n_head):
    """W = dl: shard ``shard`` of ``m`` (``n_head / m`` local heads), its
    q, k and v side by side as K7's wrapper writes them, the core and the
    fp32 out-projection partial against the Pallas K7 in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    split = jtp.pad_head_shards(jtp.split_qkv_blocks(layer_np), 64 // n_head, m)
    s = {k: v if jtp.TP_BLOCK_AXES[k] is None else np.split(np.asarray(v), m,
                                                            axis=jtp.TP_BLOCK_AXES[k])[shard]
         for k, v in split.items() if k in K7_KEYS}
    nh, l = n_head // m, 17
    x = np.random.RandomState(1).randn(4, l, 64).astype(np.float32)
    mask = _mask_np(mask_kind, l)
    ref = jtp.tp_attn_half_partial(
        jnp.asarray(x, jdt), *(jnp.asarray(s[k], jdt) for k in K7_KEYS),
        mask=None if mask is None else jnp.asarray(mask), n_head=nh, interpret=True,
    )
    t = {k: torch.tensor(s[k]).to(tdt) for k in K7_KEYS}
    xln = layer_norm(torch.tensor(x).to(tdt), t["ln_1_scale"], t["ln_1_bias"])
    qkv = torch.cat([dense(xln, t[f"w_{c}"], t[f"b_{c}"]) for c in "qkv"], dim=-1)
    assert qkv.shape[-1] == 3 * 64 // m
    got = matmul_f32(attn_core_plain(qkv, None if mask is None else torch.tensor(mask), nh),
                     t["w_out"])
    assert got.dtype == torch.float32
    _close(got, ref, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_attn_core_on_the_cpu_is_its_plain_twin(dtype, mask_kind):
    """For a CPU tensor the wrapper returns the plain twin's result and
    launches nothing."""
    qkv = torch.tensor(np.random.RandomState(3).randn(2, 21, 3 * 48).astype(np.float32)).to(dtype)
    mask = _mask_np(mask_kind, 21)
    mask = None if mask is None else torch.tensor(mask)
    cuda_lib.reset_launches()
    assert torch.equal(attn_core(qkv, mask, 3), attn_core_plain(qkv, mask, 3))
    assert not any(cuda_lib.LAUNCHES.values())


@pytest.mark.parametrize("shape,n_head,mask_shape,match", [
    ((2, 9, 3, 64), 2, None, r"\[B, L, 3W\]"),   # not 3-D
    ((2, 9, 100), 2, None, r"\[B, L, 3W\]"),     # not three equal widths
    ((2, 9, 96), 3, None, "heads"),              # width 32 in 3 heads
    ((2, 9, 96), 0, None, "heads"),
    ((2, 9, 96), 2, (9, 8), "mask"),
    ((2, 9, 96), 2, (1, 9, 9), "mask"),
])
def test_attn_core_refuses_shapes_it_does_not_take(shape, n_head, mask_shape, match):
    """Shape checks that hold on every device, so a bad call fails the
    same way on the CPU and on the card."""
    qkv = torch.zeros(shape)
    mask = None if mask_shape is None else torch.zeros(mask_shape)
    with pytest.raises(ValueError, match=match):
        attn_core(qkv, mask, n_head)
