"""The port's backward modules against the JAX package.

The plain twins of K3 (``attn_half_bwd_dx``, masked and unmasked) and K4
(``mlp_half_bwd_dx``) — what the wrappers run for a CPU tensor — are held
against the TPU kernels in interpret mode on the same numpy inputs: fp32
atol 1e-4, bf16 1e-2 (inputs are scaled so outputs stay below 2, where one
bf16 rounding step is < 1e-2). The autograd Function around K1-K4 and K6's
autograd wrapper are held against ``jax.grad`` (fp32, atol 1e-4, the
gradient rung of ``tests/test_block_fused.py``).
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.ops import layers as jlayers
from ovmr_tpu.ops.block_fused import fused_residual_block as j_fused_residual_block
from ovmr_tpu.ops.block_fused_bwd import (
    attn_half_bwd_dx as j_attn_half_bwd_dx,
    mlp_half_bwd_dx as j_mlp_half_bwd_dx,
)
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops import layers as tlayers
from ovmr_tpu_torch.ops.attention import fused_attention
from ovmr_tpu_torch.ops.block_fused import BLOCK_KEYS, fused_attn_half, fused_residual_block
from ovmr_tpu_torch.ops.block_fused_bwd import attn_half_bwd_dx, mlp_half_bwd_dx

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


@pytest.fixture(scope="module")
def layer_np():
    """One TINY vision block (D=64) from the JAX package's init_params,
    with non-trivial biases and LN params, as numpy."""
    params = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY)
    p = {k: np.asarray(v[0]) for k, v in params["visual"]["blocks"].items()}
    rng = np.random.RandomState(0)
    for k in ("b_qkv", "b_out", "c_fc_b", "c_proj_b", "ln_1_bias", "ln_2_bias"):
        p[k] = (0.05 * rng.randn(*p[k].shape)).astype(np.float32)
    for k in ("ln_1_scale", "ln_2_scale"):
        p[k] = (1 + 0.1 * rng.randn(*p[k].shape)).astype(np.float32)
    for k in ("w_out", "c_proj_w"):  # keep each half's cotangent below 2
        p[k] = 0.5 * p[k]
    return p


def _inputs(b, l, seed):
    rng = np.random.RandomState(seed)
    x = (0.25 * rng.randn(b, l, 64)).astype(np.float32)
    g = (0.25 * rng.randn(b, l, 64)).astype(np.float32)
    return x, g


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l", [(4, 17), (3, 77)])
def test_mlp_half_bwd_dx_plain_matches_pallas(layer_np, dtype, b, l):
    jdt, tdt, tol = DTYPES[dtype]
    x, g = _inputs(b, l, b + l)
    names = ("c_fc_w", "c_fc_b", "c_proj_w", "ln_2_scale", "ln_2_bias")
    ref = j_mlp_half_bwd_dx(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt),
        *(jnp.asarray(layer_np[k], jdt) for k in names), interpret=True,
    )
    got = mlp_half_bwd_dx(
        torch.tensor(x).to(tdt), torch.tensor(g).to(tdt),
        *(torch.tensor(layer_np[k]).to(tdt) for k in names),
    )
    assert got.dtype == tdt
    assert np.abs(np.asarray(ref, np.float32)).max() < 2.0
    _close(got, ref, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "b,l,n_head,masked", [(4, 17, 2, False), (5, 17, 2, True), (2, 77, 1, True), (3, 9, 4, True)]
)
def test_attn_half_bwd_dx_plain_matches_pallas(layer_np, dtype, b, l, n_head, masked):
    jdt, tdt, tol = DTYPES[dtype]
    x, g = _inputs(b, l, b * 100 + l)
    names = ("w_qkv", "b_qkv", "w_out", "ln_1_scale", "ln_1_bias")
    ref = j_attn_half_bwd_dx(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt),
        *(jnp.asarray(layer_np[k], jdt) for k in names),
        mask=jlayers.causal_mask(l) if masked else None, n_head=n_head, interpret=True,
    )
    got = attn_half_bwd_dx(
        torch.tensor(x).to(tdt), torch.tensor(g).to(tdt),
        *(torch.tensor(layer_np[k]).to(tdt) for k in names),
        mask=tlayers.causal_mask(l) if masked else None, n_head=n_head,
    )
    assert got.dtype == tdt
    assert np.abs(np.asarray(ref, np.float32)).max() < 2.0
    _close(got, ref, tol)


def _jax_block_grads(layer_np, x, masked, wrt_params):
    pj = {k: jnp.asarray(v) for k, v in layer_np.items()}
    mask = jlayers.causal_mask(x.shape[1]) if masked else None

    def loss(x_, p_):
        return jnp.sum(j_fused_residual_block(x_, p_, 2, mask, interpret=True) ** 2)

    return jax.grad(loss, argnums=(0, 1) if wrt_params else 0)(jnp.asarray(x), pj)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_block_dx_matches_jax_grad(layer_np, masked):
    """The Function on the CPU (plain twins both ways, frozen weights)
    against jax.grad through the Pallas block's custom VJP."""
    x_np = np.random.RandomState(11).randn(3, 17, 64).astype(np.float32)
    ref = _jax_block_grads(layer_np, x_np, masked, wrt_params=False)
    x = torch.tensor(x_np, requires_grad=True)
    p = {k: torch.tensor(v) for k, v in layer_np.items()}
    out = fused_residual_block(x, p, 2, tlayers.causal_mask(17) if masked else None)
    (out ** 2).sum().backward()
    _close(x.grad, ref, 1e-4)


def test_fused_block_weight_grads_match_jax_grad(layer_np):
    """With weights that require grad the Function also returns the twelve
    weight cotangents (torch autograd over the torch-math block)."""
    x_np = np.random.RandomState(12).randn(4, 17, 64).astype(np.float32)
    gx, gp = _jax_block_grads(layer_np, x_np, True, wrt_params=True)
    x = torch.tensor(x_np, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in layer_np.items()}
    out = fused_residual_block(x, p, 2, tlayers.causal_mask(17))
    (out ** 2).sum().backward()
    _close(x.grad, gx, 1e-4)
    for k in BLOCK_KEYS:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(gp[k]), atol=1e-4, err_msg=k)


def test_fused_block_only_some_weights_require_grad(layer_np):
    x = torch.randn(2, 9, 64)
    p = {k: torch.tensor(v) for k, v in layer_np.items()}
    p["c_fc_w"].requires_grad_(True)
    out = fused_residual_block(x, p, 2)
    (out ** 2).sum().backward()
    assert x.grad is None and p["c_fc_w"].grad is not None
    ref = {k: torch.tensor(v) for k, v in layer_np.items()}
    ref["c_fc_w"].requires_grad_(True)
    (tlayers.residual_attention_block(x, ref, 2) ** 2).sum().backward()
    np.testing.assert_allclose(p["c_fc_w"].grad.numpy(), ref["c_fc_w"].grad.numpy(), atol=1e-5)


def test_fused_block_saves_x_y_and_the_layer_only(layer_np):
    """What the Function keeps for the backward: the block input, the
    attention half's output, the mask and the twelve layer tensors; nothing
    under no_grad."""
    x = torch.randn(2, 9, 64, requires_grad=True)
    p = {k: torch.tensor(v) for k, v in layer_np.items()}
    mask = tlayers.causal_mask(9)
    out = fused_residual_block(x, p, 2, mask)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 + len(BLOCK_KEYS)
    assert saved[0] is x or torch.equal(saved[0], x)
    y = fused_attn_half(
        x.detach(), *(p[k] for k in BLOCK_KEYS[:6]), mask=mask, n_head=2
    )
    assert torch.equal(saved[1], y)
    with torch.no_grad():
        assert fused_residual_block(x, p, 2, mask).grad_fn is None


def test_fused_block_takes_a_strided_cotangent_of_another_dtype(layer_np):
    x = torch.randn(3, 9, 64, requires_grad=True)
    p = {k: torch.tensor(v) for k, v in layer_np.items()}
    out = fused_residual_block(x, p, 2)
    g = torch.randn(9, 3, 64, dtype=torch.float64).transpose(0, 1)
    (dx,) = torch.autograd.grad(out, x, g)
    x2 = x.detach().clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        tlayers.residual_attention_block(x2, p, 2), x2, g.float().contiguous()
    )
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_attention_gradients_match_jax_grad(masked):
    """K6's autograd wrapper against jax.grad through attention_xla."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 2, 18, 32).astype(np.float32) for _ in range(3))
    mj = jlayers.causal_mask(18) if masked else None

    def loss(q_, k_, v_):
        return jnp.sum(jlayers.attention_xla(q_, k_, v_, mj) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fused_attention(*leaves, tlayers.causal_mask(18) if masked else None)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    for got, want in zip(leaves, ref):
        _close(got.grad, want, 1e-4)


def test_require_no_grad_guards_the_raw_wrappers():
    """The guard every raw kernel wrapper calls on a CUDA tensor: a tracked
    tensor raises while grad mode is on, and passes under no_grad (which is
    how the autograd Functions reach the wrappers)."""
    tracked, plain = torch.zeros(2, requires_grad=True), torch.zeros(2)
    cuda_lib.require_no_grad("k", plain, None)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_lib.require_no_grad("k", plain, tracked)
    with torch.no_grad():
        cuda_lib.require_no_grad("k", plain, tracked)


def test_attn_bwd_core_shared_memory_limit():
    """K3's tiled core (fp32 at every length, bf16/fp16 beyond 128 tokens)
    is tiled over the queries, so a block's shared memory depends on the
    head width alone: at every width the core takes (a multiple of 8 up to
    128) each of its four launches (q-side and kv-side, tensor-core and fp32
    FMA) fits in a block's 227 KB, which the launchers also assert at
    compile time. Sizes from the tile constants of csrc/block_fused_bwd.cu."""
    text = (cuda_lib.CSRC / "block_fused_bwd.cu").read_text()
    c = {}
    for decl in re.findall(r"constexpr int ((?:BT_WARPS|BF_Q) =[^;]*);", text):
        for item in decl.split(","):
            name, expr = (t.strip() for t in item.split("="))
            c[name] = eval(expr, {"__builtins__": {}}, dict(c))
    # every size function of the core takes a head width and nothing else
    sizes = dict(re.findall(r"constexpr size_t (b[tf]_(?:q|kv)_smem)\(int (\w+)\)", text))
    assert sizes == {"bt_q_smem": "dhp", "bt_kv_smem": "dhp", "bf_q_smem": "Dh",
                     "bf_kv_smem": "Dh"}
    assert "AttnBwdLayout" not in text
    qt, kt, stages = c["BT_QT"], c["BT_KT"], c["BT_STAGES"]

    def bt_q(dhp):
        return (2 * qt + stages * 2 * kt) * (dhp + 8) * 2

    def bt_kv(dhp):
        kv_qt = 32 if dhp > 64 else 64
        return (2 * qt + stages * 2 * kv_qt) * (dhp + 8) * 2 + stages * 3 * kv_qt * 4

    def bf_q(dh):
        return ((3 * c["BF_Q"] + 2 * c["BF_K"]) * (dh + 1) + 2 * c["BF_Q"] * (c["BF_K"] + 1)
                + 3 * c["BF_Q"]) * 4

    def bf_kv(dh):
        return ((4 * c["BF_Q"] + 2 * c["BF_K"]) * (dh + 1) + 2 * c["BF_K"] * (c["BF_Q"] + 1)
                + 3 * c["BF_K"]) * 4

    limit = 227 * 1024
    assert (bt_q(128), bt_kv(128), bf_q(128), bf_kv(128)) == (174080, 123008, 132608, 149760)
    for dh in range(8, 129, 8):
        dhp = 64 if dh <= 64 else 128  # the tensor-core kernels zero-pad the head
        assert max(bt_q(dhp), bt_kv(dhp), bf_q(dh), bf_kv(dh)) <= limit
    assert "static_assert(q_bytes <= 227 * 1024 && kv_bytes <= 227 * 1024" in text
    assert "static_assert(bf_q_smem(128) <= 227 * 1024 && bf_kv_smem(128) <= 227 * 1024" in text


def test_dx_wrappers_refuse_other_devices(layer_np):
    x = torch.empty(2, 9, 64, device="meta")
    p = {k: torch.empty(v.shape, device="meta") for k, v in layer_np.items()}
    with pytest.raises(ValueError, match="no kernel"):
        attn_half_bwd_dx(x, x, p["w_qkv"], p["b_qkv"], p["w_out"],
                         p["ln_1_scale"], p["ln_1_bias"], n_head=2)
    with pytest.raises(ValueError, match="no kernel"):
        mlp_half_bwd_dx(x, x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"],
                        p["ln_2_scale"], p["ln_2_bias"])
