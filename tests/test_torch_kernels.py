"""The port's kernel modules against the JAX package's Pallas kernels.

The plain versions of K1 (``fused_attn_half``, unmasked and causal), K2
(``fused_mlp_half``) and K6 (``fused_attention``) — what the port's kernel
wrappers run for a CPU tensor — are held against the TPU kernels run in
interpret mode, on the same numpy inputs. Tolerances are the ladder of
``tests/test_block_fused.py``: fp32 atol 1e-5, bf16 atol 1e-2 (inputs are
scaled so outputs stay below 2, where one bf16 rounding step is < 1e-2).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.ops import layers as jlayers
from ovmr_tpu.ops.attention import fused_attention as j_fused_attention
from ovmr_tpu.ops.block_fused import (
    fused_attn_half as j_fused_attn_half,
    fused_mlp_half as j_fused_mlp_half,
    fused_residual_block as j_fused_residual_block,
)
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops import layers as tlayers
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr as tovmr
from ovmr_tpu_torch.models.aggregator import generate_vokens
from ovmr_tpu_torch.ops.attention import K6_MAX_KEYS, fused_attention, k6_smem_bytes
from ovmr_tpu_torch.ops.block_fused import (
    fused_attn_half,
    fused_mlp_half,
    fused_residual_block,
)

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


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
    for k in ("w_out", "c_proj_w"):  # keep each half's output below 2
        p[k] = 0.5 * p[k]
    return p


def _both(p_np, x_np, jdt, tdt):
    pj = {k: jnp.asarray(v, jdt) for k, v in p_np.items()}
    pt = {k: torch.tensor(v).to(tdt) for k, v in p_np.items()}
    return pj, jnp.asarray(x_np, jdt), pt, torch.tensor(x_np).to(tdt)


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,n_head,masked", [(4, 17, 2, False), (4, 17, 2, True), (2, 77, 1, True)])
def test_fused_attn_half_plain_matches_pallas(layer_np, dtype, b, l, n_head, masked):
    jdt, tdt, tol = DTYPES[dtype]
    x_np = (0.25 * np.random.RandomState(b * 100 + l).randn(b, l, 64)).astype(np.float32)
    pj, xj, pt, xt = _both(layer_np, x_np, jdt, tdt)
    names = ("w_qkv", "b_qkv", "w_out", "b_out", "ln_1_scale", "ln_1_bias")
    mj = jlayers.causal_mask(l) if masked else None
    mt = tlayers.causal_mask(l) if masked else None
    ref = j_fused_attn_half(xj, *(pj[k] for k in names), mask=mj, n_head=n_head, interpret=True)
    got = fused_attn_half(xt, *(pt[k] for k in names), mask=mt, n_head=n_head)
    assert got.dtype == tdt
    assert np.abs(np.asarray(ref, np.float32)).max() < 2.0
    _close(got, ref, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l", [(4, 17), (3, 77)])
def test_fused_mlp_half_plain_matches_pallas(layer_np, dtype, b, l):
    jdt, tdt, tol = DTYPES[dtype]
    x_np = (0.25 * np.random.RandomState(b + l).randn(b, l, 64)).astype(np.float32)
    pj, xj, pt, xt = _both(layer_np, x_np, jdt, tdt)
    names = ("c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b", "ln_2_scale", "ln_2_bias")
    ref = j_fused_mlp_half(xj, *(pj[k] for k in names), interpret=True)
    got = fused_mlp_half(xt, *(pt[k] for k in names))
    assert got.dtype == tdt
    assert np.abs(np.asarray(ref, np.float32)).max() < 2.0
    _close(got, ref, tol)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_residual_block_plain_matches_pallas(layer_np, masked):
    x_np = np.random.RandomState(7).randn(3, 17, 64).astype(np.float32)
    pj, xj, pt, xt = _both(layer_np, x_np, jnp.float32, torch.float32)
    ref = j_fused_residual_block(
        xj, pj, 2, jlayers.causal_mask(17) if masked else None, interpret=True
    )
    got = fused_residual_block(xt, pt, 2, tlayers.causal_mask(17) if masked else None)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
# the aggregator's L = 18; the fp32 TP check's (8, 12, 4, 64); past 32 keys,
# where the card kernel walks the keys in chunks of 32, masked
@pytest.mark.parametrize("shape,masked", [((2, 8, 18, 32), False), ((2, 1, 17, 64), False),
                                          ((1, 2, 24, 32), True), ((8, 12, 4, 64), False),
                                          ((2, 4, 40, 64), True)])
def test_fused_attention_plain_matches_pallas(dtype, shape, masked):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(sum(shape))
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    mj = jlayers.causal_mask(shape[2]) if masked else None
    mt = tlayers.causal_mask(shape[2]) if masked else None
    ref = j_fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), mj, interpret=True)
    got = fused_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)), mt)
    assert got.dtype == tdt
    _close(got, ref, tol)


def test_fused_attention_takes_every_shape_the_whole_head_kernel_took():
    """K6's card kernel keeps one warp's Q, K and V in shared memory, up to
    256 keys; the whole-head kernel it replaced kept a block's Q, K, V and
    [L, L] scores ((3 L (Dh + 1) + L (L + 1)) fp32 within 227 KB). Every
    head that one took, this one takes."""
    smem = 227 * 1024
    taken = 0
    for l in range(1, 300):
        dh = 1
        while (3 * l * (dh + 1) + l * (l + 1)) * 4 <= smem:
            assert l <= K6_MAX_KEYS and k6_smem_bytes(l, dh) <= smem, (l, dh)
            dh += 1
            taken += 1
    assert taken > 100_000  # heads up to L = 237 and, at L = 1, Dh = 19369


def test_plain_paths_launch_nothing(layer_np):
    """A CPU tensor takes the plain version: no launch is counted."""
    cuda_lib.reset_launches()
    x = torch.randn(2, 9, 64)
    p = {k: torch.tensor(v) for k, v in layer_np.items()}
    fused_residual_block(x, p, 2, tlayers.causal_mask(9))
    fused_residual_block(x, p, 2)
    fused_attention(*(torch.randn(2, 1, 9, 64) for _ in range(3)))
    # and backwards: the dx twins through the autograd Function
    xg = x.clone().requires_grad_(True)
    fused_residual_block(xg, p, 2, tlayers.causal_mask(9)).sum().backward()
    assert xg.grad is not None
    assert all(v == 0 for v in cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES


def test_wrappers_refuse_other_devices(layer_np):
    """Neither a CPU nor a CUDA tensor: the wrappers raise, never compute."""
    x = torch.empty(2, 9, 64, device="meta")
    p = {k: torch.empty(v.shape, device="meta") for k, v in layer_np.items()}
    with pytest.raises(ValueError, match="no kernel"):
        fused_residual_block(x, p, 2)
    with pytest.raises(ValueError, match="no kernel"):
        fused_attention(*(torch.empty(1, 1, 9, 64, device="meta") for _ in range(3)))


def test_models_default_to_the_kernel_wrappers():
    """Called without block_fn/attn_fn, the towers, heads and aggregator
    go through the kernel wrappers, which pick by the tensor's device."""
    import inspect

    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    for fn in (tclip.run_blocks, tclip.encode_image, tclip.encode_text,
               tclip.encode_text_embeds, tovmr.text_classifier, tovmr.classifier_heads,
               tovmr.generate_classifiers_from_feats):
        assert default(fn, "block_fn") is fused_residual_block, fn.__name__
    from ovmr_tpu_torch.engine import train_step

    for fn in (train_step.frozen_features, train_step.classifier_loss,
               train_step.make_train_step):
        assert default(fn, "block_fn") is fused_residual_block, fn.__name__
    for fn in (generate_vokens, tovmr.classifier_heads, tovmr.generate_classifiers_from_feats,
               train_step.classifier_loss, train_step.make_train_step):
        assert default(fn, "attn_fn") is fused_attention, fn.__name__


def test_launch_counts_by_shape():
    cuda_lib.reset_launches()
    x = torch.empty(2, 9, 64, dtype=torch.bfloat16)
    cuda_lib.count_launch("fused_mlp_half", x)
    cuda_lib.count_launch("fused_mlp_half", x)
    cuda_lib.count_launch("fused_attention", torch.empty(1, 2, 9, 64))
    assert set(cuda_lib.LAUNCHES) == {
        "fused_attn_half", "fused_attn_half_masked", "attn_core", "fused_mlp_half",
        "fused_mlp_half_chunked", "fused_attention",
        "attn_half_bwd_dx", "attn_half_bwd_dx_masked", "mlp_half_bwd_dx",
        "tp_attn_half_partial", "tp_attn_half_partial_masked", "tp_mlp_half_partial",
        "gemm_wgmma", "attn_bwd_core_short", "attn_bwd_core_tiled",
    }
    for name in ("attn_half_bwd_dx", "attn_half_bwd_dx_masked", "mlp_half_bwd_dx"):
        cuda_lib.count_launch(name, x)
        assert cuda_lib.LAUNCHES[name] == 1
        assert cuda_lib.LAUNCH_SHAPES[(name, (2, 9, 64), "bfloat16")] == 1
    assert cuda_lib.LAUNCHES["fused_mlp_half"] == 2
    assert cuda_lib.LAUNCH_SHAPES[
        cuda_lib.shape_key("fused_mlp_half", (2, 9, 64), torch.bfloat16)] == 2
    assert cuda_lib.LAUNCH_SHAPES[("fused_attention", (1, 2, 9, 64), "float32")] == 1
    # a tensor-parallel partial is keyed by its shard's width too
    cuda_lib.count_launch("tp_mlp_half_partial", x, shape=(2, 9, 64, 128))
    assert cuda_lib.LAUNCH_SHAPES[("tp_mlp_half_partial", (2, 9, 64, 128), "bfloat16")] == 1
    # the attention core by (B, L, W, heads)
    cuda_lib.count_launch("attn_core", x, shape=(2, 9, 64, 2))
    assert cuda_lib.LAUNCH_SHAPES[("attn_core", (2, 9, 64, 2), "bfloat16")] == 1
    # the GEMM inside K1-K5, K7 and K8 and K3's core are counted by name only
    shapes = dict(cuda_lib.LAUNCH_SHAPES)
    cuda_lib.count_inner_launch("gemm_wgmma")
    cuda_lib.count_inner_launch("attn_bwd_core_short")
    assert cuda_lib.LAUNCHES["gemm_wgmma"] == 1 and dict(cuda_lib.LAUNCH_SHAPES) == shapes
    assert cuda_lib.LAUNCHES["attn_bwd_core_short"] == 1
    cuda_lib.reset_launches()
    assert not cuda_lib.LAUNCH_SHAPES and not any(cuda_lib.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the torch-math layer against ovmr_tpu.ops.layers
# ---------------------------------------------------------------------------


def test_layers_match_jax(layer_np):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 17, 64).astype(np.float32)
    pj = {k: jnp.asarray(v) for k, v in layer_np.items()}
    pt = {k: torch.tensor(v) for k, v in layer_np.items()}
    xj, xt = jnp.asarray(x), torch.tensor(x)
    pairs = [
        (jlayers.layer_norm(xj, pj["ln_1_scale"], pj["ln_1_bias"]),
         tlayers.layer_norm(xt, pt["ln_1_scale"], pt["ln_1_bias"])),
        (jlayers.quick_gelu(xj), tlayers.quick_gelu(xt)),
        (jlayers.dense(xj, pj["c_fc_w"], pj["c_fc_b"]), tlayers.dense(xt, pt["c_fc_w"], pt["c_fc_b"])),
        (jlayers.mlp_block(xj, pj), tlayers.mlp_block(xt, pt)),
        (jlayers.split_heads(xj, 2), tlayers.split_heads(xt, 2)),
        (jlayers.merge_heads(jlayers.split_heads(xj, 2)), tlayers.merge_heads(tlayers.split_heads(xt, 2))),
        (jlayers.l2_normalize(xj), tlayers.l2_normalize(xt)),
        (jlayers.causal_mask(9), tlayers.causal_mask(9)),
    ]
    for mask_j, mask_t in ((None, None), (jlayers.causal_mask(17), tlayers.causal_mask(17))):
        pairs.append((jlayers.multi_head_attention(xj, pj, 2, mask_j),
                      tlayers.multi_head_attention(xt, pt, 2, mask_t)))
        pairs.append((jlayers.residual_attention_block(xj, pj, 2, mask_j),
                      tlayers.residual_attention_block(xt, pt, 2, mask_t)))
    for i, (ref, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0, err_msg=str(i))


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_matches_attention_xla(masked):
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 2, 19, 32).astype(np.float32) for _ in range(3))
    ref = jlayers.attention_xla(*(jnp.asarray(a) for a in (q, k, v)),
                                jlayers.causal_mask(19) if masked else None)
    got = tlayers.attention_plain(*(torch.tensor(a) for a in (q, k, v)),
                                  tlayers.causal_mask(19) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
