"""The port's chunked MLP half (K5) against the JAX package's Pallas kernel.

``ovmr_tpu_torch.ops.block_fused.fused_mlp_half_chunked`` takes its plain
version for a CPU tensor; it is held against
``ovmr_tpu.ops.block_fused.fused_mlp_half_chunked`` run in interpret mode on
the same numpy inputs (fp32 atol 1e-5, bf16 atol 1e-2, the ladder of
``tests/test_block_fused.py``), against a step-by-step rendering of the
Pallas body that shows the activation-dtype accumulation, inside a tower
whose every block is K1 + K5 in both packages, and inside the serving slice
on a small ViT-L-shaped model against the JAX ``OVMRGenerator``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.api import OVMRGenerator as JGen
from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu.ops import block_fused as jbf
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.api import OVMRGenerator
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr as tovmr
from ovmr_tpu_torch.ops import block_fused as tbf
from ovmr_tpu_torch.ops import cuda_lib

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
MLP_KEYS = ("c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b", "ln_2_scale", "ln_2_bias")
ATTN_KEYS = ("w_qkv", "b_qkv", "w_out", "b_out", "ln_1_scale", "ln_1_bias")


@pytest.fixture(scope="module")
def layer_np():
    """One TINY vision block (D=64, hidden 256) from the JAX package's
    init_params, with non-trivial biases and LN params, as numpy; c_proj
    halved so the half's output stays below 2 (one bf16 step < 1e-2)."""
    params = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY)
    p = {k: np.asarray(v[0]) for k, v in params["visual"]["blocks"].items()}
    rng = np.random.RandomState(0)
    for k in ("c_fc_b", "c_proj_b", "ln_2_bias"):
        p[k] = (0.05 * rng.randn(*p[k].shape)).astype(np.float32)
    p["ln_2_scale"] = (1 + 0.1 * rng.randn(*p["ln_2_scale"].shape)).astype(np.float32)
    p["c_proj_w"] = 0.5 * p["c_proj_w"]
    return p


def _mlp_args(layer_np, x_np, jdt, tdt):
    aj = [jnp.asarray(x_np, jdt)] + [jnp.asarray(layer_np[k], jdt) for k in MLP_KEYS]
    at = [torch.tensor(x_np).to(tdt)] + [torch.tensor(layer_np[k]).to(tdt) for k in MLP_KEYS]
    return aj, at


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunks", [2, 3, 4])  # 3 is raised to 4, a divisor of 256
@pytest.mark.parametrize("b,l", [(4, 17), (3, 77)])
def test_chunked_mlp_half_plain_matches_pallas(layer_np, dtype, chunks, b, l):
    jdt, tdt, tol = DTYPES[dtype]
    x_np = (0.25 * np.random.RandomState(b + l).randn(b, l, 64)).astype(np.float32)
    aj, at = _mlp_args(layer_np, x_np, jdt, tdt)
    ref = np.asarray(jbf.fused_mlp_half_chunked(*aj, chunks=chunks, interpret=True), np.float32)
    cuda_lib.reset_launches()
    got = tbf.fused_mlp_half_chunked(*at, chunks=chunks)
    assert got.dtype == tdt and not any(cuda_lib.LAUNCHES.values())
    assert np.abs(ref).max() < 2.0
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)


def test_chunks_rise_to_a_divisor(layer_np):
    x_np = np.random.RandomState(1).randn(2, 9, 64).astype(np.float32)
    _, at = _mlp_args(layer_np, x_np, jnp.float32, torch.float32)
    assert tbf._chunk_width(256, 3) == 64 and tbf._chunk_width(256, 5) == 32
    assert tbf._chunk_width(4096, 2) == 2048
    assert torch.equal(tbf.fused_mlp_half_chunked(*at, chunks=3),
                       tbf.fused_mlp_half_chunked(*at, chunks=4))


def _rendering(x, w1, b1, w2, b2, ln_s, ln_b, chunks):
    """``_mlp_half_chunked_kernel`` line by line, one hidden chunk per
    grid step j, every cast where the body casts."""
    dtype = x.dtype
    hc = w1.shape[1] // chunks
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(-1, keepdim=True)
    xln = (centered * torch.rsqrt(var + 1e-5) * ln_s.float() + ln_b.float()).to(dtype)
    o = x + b2.float().expand_as(x).to(dtype)  # j == 0: residual + the c_proj bias
    for j in range(chunks):
        h = xln.float() @ w1[:, j * hc:(j + 1) * hc].float() + b1[j * hc:(j + 1) * hc].float()
        h = (h * torch.sigmoid(1.702 * h)).to(dtype)
        part = h.float() @ w2[j * hc:(j + 1) * hc].float()
        o = o + part.to(dtype)  # accumulated in the activation dtype
    return o


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_plain_accumulates_in_the_activation_dtype(layer_np, dtype):
    """The plain version is the Pallas body step by step: bit-equal to a
    line-by-line rendering. In bf16 that makes it differ from K2's plain
    version (which sums the whole hidden width in fp32) while staying
    within 1e-2 of it and of the JAX kernel."""
    jdt, tdt, tol = DTYPES[dtype]
    x_np = (0.25 * np.random.RandomState(5).randn(4, 17, 64)).astype(np.float32)
    aj, at = _mlp_args(layer_np, x_np, jdt, tdt)
    got = tbf.fused_mlp_half_chunked_plain(*at, chunks=4)
    assert torch.equal(got, _rendering(*at, chunks=4))
    k2 = tbf.fused_mlp_half_plain(*at)
    diff = float((got.float() - k2.float()).abs().max())
    if dtype == "bf16":
        assert 0 < diff <= tol  # the partial sums' extra roundings, and no more
    else:
        assert diff <= 1e-6
    ref = np.asarray(jbf.fused_mlp_half_chunked(*aj, chunks=4, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j_block(h, p, n_head, mask):
    y = jbf.fused_attn_half(h, *(p[k] for k in ATTN_KEYS), mask=mask, n_head=n_head,
                            interpret=True)
    return jbf.fused_mlp_half_chunked(y, *(p[k] for k in MLP_KEYS), chunks=2, interpret=True)


def _t_block(h, p, n_head, mask):
    y = tbf.fused_attn_half(h, *(p[k] for k in ATTN_KEYS), mask=mask, n_head=n_head)
    return tbf.fused_mlp_half_chunked(y, *(p[k] for k in MLP_KEYS), chunks=2)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_tower_of_k1_and_k5_matches_jax(tower):
    """A TINY tower whose every block is K1 + K5 in both packages (the JAX
    side in interpret mode), the parameters carried over by ``convert``:
    K5 takes K2's leaves, so nothing new is converted."""
    jp = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY)
    tp = convert.clip_params_from_numpy(_np_tree(jp))
    if tower == "vision":
        images = np.random.RandomState(1).rand(3, 3, 32, 32).astype(np.float32)
        ref = jclip.encode_image(jp, jclip.TINY, jnp.asarray(images), block_fn=_j_block)
        got = tclip.encode_image(tp, tclip.TINY, torch.tensor(images), block_fn=_t_block)
    else:
        tokens, _, _ = tovmr.build_prompt_tokens(["golden retriever", "tabby cat"])
        ref = jclip.encode_text(jp, jclip.TINY, jnp.asarray(tokens), block_fn=_j_block)
        got = tclip.encode_text(tp, tclip.TINY, torch.tensor(tokens), block_fn=_t_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# ViT-L/14's proportions at a small size: patch 14, vision wider than the
# embedding, text heads = width // 64, and 56 px -> 4 x 4 patches + 1 = 17
# tokens (odd, as 577 is)
SMALL_L = dict(embed_dim=64, image_resolution=56, vision_layers=2, vision_width=128,
               vision_patch_size=14, transformer_width=64, transformer_heads=1,
               transformer_layers=2)
TOL = {"mm_classifier": 1e-4, "vision_classifier": 1e-4, "text_classifier": 1e-4,
       "visual_tokens": 1e-4, "fusion_weight": 1e-3}


@pytest.mark.parametrize("route", ["as_routed", "chunked"])
def test_slice_on_a_small_vit_l_shape_matches_jax(monkeypatch, route):
    """``OVMRGenerator.generate``/``classify`` on a ViT-L-shaped model
    against the JAX generator, at the tolerances of ``test_torch_api.py``;
    once as the port routes this size (K2) and once with the residency
    thresholds at zero, so every block of both towers takes K5."""
    if route == "chunked":
        monkeypatch.setattr(tbf, "_MLP_W_CUTOFF", 0)
        monkeypatch.setattr(tbf, "_MLP_W_RESIDENT_FWD", 0)
    jcfg, tcfg = jclip.CLIPConfig(**SMALL_L), tclip.CLIPConfig(**SMALL_L)
    assert tcfg.num_patches + 1 == 17 and tcfg.vision_heads == 2
    assert bool(tbf.mlp_tier_chunks(17, 128, 512)) == (route == "chunked")
    key = jax.random.PRNGKey(3)
    cp = _np_tree(jclip.init_params(key, jcfg))
    ap = _np_tree(j_init_aggregator(key, width=64, layers=2, n_ctx=2))
    jg = JGen(cp, jcfg, ap, dtype=jnp.float32)
    tg = OVMRGenerator(convert.clip_params_from_numpy(cp), tcfg,
                       convert.aggregator_params_from_numpy(ap), dtype=torch.float32,
                       device="cpu")
    rng = np.random.RandomState(0)
    exemplars = (rng.rand(3, 1, 3, 56, 56) + 0.3 * rng.rand(3, 2, 3, 56, 56)).astype(np.float32)
    names = ["red circle", "green square", "café crème"]
    ref, got = jg.generate(names, exemplars), tg.generate(names, exemplars)
    assert set(got) == set(ref)
    for k, want in ref.items():
        np.testing.assert_allclose(got[k], want, atol=TOL[k], rtol=0, err_msg=k)
    queries = rng.rand(4, 3, 56, 56).astype(np.float32)
    np.testing.assert_allclose(tg.classify(queries, got, mode="fusion"),
                               jg.classify(queries, ref, mode="fusion"), atol=1e-4, rtol=0)
