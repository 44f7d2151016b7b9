"""What ViT-L/14@336px asks of the port beyond ViT-B/16, on the CPU.

The MLP route (K2 or the chunked K5) against the JAX package's trace-time
selector for every transformer tower of every entry of ``CONFIGS`` (a
ResNet image tower has no blocks), with the JAX kernels stubbed as
``tests/test_block_fused.py::test_vitl_routing`` stubs them; the backward
after a K5 forward (K4 then K3, the unchunked block's dx); K1's wrapper at 577 tokens; the config read from a
state dict with ViT-L shapes; the positional table of a 24 x 24 grid.
"""

import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import ovmr_tpu.ops.block_fused as jbf
from ovmr_tpu.models import clip as jclip
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models.import_torch import clip_params_from_state_dict
from ovmr_tpu_torch.ops import block_fused as tbf
from ovmr_tpu_torch.ops.layers import causal_mask

TOWERS = {
    "vision": lambda c: (c.num_patches + 1, c.vision_width, c.vision_heads),
    "text": lambda c: (c.context_length, c.transformer_width, c.transformer_heads),
}


@pytest.mark.parametrize("name,tower", [
    (name, tower) for name, cfg in tclip.CONFIGS.items() for tower in TOWERS
    if not (tower == "vision" and cfg.is_resnet)  # a ResNet image tower has no blocks
])
def test_mlp_route_matches_the_jax_selector(monkeypatch, name, tower):
    """bf16 sizes, every transformer tower of every config: the port takes
    K5 exactly where ``_fused_block_fwd_impl`` does, with its chunk count:
    only for ViT-L/14@336px's vision tower, in 2 chunks."""
    calls = []
    monkeypatch.setattr(jbf, "fused_attn_half", lambda x, *a, **k: x)
    monkeypatch.setattr(
        jbf, "fused_mlp_half", lambda y, *a, **k: (calls.append(0), y)[1])
    monkeypatch.setattr(
        jbf, "fused_mlp_half_chunked", lambda y, *a, **k: (calls.append(k["chunks"]), y)[1])
    assert tclip.CONFIGS[name] == tclip.CLIPConfig(
        **{f: getattr(jclip.CONFIGS[name], f) for f in tclip.CLIPConfig.__dataclass_fields__})
    l, d, heads = TOWERS[tower](tclip.CONFIGS[name])
    hidden = 4 * d
    z = lambda *shape: jnp.zeros(shape, jnp.bfloat16)  # noqa: E731
    p = {"w_qkv": z(d, 3 * d), "b_qkv": z(3 * d), "w_out": z(d, d), "b_out": z(d),
         "c_fc_w": z(d, hidden), "c_fc_b": z(hidden), "c_proj_w": z(hidden, d),
         "c_proj_b": z(d), "ln_1_scale": z(d), "ln_1_bias": z(d), "ln_2_scale": z(d),
         "ln_2_bias": z(d)}
    # interpret=True keeps the debug towers' 64-wide blocks on the kernel
    # route (the lane-alignment fallback is the TPU compiler's, not a tier)
    jbf._fused_block_fwd_impl(z(2, l, d), p, heads, None, interpret=True)
    assert len(calls) == 1, calls
    got = tbf.mlp_tier_chunks(l, d, hidden)
    assert got == calls[0]
    assert got == (2 if (name, tower) == ("ViT-L/14@336px", "vision") else 0)


def test_route_ignores_the_tensor_dtype():
    """fp32 tensors route as bf16 ones do, so an fp32 check of a path runs
    the kernels of the bf16 path; the fused block follows the route."""
    assert tbf.mlp_tier_chunks(577, 1024, 4096) == 2
    assert tbf.mlp_tier_chunks(257, 1024, 4096) == 0  # ViT-L/14 at 224 px: resident
    assert tbf.mlp_tier_chunks(577, 2048, 8192) == 8  # 64 MiB of weights in 8 MiB chunks
    assert "dtype" not in inspect.signature(tbf.mlp_tier_chunks).parameters


def _block(d, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    shapes = {"w_qkv": (d, 3 * d), "b_qkv": (3 * d,), "w_out": (d, d), "b_out": (d,),
              "ln_1_scale": (d,), "ln_1_bias": (d,), "c_fc_w": (d, 4 * d), "c_fc_b": (4 * d,),
              "c_proj_w": (4 * d, d), "c_proj_b": (d,), "ln_2_scale": (d,), "ln_2_bias": (d,)}
    p = {k: (0.1 * torch.randn(s, generator=g)).to(dtype) for k, s in shapes.items()}
    p["ln_1_scale"] = p["ln_1_scale"] + 1
    p["ln_2_scale"] = p["ln_2_scale"] + 1
    return p


def test_fused_block_follows_the_route_and_backward_after_k5_raises(monkeypatch):
    p = _block(64, seed=0)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(1))
    taken = []
    real = tbf.fused_mlp_half_chunked
    monkeypatch.setattr(tbf, "fused_mlp_half_chunked",
                        lambda *a, **k: (taken.append(k["chunks"]), real(*a, **k))[1])
    resident = tbf.fused_residual_block(x, p, 2)
    assert taken == []
    # the thresholds at zero: this 64-wide block now routes to K5
    monkeypatch.setattr(tbf, "_MLP_W_CUTOFF", 0)
    monkeypatch.setattr(tbf, "_MLP_W_RESIDENT_FWD", 0)
    xg = x.clone().requires_grad_(True)
    chunked = tbf.fused_residual_block(xg, p, 2)
    assert taken == [2]
    torch.testing.assert_close(chunked.detach(), resident, atol=1e-5, rtol=0)
    # the backward after K5 runs K4 then K3, as after K2: the unchunked
    # block's dx
    g = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(2))
    (dx_chunked,) = torch.autograd.grad(chunked, xg, g)
    monkeypatch.undo()
    xr = x.clone().requires_grad_(True)
    (dx_resident,) = torch.autograd.grad(tbf.fused_residual_block(xr, p, 2), xr, g)
    assert taken == [2]
    torch.testing.assert_close(dx_chunked, dx_resident, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_attn_half_takes_577_tokens_and_names_no_320(masked):
    """K1's wrapper has no sequence-length limit left: its source and its
    one remaining refusal speak of the head width only, and the plain
    version it takes on the CPU runs ViT-L/14@336px's 577 tokens."""
    source = inspect.getsource(tbf.fused_attn_half)
    assert "320" not in source and "exceed shared memory" not in source
    assert "head width" in source
    p = _block(64, seed=2)
    x = 0.5 * torch.randn(1, 577, 64, generator=torch.Generator().manual_seed(3))
    mask = causal_mask(577) if masked else None
    a = tuple(p[k] for k in ("w_qkv", "b_qkv", "w_out", "b_out", "ln_1_scale", "ln_1_bias"))
    out = tbf.fused_attn_half(x, *a, mask=mask, n_head=1)
    assert out.shape == x.shape and torch.isfinite(out).all()
    if masked:  # a causal row sees nothing after it: the first token ignores the rest
        x2 = x.clone()
        x2[:, 1:] += 1.0
        out2 = tbf.fused_attn_half(x2, *a, mask=mask, n_head=1)
        torch.testing.assert_close(out2[:, 0], out[:, 0], atol=1e-6, rtol=0)


def test_config_from_a_vit_l_336_state_dict():
    """``clip_config_from_state_dict`` on a synthetic state dict with
    ViT-L/14@336px's shapes at one layer a tower."""
    vw, tw, e = 1024, 768, 768
    z = torch.zeros

    def resblock(prefix, w):
        return {f"{prefix}.attn.in_proj_weight": z(3 * w, w), f"{prefix}.attn.in_proj_bias": z(3 * w),
                f"{prefix}.attn.out_proj.weight": z(w, w), f"{prefix}.attn.out_proj.bias": z(w),
                f"{prefix}.ln_1.weight": z(w), f"{prefix}.ln_1.bias": z(w),
                f"{prefix}.mlp.c_fc.weight": z(4 * w, w), f"{prefix}.mlp.c_fc.bias": z(4 * w),
                f"{prefix}.mlp.c_proj.weight": z(w, 4 * w), f"{prefix}.mlp.c_proj.bias": z(w),
                f"{prefix}.ln_2.weight": z(w), f"{prefix}.ln_2.bias": z(w)}

    sd = {
        "visual.conv1.weight": z(vw, 3, 14, 14), "visual.class_embedding": z(vw),
        "visual.positional_embedding": z(577, vw), "visual.ln_pre.weight": z(vw),
        "visual.ln_pre.bias": z(vw), "visual.ln_post.weight": z(vw), "visual.ln_post.bias": z(vw),
        "visual.proj": z(vw, e), "token_embedding.weight": z(49408, tw),
        "positional_embedding": z(77, tw), "ln_final.weight": z(tw), "ln_final.bias": z(tw),
        "text_projection": z(tw, e), "logit_scale": z(()),
        **resblock("visual.transformer.resblocks.0", vw), **resblock("transformer.resblocks.0", tw),
    }
    params, cfg = clip_params_from_state_dict(sd)
    import dataclasses

    assert cfg == dataclasses.replace(tclip.VIT_L14_336, vision_layers=1, transformer_layers=1)
    assert cfg.vision_heads == 16 and cfg.num_patches + 1 == 577
    assert params["visual"]["patch_embed_w"].shape == (3 * 14 * 14, vw)
    assert params["visual"]["blocks"]["c_fc_w"].shape == (1, vw, 4 * vw)
    assert params["text"]["blocks"]["w_qkv"].shape == (1, tw, 3 * tw)
    # this tower's route: the chunked half, 2 chunks
    assert tbf.mlp_tier_chunks(cfg.num_patches + 1, cfg.vision_width, 4 * cfg.vision_width) == 2


@pytest.mark.parametrize("gh,gw", [(24, 24), (16, 16), (24, 17)])
def test_resize_pos_embed_at_a_24_grid_matches_jax(gh, gw):
    """ViT-L/14@336px's 24 x 24 positional grid: identity at the native
    size, and resized for a 224 px (16 x 16) or ragged input as the JAX
    package resizes it."""
    pe = np.random.RandomState(0).randn(1 + 24 * 24, 8).astype(np.float32)
    got = tclip.resize_pos_embed(torch.tensor(pe), 24, gh, gw)
    ref = jclip.resize_pos_embed(jnp.asarray(pe), 24, gh, gw)
    assert got.shape == (1 + gh * gw, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    if (gh, gw) == (24, 24):
        assert got.data_ptr() == torch.tensor(pe).data_ptr() or np.array_equal(got.numpy(), pe)
