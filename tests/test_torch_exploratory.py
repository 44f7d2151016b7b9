"""The port's exploratory encode variants (``ovmr_tpu_torch/models/exploratory.py``)
against the torch golden ``exploratory_golden.npz`` (recorded from the
reference ``clip/model.py``) and against the JAX functions
(``ovmr_tpu/models/exploratory.py``), on the CPU at fp32.

- every golden the JAX test replays, through the port: 3e-5, and 1e-4 for
  the 25 shifted encodes (``tests/test_exploratory.py``'s tolerances);
- the paths whose reference bodies cannot run, against the JAX functions
  on the same params and inputs: ``get_avg_patch_embed``,
  ``forward_with_new_pos`` (a fixed generator), ``block_with_image_feat_map``
  (an adapter given to both), ``build_multi_pos``'s tables and masks, and
  ``last_visual_attention_mask``, within 1e-5.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmr_tpu.models import exploratory as jex
from ovmr_tpu_torch.models import exploratory as ex
from ovmr_tpu_torch.models.import_torch import TORCH_BLOCK_KEYS, clip_params_from_state_dict

FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), "fixtures", "exploratory_golden.npz")
ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd.") and not k.startswith("sd.qk")}
    params, cfg = clip_params_from_state_dict(sd)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    return data, params, cfg, jparams


def _t(data, key):
    return torch.from_numpy(data[key])


@pytest.mark.parametrize("fn,arg,out", [
    ("forward_with_embeds", "with_embeds.in", "with_embeds.out"),
    ("forward_v", "forward_v.in", "forward_v.out"),
    ("forward_new_cls", "new_cls.in", "new_cls.out"),
    ("encode_exemplar_mmclassifier", "exemplar_mm.in", "exemplar_mm.out"),
    ("forward_with_mmclassifier", "with_mm.in", "with_mm.out"),
])
def test_variants_match_golden(golden, fn, arg, out):
    data, params, cfg, _ = golden
    got = getattr(ex, fn)(params, cfg, _t(data, "images"), _t(data, arg))
    np.testing.assert_allclose(got.numpy(), data[out], atol=ATOL)


def test_eTT_multi_cls_and_exemplar_match_golden(golden):
    from ovmr_tpu_torch.models import clip as tclip

    data, params, cfg, _ = golden
    images = _t(data, "images")
    eTT = ex.forward_eTT(params, cfg, images, prefix_token=torch.ones(3, 64))
    np.testing.assert_allclose(eTT.numpy(), data["eTT.out"], atol=ATOL)
    # the reference body ignores prefix_token: eTT is the plain encode
    from ovmr_tpu_torch.ops.layers import residual_attention_block

    plain = tclip.encode_image(params, cfg, images, block_fn=residual_attention_block)
    np.testing.assert_allclose(eTT.numpy(), plain.numpy(), atol=1e-6)
    x0, x1 = ex.forward_multi_cls(params, cfg, images, _t(data, "multi_cls.in"))
    np.testing.assert_allclose(x0.numpy(), data["multi_cls.out0"], atol=ATOL)
    np.testing.assert_allclose(x1.numpy(), data["multi_cls.out1"], atol=ATOL)
    cls_f, patch_f = ex.encode_exemplar(params, cfg, images)
    np.testing.assert_allclose(cls_f.numpy(), data["exemplar.cls"], atol=ATOL)
    np.testing.assert_allclose(patch_f.numpy(), data["exemplar.patches"], atol=ATOL)
    assert ex.forward_with_mmclassfier is ex.forward_with_mmclassifier


def test_multi_pos_matches_golden_and_jax_tables(golden):
    data, params, cfg, jparams = golden
    out = ex.forward_multi_pos(params, cfg, _t(data, "images"))
    assert tuple(out.shape) == (25, 2, cfg.embed_dim)
    np.testing.assert_allclose(out.numpy(), data["multi_pos.out"], atol=1e-4)
    pos, keep = ex.build_multi_pos(params, cfg, max_bias=2, stride=2)
    jpos, jkeep = jex.build_multi_pos(jparams, cfg, max_bias=2, stride=2)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def _block(data, prefix):
    return {key: torch.from_numpy(data[prefix + theirs].T.copy() if transpose
                                  else data[prefix + theirs])
            for key, theirs, transpose in TORCH_BLOCK_KEYS}


def test_block_variants_match_golden(golden):
    from ovmr_tpu_torch.ops.layers import causal_mask, layer_norm

    data, _, _, _ = golden
    p = _block(data, "qk.sd.")
    x = _t(data, "qk.x").permute(1, 0, 2).contiguous()  # LND -> BLD
    xln = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
    q_adapt = xln @ _t(data, "qk.q_w").T + _t(data, "qk.q_b")
    k_adapt = xln @ _t(data, "qk.k_w").T + _t(data, "qk.k_b")
    out = ex.residual_block_with_qk(x, p, 2, q_adapt, k_adapt, causal_mask(x.shape[1]))
    np.testing.assert_allclose(out.numpy(), data["qk.out"].transpose(1, 0, 2), atol=ATOL)

    layers = [_block(data, f"attn.sd.resblocks.{i}.") for i in range(2)]
    blocks = {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}
    x = _t(data, "attn.x").permute(1, 0, 2).contiguous()
    out, probs = ex.run_blocks_with_attention(x, blocks, 2)
    np.testing.assert_allclose(out.numpy(), data["attn.out"].transpose(1, 0, 2), atol=ATOL)
    # torch's need_weights=True averages the heads
    np.testing.assert_allclose(probs.mean(dim=2).numpy(), data["attn.weights"], atol=ATOL)


def test_avg_patch_embed_and_new_pos_match_jax(golden):
    data, params, cfg, jparams = golden
    images = _t(data, "images")
    got = ex.get_avg_patch_embed(params, cfg, images)
    want = jex.get_avg_patch_embed(jparams, cfg, jnp.asarray(data["images"]))
    assert tuple(got.shape) == (2, cfg.vision_width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    n = cfg.num_patches
    w = np.random.default_rng(0).standard_normal((cfg.vision_width, n)).astype(np.float32) * 0.1
    kv = np.ones((2, 4, cfg.vision_width), np.float32)
    feats, center = ex.forward_with_new_pos(
        params, cfg, images, lambda t, k: torch.einsum("bnd,dm->bnm", t, torch.from_numpy(w)),
        torch.from_numpy(kv))
    jfeats, jcenter = jex.forward_with_new_pos(
        jparams, cfg, jnp.asarray(data["images"]),
        lambda t, k: jnp.einsum("bnd,dm->bnm", t, jnp.asarray(w)), jnp.asarray(kv))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-5)
    np.testing.assert_array_equal(center.numpy(), np.asarray(jcenter))


def test_feat_map_block_and_mask_match_jax(golden):
    from ovmr_tpu_torch.ops.layers import residual_attention_block

    data, _, _, _ = golden
    p = _block(data, "attn.sd.resblocks.0.")
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((2, 6, 64))).astype(np.float32)
    feats = rng.standard_normal((2, 5, 64)).astype(np.float32)
    adapter = ex.init_feat_map_adapter(torch.Generator().manual_seed(2), 64)
    assert set(adapter) == set(jex.init_feat_map_adapter(jax.random.PRNGKey(2), 64))
    jadapter = {k: jnp.asarray(v.numpy()) for k, v in adapter.items()}
    out = ex.block_with_image_feat_map(torch.from_numpy(x), p, adapter, torch.from_numpy(feats),
                                       n_head=2)
    want = jex.block_with_image_feat_map(jnp.asarray(x), jp, jadapter, jnp.asarray(feats),
                                         n_head=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    # the context tokens are the plain block's; the rest move by one vector
    plain = residual_attention_block(torch.from_numpy(x), p, 2)
    np.testing.assert_allclose(out[:, :2].numpy(), plain[:, :2].numpy(), atol=1e-6)
    np.testing.assert_array_equal(ex.last_visual_attention_mask(5).numpy(),
                                  np.asarray(jex.last_visual_attention_mask(5)))
