"""The port's towers, aggregator, heads, fusion and importers against the
JAX package (fp32, CPU, TINY) and against the torch-recorded goldens.

Parameters come from ``ovmr_tpu``'s own ``init_params``/``init_aggregator``
and are carried over with ``ovmr_tpu_torch.convert``; inputs are numpy
arrays from a seed. Tolerances per stage: 1e-5 for a tower, 1e-4 for what
runs a tower twice (heads), 1e-3 for fusion weights; the goldens keep the
tolerances of their JAX tests (``test_clip_parity.py``,
``test_forward_prompt_parity.py``).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models import ovmr as jovmr
from ovmr_tpu.models.aggregator import generate_vokens as j_generate_vokens
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu.ops import fusion as jfusion
from ovmr_tpu.ops.layers import l2_normalize as j_l2_normalize
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr as tovmr
from ovmr_tpu_torch.models import zoo
from ovmr_tpu_torch.models.aggregator import generate_vokens, init_aggregator
from ovmr_tpu_torch.models.import_torch import (
    clip_params_from_state_dict,
    load_clip,
    load_prompt_learner,
    prompt_learner_params_from_state_dict,
)
from ovmr_tpu_torch.ops import fusion as tfusion
from ovmr_tpu_torch.ops.attention import fused_attention
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import attention_plain, residual_attention_block

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BLOCK_FNS = {"torch_math": residual_attention_block, "fused": fused_residual_block}
ATTN_FNS = {"plain": attention_plain, "fused": fused_attention}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    key = jax.random.PRNGKey(0)
    jp = jclip.init_params(key, jclip.TINY)
    ja = j_init_aggregator(key, width=64, layers=2, n_ctx=2)
    tp = convert.clip_params_from_numpy(_np_tree(jp))
    ta = convert.aggregator_params_from_numpy(_np_tree(ja))
    return jp, tp, ja, ta


def _unit_feats(seed, shape):
    f = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _close(got, ref, atol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0
    )


@pytest.mark.parametrize("block", list(BLOCK_FNS))
def test_encode_image_matches_jax(tiny, block):
    jp, tp, _, _ = tiny
    images = np.random.RandomState(1).rand(3, 3, 32, 32).astype(np.float32)
    ref = jclip.encode_image(jp, jclip.TINY, jnp.asarray(images))
    got = tclip.encode_image(tp, tclip.TINY, torch.tensor(images), block_fn=BLOCK_FNS[block])
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("block", list(BLOCK_FNS))
def test_encode_text_and_embeds_match_jax(tiny, block):
    jp, tp, _, _ = tiny
    tokens, eot, _ = tovmr.build_prompt_tokens(["golden retriever", "tabby cat", "a b c"])
    bf = BLOCK_FNS[block]
    ref = jclip.encode_text(jp, jclip.TINY, jnp.asarray(tokens))
    got = tclip.encode_text(tp, tclip.TINY, torch.tensor(tokens), block_fn=bf)
    _close(got, ref, 1e-5)
    # prompt side: embeddings sliced to 40 positions, explicit EOT index
    emb_j = jclip.embed_tokens(jp, jnp.asarray(tokens[:, :40]))
    emb_t = tclip.embed_tokens(tp, torch.tensor(tokens[:, :40]))
    _close(emb_t, emb_j, 0)
    ref = jclip.encode_text_embeds(jp, jclip.TINY, emb_j, jnp.asarray(eot))
    got = tclip.encode_text_embeds(tp, tclip.TINY, emb_t, torch.tensor(eot), block_fn=bf)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("gh,gw", [(3, 2), (1, 1), (4, 4)])
def test_resize_pos_embed_matches_jax(gh, gw):
    pe = np.random.RandomState(2).randn(1 + 2 * 2, 8).astype(np.float32)
    ref = jclip.resize_pos_embed(jnp.asarray(pe), 2, gh, gw)
    got = tclip.resize_pos_embed(torch.tensor(pe), 2, gh, gw)
    _close(got, ref, 1e-6)
    pe7 = np.random.RandomState(3).randn(1 + 7 * 7, 4).astype(np.float32)
    _close(tclip.resize_pos_embed(torch.tensor(pe7), 7, gh, gw),
           jclip.resize_pos_embed(jnp.asarray(pe7), 7, gh, gw), 1e-6)


def test_patch_embed_and_cast_params(tiny):
    jp, tp, _, _ = tiny
    images = np.random.RandomState(4).rand(2, 3, 40, 33).astype(np.float32)
    w = jp["visual"]["patch_embed_w"]
    ref = jclip.patch_embed_grid(jnp.asarray(images), w, 16)
    got = tclip.patch_embed_grid(torch.tensor(images), tp["visual"]["patch_embed_w"], 16)
    _close(got, ref, 1e-5)
    cast = tclip.cast_params(tp, torch.bfloat16)
    assert cast["logit_scale"].dtype == torch.float32
    assert cast["visual"]["blocks"]["w_qkv"].dtype == torch.bfloat16
    assert cast["text"]["token_embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("attn", list(ATTN_FNS))
def test_generate_vokens_matches_jax(tiny, attn):
    _, _, ja, ta = tiny
    feats = _unit_feats(5, (4, 3, 64))
    ref = j_generate_vokens(ja, jnp.asarray(feats))
    got = generate_vokens(ta, torch.tensor(feats), attn_fn=ATTN_FNS[attn])
    assert got.shape == (4, 2, 64)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("block", list(BLOCK_FNS))
def test_classifier_heads_match_jax(tiny, block):
    jp, tp, ja, ta = tiny
    names = ["red circle", "green square", "blue triangle", "crème brûlée"]
    ptok, eot, vtok = tovmr.build_prompt_tokens(names)
    jtok = jovmr.build_prompt_tokens(names)
    for a, b in zip(jtok, (ptok, eot, vtok)):
        np.testing.assert_array_equal(a, b)
    feats = _unit_feats(6, (4, 3, 64))
    pe_j = jclip.embed_tokens(jp, jnp.asarray(ptok))
    ve_j = jnp.broadcast_to(jclip.embed_tokens(jp, jnp.asarray(vtok)[None]), (4, 77, 64))
    ref = jovmr.classifier_heads(jp, jclip.TINY, ja, jnp.asarray(feats), pe_j, ve_j,
                                 jnp.asarray(eot))
    pe_t, ve_t = tovmr.prompt_embeddings(tp, torch.tensor(feats), torch.tensor(ptok),
                                         torch.tensor(vtok))
    got = tovmr.classifier_heads(tp, tclip.TINY, ta, torch.tensor(feats), pe_t, ve_t,
                                 torch.tensor(eot), attn_fn=fused_attention,
                                 block_fn=BLOCK_FNS[block])
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)
    # splice layout: [tok[:, :2], vokens, tok[:, 2:77-n_ctx]]
    spliced = tovmr.splice_prompts(pe_t, got[2])
    np.testing.assert_array_equal(spliced[:, 2:4].numpy(), got[2].numpy())
    np.testing.assert_array_equal(spliced[:, 4:].numpy(), pe_t[:, 2:75].numpy())
    t_ref = jovmr.text_classifier(jp, jclip.TINY, jnp.asarray(ptok))
    t_got = tovmr.text_classifier(tp, tclip.TINY, torch.tensor(ptok), block_fn=BLOCK_FNS[block])
    _close(t_got, t_ref, 1e-4)


def _fusion_inputs(n=5, k=3, d=16, seed=7):
    feats = _unit_feats(seed, (n, k, d))
    cls = [_unit_feats(seed + i, (n, d)) for i in range(1, 4)]
    # make each classifier right on some exemplars so the F1s differ
    cls[0][:2] = feats[:2, 0]
    cls[1][1:4] = feats[1:4, 1]
    return feats, cls


@pytest.mark.parametrize("row_chunk", [4, 5, 8192])
def test_streaming_fusion_weights_match_jax(row_chunk):
    feats, cls = _fusion_inputs()
    m = feats.shape[0] * feats.shape[1]
    labels = np.repeat(np.arange(5), 3)
    mask = np.array([True, True, False, True, True])
    for class_mask in (None, mask):
        ref = jfusion.streaming_fusion_weights(
            jnp.asarray(feats.reshape(m, -1)), jnp.asarray(labels),
            [jnp.asarray(c) for c in cls], 100.0, 10.0,
            class_mask=None if class_mask is None else jnp.asarray(class_mask),
            row_chunk=row_chunk,
        )
        got = tfusion.streaming_fusion_weights(
            torch.tensor(feats.reshape(m, -1)), torch.tensor(labels),
            [torch.tensor(c) for c in cls], 100.0, 10.0,
            class_mask=None if class_mask is None else torch.tensor(class_mask),
            row_chunk=row_chunk,
        )
        _close(got, ref, 1e-3)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_fusion_from_classifiers_streamed_equals_unchunked():
    feats, cls = _fusion_inputs()
    args = (torch.tensor(feats), *(torch.tensor(c) for c in cls), 100.0, 10.0)
    whole = tovmr.fusion_from_classifiers(*args)
    streamed = tovmr.fusion_from_classifiers(*args, row_chunk=4)
    np.testing.assert_array_equal(whole.numpy(), streamed.numpy())
    ref = jovmr.fusion_from_classifiers(jnp.asarray(feats), *(jnp.asarray(c) for c in cls),
                                        100.0, 10.0)
    _close(whole, ref, 1e-3)


def test_f1_counts_drop_padding_markers():
    """jnp.bincount(length=n) drops labels >= n; torch.bincount would grow."""
    preds = torch.tensor([0, 1, 1, 2, 0])
    labels = torch.tensor([0, 1, 2, 3, 3])  # 3 == n: padding marker
    w = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    got = tfusion.f1_counts_from_preds(preds, labels, 3, weights=w)
    ref = jfusion.f1_counts_from_preds(jnp.asarray(preds.numpy()), jnp.asarray(labels.numpy()),
                                       3, weights=jnp.asarray(w.numpy()))
    for g, r in zip(got, ref):
        assert g.shape == (3,)
        _close(g, r, 0)


def test_eval_logits_match_jax():
    feats = _unit_feats(8, (6, 16))
    _, cls = _fusion_inputs()
    fw = np.random.RandomState(9).dirichlet(np.ones(3), size=5).astype(np.float32)
    cj = {"mm_classifier": cls[0], "vision_classifier": cls[1], "text_classifier": cls[2],
          "fusion_weight": fw}
    for mode in ("text", "vision", "multimodal", "fusion"):
        ref = jovmr.eval_logits(jnp.asarray(feats), {k: jnp.asarray(v) for k, v in cj.items()},
                                50.0, mode)
        got = tovmr.eval_logits(torch.tensor(feats), {k: torch.tensor(v) for k, v in cj.items()},
                                50.0, mode)
        _close(got, ref, 1e-6)
        np.testing.assert_allclose(tovmr.eval_logits_np(feats, cj, 50.0, mode),
                                   jovmr.eval_logits_np(feats, cj, 50.0, mode), atol=1e-6)
    partial = {k: v for k, v in cj.items() if k in ("mm_classifier", "vision_classifier")}
    for mode in ("text", "fusion"):
        with pytest.raises(ValueError, match="omits"):
            tovmr.eval_logits(torch.tensor(feats), partial, 50.0, mode)
    with pytest.raises(ValueError, match="unknown"):
        tovmr.eval_logits_np(feats, cj, 50.0, "bogus")


# ---------------------------------------------------------------------------
# importers and goldens recorded from the reference torch modules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_golden():
    data = np.load(os.path.join(FIXTURES, "clip_tiny_golden.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    params, cfg = clip_params_from_state_dict(sd)
    return data, params, cfg


def test_clip_golden_config_and_towers(clip_golden):
    data, params, cfg = clip_golden
    assert (cfg.vision_layers, cfg.vision_width, cfg.vision_heads) == (2, 128, 2)
    assert (cfg.transformer_layers, cfg.transformer_heads, cfg.embed_dim) == (2, 2, 64)
    assert cfg.vocab_size == 512
    for bf in BLOCK_FNS.values():
        _close(tclip.encode_image(params, cfg, torch.tensor(data["images"]), block_fn=bf),
               data["img_feat"], 2e-5)
        _close(tclip.encode_text(params, cfg, torch.tensor(data["tokens"]), block_fn=bf),
               data["txt_feat"], 2e-5)
        emb = tclip.embed_tokens(params, torch.tensor(data["tokens"][:, :40]))
        _close(tclip.encode_text_embeds(params, cfg, emb, torch.tensor(data["eos40"]),
                                        block_fn=bf),
               data["txt_embeds_feat"], 2e-5)


def test_forward_prompt_golden():
    """Full classifier generation vs the reference forward_prompt recording."""
    data = np.load(os.path.join(FIXTURES, "forward_prompt_golden.npz"))
    clip_sd = {k[5:]: data[k] for k in data.files if k.startswith("clip.")}
    agg_sd = {k[4:]: data[k] for k in data.files if k.startswith("agg.")}
    params, cfg = clip_params_from_state_dict(clip_sd)
    agg = prompt_learner_params_from_state_dict(agg_sd, n_layers=4)
    from ovmr_tpu_torch.ops.layers import l2_normalize

    # the models' defaults: the kernel wrappers (their plain versions here)
    feats = l2_normalize(
        tclip.encode_image(params, cfg, torch.tensor(data["images"]))
    ).reshape(4, 4, -1)
    ptok, eot, vtok = tovmr.build_prompt_tokens(
        ["golden retriever", "tabby cat", "sports car", "red panda"]
    )
    t_cls = tovmr.text_classifier(params, cfg, torch.tensor(ptok))
    out = tovmr.generate_classifiers_from_feats(
        params, cfg, agg, feats, torch.tensor(ptok), torch.tensor(eot), torch.tensor(vtok),
        t_cls, eval_tau=10.0,
    )
    for key in ("text_classifier", "mm_classifier", "vision_classifier"):
        np.testing.assert_allclose(out[key].numpy(), data[key], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out["fusion_weight"].numpy(), data["fusion_weight"], atol=1e-3)


def test_load_clip_and_prompt_learner_files(tmp_path, clip_golden):
    data, params, cfg = clip_golden
    sd = {k[3:]: torch.tensor(data[k]) for k in data.files if k.startswith("sd.")}
    torch.save(sd, tmp_path / "clip.pt")
    torch.save({"state_dict": sd}, tmp_path / "clip_wrapped.pt")
    for name in ("clip.pt", "clip_wrapped.pt"):
        loaded, cfg2 = load_clip(str(tmp_path / name))
        assert cfg2 == cfg
        _close(loaded["visual"]["blocks"]["w_qkv"], params["visual"]["blocks"]["w_qkv"], 0)
    fp = np.load(os.path.join(FIXTURES, "forward_prompt_golden.npz"))
    agg_sd = {k[4:]: torch.tensor(fp[k]) for k in fp.files if k.startswith("agg.")}
    agg_sd["token_prefix"] = torch.zeros(3, 1, 8)
    torch.save({"state_dict": agg_sd, "epoch": 7}, tmp_path / "model.pth.tar-7")
    agg, epoch = load_prompt_learner(str(tmp_path / "model.pth.tar-7"))
    assert epoch == 7 and agg["blocks"]["w_qkv"].shape[0] == 4
    # right-multiply layout: w_qkv [D, 3D] is in_proj_weight transposed
    _close(agg["blocks"]["w_qkv"][0], agg_sd["aggregator.resblocks.0.attn.in_proj_weight"].T, 0)


def test_zoo_resolve_is_local(tmp_path, monkeypatch):
    monkeypatch.delenv("OVMR_CLIP_CKPT", raising=False)
    assert zoo.resolve("ViT-B/16", root=str(tmp_path)) is None
    (tmp_path / "ViT-B-16.pt").write_bytes(b"x")
    assert zoo.resolve("ViT-B/16", root=str(tmp_path)) == str(tmp_path / "ViT-B-16.pt")
    monkeypatch.setenv("OVMR_CLIP_CKPT", str(tmp_path / "ViT-B-16.pt"))
    assert zoo.resolve("unknown", root=str(tmp_path / "nowhere")) == str(tmp_path / "ViT-B-16.pt")


def test_convert_checks_structure(tiny):
    jp, _, ja, _ = tiny
    tree = _np_tree(jp)
    del tree["visual"]["blocks"]["w_qkv"]
    with pytest.raises(KeyError, match="w_qkv"):
        convert.clip_params_from_numpy(tree)
    agg = _np_tree(ja)
    agg["extra"] = np.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        convert.aggregator_params_from_numpy(agg)


def test_seeded_init_is_reproducible_and_scaled():
    a = tclip.init_params(tclip.TINY, seed=3)
    b = tclip.init_params(tclip.TINY, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a["visual"]["blocks"]["w_qkv"].numpy(),
                                  b["visual"]["blocks"]["w_qkv"].numpy())
    assert a["visual"]["blocks"]["w_qkv"].shape == (2, 64, 192)
    assert abs(float(a["visual"]["blocks"]["w_qkv"].std()) - 64 ** -0.5) < 0.01
    agg = init_aggregator(width=64, layers=2, n_ctx=3, seed=3)
    np.testing.assert_allclose(agg["cls_token"].norm(dim=-1).numpy(), 1.0, atol=1e-6)
    # the JAX twin's structure, key for key
    jagg = _np_tree(j_init_aggregator(jax.random.PRNGKey(0), width=64, layers=2, n_ctx=3))
    assert set(agg["blocks"]) == set(jagg["blocks"])
    for k, v in agg["blocks"].items():
        assert tuple(v.shape) == jagg["blocks"][k].shape, k
    np.testing.assert_allclose(np.asarray(j_l2_normalize(jagg["cls_token"])), jagg["cls_token"],
                               atol=1e-6)
