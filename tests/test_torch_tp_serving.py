"""The port's tensor-parallel serving seams against the JAX package's.

At ``TINY_TP`` (vision 2 x 128 with 2 heads, text 2 x 64 with 2 heads) on a
model axis of 2 local shards:

- ``engine.trainer.make_feature_extractor`` with the TP block from
  ``tp_seam_tools``, float and uint8 batches, a ragged batch padded, against
  JAX's extractor on a (1, 2) mesh with its own ``tp_seam_tools``;
- ``mm_generate_classifiers`` with the TP block against the port's
  single-device generation (2e-5, as ``tests/test_tp_trainer.py`` holds
  JAX's TP generation) and against JAX ``classifier_heads`` run through
  ``shard_map`` with ``make_tp_block``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ovmr_tpu.engine import trainer as jtrainer
from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models import ovmr as jovmr
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu.ops.block_fused_tp import split_clip_qkv as j_split_clip_qkv
from ovmr_tpu.ops.layers import attention_xla
from ovmr_tpu.parallel import build_mesh, place_tower_params as j_place
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.api import OVMRGenerator
from ovmr_tpu_torch.engine import trainer as ttrainer
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models.ovmr import build_prompt_tokens
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.parallel import ModelAxis

MEAN, STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
NAMES = ["red circle", "green square", "café crème"]
KEYS = ("mm_classifier", "vision_classifier", "text_classifier", "visual_tokens", "fusion_weight")


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
def models():
    """JAX TINY_TP towers and aggregator, as numpy, and the JAX TP seams on
    a (1, 2) mesh; the port's TP seams on 2 local shards."""
    key = jax.random.PRNGKey(3)
    cp = _np_tree(jclip.init_params(key, jclip.TINY_TP))
    ap = _np_tree(j_init_aggregator(key, width=64, layers=2, n_ctx=2))
    mesh = build_mesh(data=1, model=2)
    j_tp_params = j_place(mesh, j_split_clip_qkv(cp, 2, jclip.TINY_TP))
    j_block, j_specs = jtrainer.tp_seam_tools(mesh, "pallas", j_tp_params)
    t_cp = convert.clip_params_from_numpy(cp)
    t_block, t_tp_params = ttrainer.tp_seam_tools(ModelAxis.local(2), t_cp, tclip.TINY_TP)
    return dict(cp=cp, ap=ap, mesh=mesh, j_tp_params=j_tp_params, j_block=j_block,
                j_specs=j_specs, t_cp=t_cp, t_block=t_block, t_tp_params=t_tp_params,
                t_ap=convert.aggregator_params_from_numpy(ap))


@pytest.mark.parametrize("kind", ["float", "uint8", "uint8-no-normalize"])
@pytest.mark.parametrize("n", [8, 5])  # 5: a ragged batch, padded to 8
def test_tp_feature_extractor_matches_jax(models, kind, n):
    rng = np.random.RandomState(n)
    if kind == "float":
        images = rng.randn(n, 3, 32, 32).astype(np.float32)
    else:
        images = rng.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
    u8_norm = kind != "uint8-no-normalize"
    j_enc = jtrainer.make_feature_extractor(
        jclip.TINY_TP, attention_xla, jnp.float32, MEAN, STD, batch_size=8,
        mesh=models["mesh"], u8_normalize=u8_norm, tp_block_fn=models["j_block"],
        clip_specs=models["j_specs"],
    )
    t_enc = ttrainer.make_feature_extractor(
        tclip.TINY_TP, torch.float32, MEAN, STD, batch_size=8, device="cpu",
        u8_normalize=u8_norm, tp_block_fn=models["t_block"],
    )
    ref = j_enc(models["j_tp_params"], images)
    got = t_enc(models["t_tp_params"], images)
    assert got.shape == ref.shape == (n, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    # the same encode on the packed towers without a model axis
    single = ttrainer.make_feature_extractor(
        tclip.TINY_TP, torch.float32, MEAN, STD, batch_size=8, device="cpu",
        u8_normalize=u8_norm,
    )(models["t_cp"], images)
    np.testing.assert_allclose(got, single, atol=2e-5, rtol=0)


def test_tp_seam_tools_without_a_model_axis(models):
    for axis in (None, ModelAxis.local(1)):
        block, params = ttrainer.tp_seam_tools(axis, models["t_cp"], tclip.TINY_TP)
        assert block is None and params is models["t_cp"]


def _feats(n=3, k=4, d=64, seed=0):
    f = np.random.RandomState(seed).randn(n, k, d).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def generated(models):
    ptok, eot, vtok = build_prompt_tokens(NAMES)
    feats = _feats()
    cuda_lib.reset_launches()
    tp = ttrainer.mm_generate_classifiers(
        models["t_tp_params"], tclip.TINY_TP, models["t_ap"], feats, ptok, eot, vtok,
        eval_tau=10.0, block_fn=models["t_block"],
    )
    assert not any(cuda_lib.LAUNCHES.values())
    single = ttrainer.mm_generate_classifiers(
        models["t_cp"], tclip.TINY_TP, models["t_ap"], feats, ptok, eot, vtok, eval_tau=10.0,
    )
    return feats, (ptok, eot, vtok), tp, single


def test_tp_generation_matches_single_device(models, generated):
    feats, (ptok, eot, vtok), tp, single = generated
    assert set(tp) == set(KEYS)
    for key in KEYS:
        assert tp[key].dtype == np.float32 and tp[key].shape[0] == len(NAMES)
        np.testing.assert_allclose(tp[key], single[key], atol=2e-5, rtol=0, err_msg=key)
    # and the generator's own single-device path
    gen = OVMRGenerator(models["t_cp"], tclip.TINY_TP, models["t_ap"],
                        dtype=torch.float32, device="cpu")
    ref = gen.generate_from_features(NAMES, feats, eval_tau=10.0)
    for key in KEYS:
        np.testing.assert_allclose(tp[key], ref[key], atol=2e-5, rtol=0, err_msg=key)


def test_tp_generation_matches_jax_heads_under_shard_map(models, generated):
    """mm/vision classifiers and visual tokens against JAX
    ``classifier_heads`` through ``shard_map`` with the JAX TP block; the
    text classifier against JAX ``text_classifier`` the same way."""
    feats, (ptok, eot, vtok), tp, _ = generated
    n = len(NAMES)
    cp = models["j_tp_params"]
    block = models["j_block"]
    specs = models["j_specs"]
    jf = jnp.asarray(feats)
    pe = jclip.embed_tokens(cp, jnp.asarray(ptok)).astype(jf.dtype)
    ve = jnp.broadcast_to(jclip.embed_tokens(cp, jnp.asarray(vtok)[None]), (n, 77, 64))

    def heads(cp_, ap_, f, pe_, ve_, et):
        return jovmr.classifier_heads(cp_, jclip.TINY_TP, ap_, f, pe_, ve_, et,
                                      attn_fn=attention_xla, block_fn=block)

    mm, v, vt = jax.jit(shard_map(
        heads, mesh=models["mesh"], in_specs=(specs, P(), P(), P(), P(), P()),
        out_specs=P(), check_vma=False,
    ))(cp, models["ap"], jf, pe, ve, jnp.asarray(eot))
    text = jax.jit(shard_map(
        lambda cp_, tok: jovmr.text_classifier(cp_, jclip.TINY_TP, tok, block_fn=block),
        mesh=models["mesh"], in_specs=(specs, P()), out_specs=P(), check_vma=False,
    ))(cp, jnp.asarray(ptok))
    for key, ref in (("mm_classifier", mm), ("vision_classifier", v), ("visual_tokens", vt),
                     ("text_classifier", text)):
        np.testing.assert_allclose(tp[key], np.asarray(ref), atol=2e-5, rtol=0, err_msg=key)


def test_generation_skips_the_text_head_at_the_guard(models, tmp_path):
    ptok, eot, vtok = build_prompt_tokens(NAMES)
    with pytest.warns(UserWarning, match="Skipping frozen text classifier"):
        out = ttrainer.mm_generate_classifiers(
            models["t_tp_params"], tclip.TINY_TP, models["t_ap"], _feats(), ptok, eot, vtok,
            eval_tau=10.0, block_fn=models["t_block"], text_cls_max_classes=3,
            class_chunk=2, output_dir=str(tmp_path),
        )
    assert set(out) == {"mm_classifier", "vision_classifier", "visual_tokens"}
    assert out["mm_classifier"].shape == (3, 64)
    assert (tmp_path / "mm_classifiers.pt").is_file() and (tmp_path / "visual_tokens.pt").is_file()


@pytest.mark.parametrize("class_chunk", [2, 2048])
@pytest.mark.parametrize("pad_multiple", [1, 4, 8])
def test_padded_classes_change_no_real_class(models, generated, class_chunk, pad_multiple):
    """The classes added to fill a chunk or a pad multiple are cut away
    again: with the TP block, every chunking and padding of the 3 classes
    gives the unpadded, unchunked artifact (to fp32 rounding of the fusion's
    logits)."""
    feats, (ptok, eot, vtok), tp, _ = generated
    got = ttrainer.mm_generate_classifiers(
        models["t_tp_params"], tclip.TINY_TP, models["t_ap"], feats, ptok, eot, vtok,
        eval_tau=10.0, block_fn=models["t_block"], class_chunk=class_chunk,
        class_pad_multiple=pad_multiple,
    )
    for key in KEYS:
        np.testing.assert_allclose(got[key], tp[key], atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_generator_and_extractor_encode_alike(models, kind):
    """``OVMRGenerator.encode_images`` and the single-device extractor run
    one encode (``encode_features``): equal features for the same batch."""
    rng = np.random.RandomState(7)
    if kind == "float":
        images = rng.randn(5, 3, 32, 32).astype(np.float32)
    else:
        images = rng.randint(0, 256, size=(5, 32, 32, 3)).astype(np.uint8)
    gen = OVMRGenerator(models["t_cp"], tclip.TINY_TP, models["t_ap"],
                        dtype=torch.float32, device="cpu")
    enc = ttrainer.make_feature_extractor(tclip.TINY_TP, torch.float32, MEAN, STD,
                                          batch_size=5, device="cpu")
    np.testing.assert_array_equal(gen.encode_images(images, batch_size=5),
                                  enc(models["t_cp"], images))
