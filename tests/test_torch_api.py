"""The port's serving slice against the JAX package's, end to end on the CPU.

``ovmr_tpu_torch.api.OVMRGenerator(device="cpu", dtype=float32)`` and
``ovmr_tpu.api.OVMRGenerator`` (fp32, CPU) get the same weights (JAX
``init_params``/``init_aggregator``, carried over by ``convert``) and the
same numpy images. Classifiers agree within 1e-4, fusion weights within
1e-3, ``classify`` scores within 1e-4, on the single-program and the
chunked branch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.api import OVMRGenerator as JGen
from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.api import OVMRGenerator, load_exported_classifiers
from ovmr_tpu_torch.models import clip as tclip

TOL = {"mm_classifier": 1e-4, "vision_classifier": 1e-4, "text_classifier": 1e-4,
       "visual_tokens": 1e-4, "fusion_weight": 1e-3}
NAMES = ["red circle", "green square", "blue triangle", "café crème", "ski_mask"]


@pytest.fixture(scope="module")
def pair():
    key = jax.random.PRNGKey(0)
    cp = jax.tree_util.tree_map(np.asarray, jclip.init_params(key, jclip.TINY))
    ap = jax.tree_util.tree_map(
        np.asarray, j_init_aggregator(key, width=64, layers=2, n_ctx=2)
    )
    jg = JGen(cp, jclip.TINY, ap, dtype=jnp.float32)
    tg = OVMRGenerator(
        convert.clip_params_from_numpy(cp), tclip.TINY,
        convert.aggregator_params_from_numpy(ap), dtype=torch.float32, device="cpu",
    )
    return jg, tg


def _images(seed, *shape):
    """Per-class base pattern plus noise, so exemplars of a class agree."""
    rng = np.random.RandomState(seed)
    base = rng.rand(shape[0], 1, *shape[2:])
    return (base + 0.3 * rng.rand(*shape)).astype(np.float32)


def _compare(got, ref):
    assert set(got) == set(ref)
    for key, want in ref.items():
        assert got[key].dtype == np.float32 and got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key], want, atol=TOL[key], rtol=0, err_msg=key)


def test_generate_and_classify_match_jax(pair):
    jg, tg = pair
    exemplars = _images(0, 5, 4, 3, 32, 32)
    ref = jg.generate(NAMES, exemplars)
    got = tg.generate(NAMES, exemplars)
    _compare(got, ref)
    queries = np.random.RandomState(1).rand(6, 3, 32, 32).astype(np.float32)
    for mode in ("text", "vision", "multimodal", "fusion"):
        np.testing.assert_allclose(
            tg.classify(queries, got, mode=mode), jg.classify(queries, ref, mode=mode),
            atol=1e-4, rtol=0, err_msg=mode,
        )
    np.testing.assert_allclose(
        tg.encode_images(queries, batch_size=4), jg.encode_images(queries), atol=1e-5
    )


@pytest.mark.parametrize("chunk_size", [2, 3])
def test_chunked_branch_matches_jax_and_single_program(pair, chunk_size):
    jg, tg = pair
    feats = np.random.RandomState(2).rand(7, 4, 64).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    names = [f"thing {i}" for i in range(7)]
    ref = jg.generate_from_features(names, feats, chunk_size=chunk_size)
    got = tg.generate_from_features(names, feats, chunk_size=chunk_size)
    _compare(got, ref)
    single = tg.generate_from_features(names, feats)
    for key in TOL:
        np.testing.assert_allclose(got[key], single[key], atol=2e-5, err_msg=key)


def test_text_guard_omits_text_head(pair):
    _, tg = pair
    feats = np.random.RandomState(3).rand(3, 2, 64).astype(np.float32)
    with pytest.warns(UserWarning, match="Skipping frozen text classifier"):
        out = tg.generate_from_features(["a", "b", "c"], feats, max_text_classes=3)
    assert set(out) == {"mm_classifier", "vision_classifier", "visual_tokens"}
    queries = np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32)
    with pytest.raises(ValueError, match="omits"):
        tg.classify(queries, out, mode="fusion")
    assert tg.classify(queries, out, mode="vision").shape == (2, 3)


def test_export_round_trips(pair, tmp_path):
    _, tg = pair
    out = tg.generate(NAMES[:3], _images(5, 3, 2, 3, 32, 32))
    tg.export(out, str(tmp_path))
    loaded = load_exported_classifiers(str(tmp_path / "mm_classifiers.pt"))
    assert set(loaded) == {"text_classifier", "vision_classifier", "mm_classifier",
                           "fusion_weight"}
    for key, value in loaded.items():
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, out[key])
    vt = torch.load(str(tmp_path / "visual_tokens.pt"), weights_only=True)
    assert vt["visual_tokens"].dtype == torch.float32
    np.testing.assert_array_equal(vt["visual_tokens"].numpy(), out["visual_tokens"])
    with pytest.raises(KeyError, match="visual_tokens"):
        tg.export({k: v for k, v in out.items() if k != "visual_tokens"}, str(tmp_path / "x"))
    assert not (tmp_path / "x").exists()


def test_bf16_on_cpu_runs_and_stays_close(pair):
    jg, _ = pair
    key = jax.random.PRNGKey(0)
    cp = jax.tree_util.tree_map(np.asarray, jclip.init_params(key, jclip.TINY))
    ap = jax.tree_util.tree_map(np.asarray, j_init_aggregator(key, width=64, layers=2, n_ctx=2))
    tg16 = OVMRGenerator(convert.clip_params_from_numpy(cp), tclip.TINY,
                         convert.aggregator_params_from_numpy(ap), device="cpu")
    assert tg16.dtype == torch.bfloat16
    exemplars = _images(6, 3, 2, 3, 32, 32)
    ref = jg.generate(NAMES[:3], exemplars)
    got = tg16.generate(NAMES[:3], exemplars)
    for key in ("mm_classifier", "vision_classifier", "text_classifier"):
        cos = (got[key] * ref[key]).sum(-1)
        assert cos.min() > 0.99, key


def test_entry_points_need_cuda_unless_cpu_is_asked(pair, monkeypatch):
    """No card and no explicit device: both entry points raise, never fall
    back to the CPU."""
    _, tg = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OVMRGenerator(tg.clip_params, tclip.TINY, tg.agg_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OVMRGenerator.from_checkpoints("TINY")
    with pytest.raises(ValueError):
        OVMRGenerator(tg.clip_params, tclip.TINY, tg.agg_params, device="meta")


def test_from_checkpoints_random_smoke_mode(tmp_path, monkeypatch):
    monkeypatch.delenv("OVMR_CLIP_CKPT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.warns(UserWarning, match="RANDOM"):
        gen = OVMRGenerator.from_checkpoints("TINY", device="cpu", dtype=torch.float32, seed=1)
    assert gen.clip_cfg == tclip.TINY and gen.device.type == "cpu"
    assert gen.agg_params["cls_token"].shape == (2, 64)
    out = gen.generate(["a", "b"], _images(7, 2, 2, 3, 32, 32))
    assert out["fusion_weight"].shape == (2, 3)
    with pytest.raises(NotImplementedError):
        OVMRGenerator.from_checkpoints("RN50", device="cpu")
